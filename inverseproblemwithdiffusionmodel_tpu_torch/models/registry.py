"""Model registry, construction and the score-function adapter.

Port of `create_model`, `get_network`, `build_seg_unet`,
`build_clf`, `TASK_NAME_TO_MODEL_CTOR`, `load_model`, `make_score_fn`,
`make_apply_fn`, `module_takes_train` and `get_model_fn` from
inverseproblemwithdiffusionmodel_tpu/models/registry.py: the whole
registry. Registered: NCSN++, DDPM, NCSN v1 (`ncsn`, `ncsn_deeper`), the
NCSNv2 family (with the size-suffixed aliases), its 1-D
members (the cine temporal prior, task "Diffusion1D") and UNET1D, the 3-D
nets (NCSN3D, and NCSN3DShallow for task "Diffusion3D"), the seg UNet and
the ResNet-18 classifier (task "Clf"); `make_seg_fn` and `make_clf_fn` are
the guidance nets' counterparts of `make_score_fn`,
`make_tube_score_fn_3d` its form for a 3-D net on pixel tubes, and
`continuous_model_fn` the network as the continuous stack's score function
calls it.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple, Union

import torch

from ..config import load_general_config
from ..samplers.sigmas import sigma_ladder
from .classifier import ResNetClf
from .ddpm import DDPM
from .ncsn1d import NCSN1D, NCSN1DDeeper, NCSN1DDeepest, UNET1D
from .ncsn3d import NCSN3D, NCSN3DShallow, tube_window
from .ncsn import NCSN, NCSNdeeper, _NCSNFamily
from .ncsnpp import NCSNpp
from .ncsnv2 import NCSNv2, NCSNv2Deeper, NCSNv2Deepest, _NCSNv2Family
from .unet import UNet

_MODELS = {
    "ncsnpp": NCSNpp, "ddpm": DDPM, "ncsn": NCSN, "ncsn_deeper": NCSNdeeper,
    "ncsnv2": NCSNv2, "ncsnv2_deeper": NCSNv2Deeper,
    "ncsnv2_deepest": NCSNv2Deepest,
    "ncsn1d": NCSN1D, "ncsn1d_deeper": NCSN1DDeeper,
    "ncsn1d_deepest": NCSN1DDeepest, "unet1d": UNET1D,
    "ncsn3d": NCSN3D, "ncsn3d_shallow": NCSN3DShallow,
    # size-suffixed aliases (reference: models/ncsnv2.py registers
    # ncsnv2_64/128/256 for the <96 / <=128 / <=256 px variants)
    "ncsnv2_64": NCSNv2, "ncsnv2_128": NCSNv2Deeper,
    "ncsnv2_256": NCSNv2Deepest,
}


def get_model(name: str):
    if name not in _MODELS:
        raise NotImplementedError(
            f"unknown model {name!r}; registered: {sorted(_MODELS)}")
    return _MODELS[name]


def create_model(config):
    """Instantiate the registered model named by `config.model.name`, on the
    CPU; move it with `.to(device)`."""
    return get_model(config.model.name)(config)


def get_network(config):
    """NCSNv2 by image size (reference: models/ncsnv2.py:31-40): < 96 px
    NCSNv2, <= 128 NCSNv2Deeper, <= 256 NCSNv2Deepest."""
    size = config.data.image_size
    if size < 96:
        return NCSNv2(config)
    if size <= 128:
        return NCSNv2Deeper(config)
    if size <= 256:
        return NCSNv2Deepest(config)
    raise NotImplementedError(f"no NCSNv2 variant for image size {size}")


def build_seg_unet(general_config=None) -> UNet:
    """The segmentation UNet of general_config's `Seg` section, at its
    `spatial_dims`."""
    seg = (general_config or load_general_config()).Seg
    return UNet(out_channels=seg.out_channels, features=tuple(seg.channels),
                strides=tuple(seg.strides), in_channels=seg.in_channels,
                ndim=seg.spatial_dims)


def build_clf(general_config=None, in_channels: Optional[int] = None
              ) -> ResNetClf:
    """The ResNet-18 classifier of general_config's `Clf` section (its
    num_cls head); `in_channels` defaults to Clf.in_channels."""
    return ResNetClf(general_config or load_general_config(),
                     in_channels=in_channels)


TASK_NAME_TO_MODEL_CTOR = {
    "Diffusion": lambda config: NCSNv2Deepest(config),
    "Diffusion1D": NCSN1D,
    "Diffusion3D": NCSN3DShallow,
    # the JAX package initializes the classifier on the dataset's channels
    "Clf": lambda config: build_clf(
        in_channels=None if config is None else config.data.channels),
    "Seg": lambda config: build_seg_unet(),
}


def example_input(config, task_name: str) -> torch.Tensor:
    """A zero batch of one, channel-last, at the shape the JAX package
    initializes a task's model with (its `_example_input`): (1, s, s, C)
    images, (1, T, C) tubes of the 1-D prior, (1, win, win, T, C3) volumes
    of the 3-D prior."""
    data = config.data
    if task_name == "Diffusion1D":
        return torch.zeros(1, data.image_size, data.channels)
    if task_name == "Diffusion3D":
        win = tube_window(config)
        return torch.zeros(1, win, win, data.image_size,
                           data.get("channels_3d", 1))
    if task_name in ("Diffusion", "Seg", "Clf"):
        s = data.image_size
        return torch.zeros(1, s, s, data.channels)
    raise NotImplementedError(f"no ported model for task {task_name!r}")


def load_model(config, task_name: str, seed: int = 0
               ) -> Tuple[torch.nn.Module, None]:
    """Construct the model of a task, on the CPU, with weights drawn from
    `seed` by utils/convert.seeded_weights. Returns (module, None): the JAX
    form returns (module, params); here the module holds its weights."""
    if task_name not in TASK_NAME_TO_MODEL_CTOR:
        raise ValueError(f"unknown task {task_name!r}; one of "
                         f"{sorted(TASK_NAME_TO_MODEL_CTOR)}")
    from ..utils.convert import seeded_weights     # convert imports us
    module = TASK_NAME_TO_MODEL_CTOR[task_name](config)
    return seeded_weights(module, seed), None


def make_seg_fn(model: torch.nn.Module
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Adapter `x -> logits` for the seg UNet on channel-last tensors, as
    the guidance gradient calls it (samplers/ald.compute_seg_grad): x (B,
    H, W, C) in, logits (B, H, W, K) out, the net on contiguous NCHW in
    between. Runs in the model's dtype and on its device."""

    def seg_fn(x: torch.Tensor) -> torch.Tensor:
        return model(to_nchw(x)).movedim(1, -1)

    return seg_fn


def make_clf_fn(model: torch.nn.Module
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Adapter `x -> logits` for the classifier on channel-last tensors, as
    the guidance gradient calls it (samplers/ald.compute_clf_grad): x (B,
    H, W, C) in, logits (B, num_cls) out, the net on contiguous NCHW in
    between. Runs in the model's dtype and on its device."""

    def clf_fn(x: torch.Tensor) -> torch.Tensor:
        return model(to_nchw(x))

    return clf_fn


def make_score_fn(model: torch.nn.Module, sigmas: torch.Tensor,
                  compute_dtype: Union[torch.dtype, str, None] = None
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Adapter `(x, labels) -> model(x, sigmas[labels])`, the interface of
    the ALD samplers, for the NCSNv2 family. x is channel-last (B, H, W, C)
    as in the JAX package; the net runs on contiguous NCHW (`to_nchw`, no
    copy for C = 1) and the score comes back channel-last. The 1-D nets
    take channel-last tubes (B', T, C) the same way: for the C = win^2
    channels of a tube the move to (B', C, T) is a copy. The 3-D nets
    take channel-last volumes (B, kx, ky, T, C3) as NCDHW, and tubes as
    the 1-D nets do. `sigmas` moves to the model's device.

    compute_dtype=torch.bfloat16 runs the net on a bf16 copy of the weights
    with a bf16 input and sigmas, and casts the score back to float32; the
    Langevin state stays float32. compute_dtype="int8", the serving mode,
    is that bf16 copy with every layers.Conv on the int8 path
    (ops/quant.py): the bf16-cast weights quantized once, here, per output
    channel; each activation quantized per tensor over the whole batch.
    The switch is made on the copy only, so other nets that share the
    layers (the seg UNet of a guided engine) stay as they are. Inference
    only: the int8 path carries no gradient.
    """
    device = next(model.parameters()).device
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=device)
    net = model
    if compute_dtype == "int8":
        from ..ops.quant import enable_int8
        compute_dtype = torch.bfloat16
        net = enable_int8(copy.deepcopy(model).to(compute_dtype))
        sigmas = sigmas.to(compute_dtype)
    elif compute_dtype is not None:
        net = copy.deepcopy(model).to(compute_dtype)
        sigmas = sigmas.to(compute_dtype)

    def score_fn(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        h = to_nchw(x)
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        out = net(h, sigmas[labels]).movedim(1, -1)
        return out.float()

    return score_fn


def make_tube_score_fn_3d(model: torch.nn.Module, sigmas, win: int
                          ) -> Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor]:
    """The score adapter of a 3-D net (NCSN3D, NCSN3DShallow) on the
    2D+time sampler's pixel tubes (B', T, win^2): `make_score_fn`, which
    hands the net the (B', win^2, T) tubes it views as volumes, after a
    window check. The net takes its window from config.data.channels; a
    sampler's `win` that disagrees would tile the tubes wrongly, so it
    raises ValueError."""
    channels = int(model.config.data.channels)
    if win * win != channels:
        raise ValueError(
            f"win_size {win} (k^2 = {win * win}) does not match the 3-D "
            f"net's config.data.channels = {channels}")
    return make_score_fn(model, sigmas)


def make_apply_fn(model: torch.nn.Module
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Plain forward `x -> model(x)` (the clf / seg nets), in the model's
    own layout; `make_clf_fn` / `make_seg_fn` adapt channel-last x."""

    def apply_fn(x: torch.Tensor) -> torch.Tensor:
        return model(x)

    return apply_fn


def module_takes_train(model: torch.nn.Module) -> bool:
    """Whether the net's output depends on train / eval mode: it holds a
    dropout layer (NCSN++, DDPM), as the JAX nets whose __call__ takes a
    `train` flag. The NCSN families and ScoreNet have none."""
    return any(isinstance(m, torch.nn.Dropout) for m in model.modules())


def get_model_fn(model: torch.nn.Module, train: bool = False
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Raw forward `(x, cond) -> model(x, cond)` with the model in train
    mode (`train`) or eval mode (reference: models/utils.py:97). In train
    mode the dropout of NCSN++ and DDPM draws from torch's generator at
    every call (the JAX form draws one mask from its dropout_key); nets
    without dropout give the same output in both modes."""

    def model_fn(x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        model.train(train)
        return model(x, cond)

    return model_fn


def takes_nchw(model: torch.nn.Module) -> bool:
    """Whether the net takes NCHW x: the NCSN v1 and NCSNv2 families
    (NCSN++, DDPM and ScoreNet take channel-last x)."""
    return isinstance(model, (_NCSNv2Family, _NCSNFamily))


def continuous_model_fn(model: torch.nn.Module, config
                        ) -> Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]:
    """The network as the continuous stack's score function calls it,
    `(x, cond) -> output` on channel-last x. NCSN++ and DDPM take that
    as they are. An NCSN v1 net (the ve/ncsn/* leaves, discrete VE, cond
    the descending-ladder index) takes NCHW x and the integer index, as in
    the JAX package. An NCSNv2-family net (the ve/ncsnv2/* leaves) takes
    NCHW x and sigma values:
    it runs through make_score_fn on the config's geometric ladder
    sigma_max -> sigma_min of num_scales, so it sees sigmas[cond]. (The
    JAX package hands such a net the integer index itself, which the net
    divides its output by: index 0, at t = T, makes every sample NaN.)"""
    if isinstance(model, _NCSNFamily):
        return lambda x, cond: model(to_nchw(x), cond.long()).movedim(1, -1)
    if not isinstance(model, _NCSNv2Family):
        return model
    m = config.model
    score = make_score_fn(model, sigma_ladder(m.sigma_max, m.sigma_min,
                                              m.num_scales, "geometric"))
    return lambda x, cond: score(x, cond.long())


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> contiguous (B, C, H, W), (B, T, C) -> (B, C, T), or
    (B, kx, ky, T, C) -> (B, C, kx, ky, T).
    For C = 1 this is a view of the same memory. The bare permute would
    not do: for C = 1 its strides are channels-last strides, and torch
    then runs every convolution of the net in NHWC against NCHW weights,
    converting them at every call."""
    if x.shape[-1] == 1:
        return x.reshape((x.shape[0], 1) + x.shape[1:-1])
    return x.movedim(-1, 1).contiguous()

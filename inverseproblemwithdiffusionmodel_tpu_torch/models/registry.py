"""Model registry, construction and the score-function adapter.

Port of `create_model`, `get_network`, `build_seg_unet`,
`TASK_NAME_TO_MODEL_CTOR`, `load_model` and `make_score_fn` from
inverseproblemwithdiffusionmodel_tpu/models/registry.py. Ported: NCSN++,
the NCSNv2 family (with the size-suffixed aliases), its 1-D members (the
cine temporal prior, task "Diffusion1D") and the seg UNet; `make_seg_fn`
is the seg UNet's counterpart of `make_score_fn`.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import torch

from ..config import load_general_config
from .ncsn1d import NCSN1D, NCSN1DDeeper, NCSN1DDeepest, UNET1D
from .ncsnpp import NCSNpp
from .ncsnv2 import NCSNv2, NCSNv2Deeper, NCSNv2Deepest
from .unet import UNet

_MODELS = {
    "ncsnpp": NCSNpp,
    "ncsnv2": NCSNv2, "ncsnv2_deeper": NCSNv2Deeper,
    "ncsnv2_deepest": NCSNv2Deepest,
    "ncsn1d": NCSN1D, "ncsn1d_deeper": NCSN1DDeeper,
    "ncsn1d_deepest": NCSN1DDeepest, "unet1d": UNET1D,
    # size-suffixed aliases (reference: models/ncsnv2.py registers
    # ncsnv2_64/128/256 for the <96 / <=128 / <=256 px variants)
    "ncsnv2_64": NCSNv2, "ncsnv2_128": NCSNv2Deeper,
    "ncsnv2_256": NCSNv2Deepest,
}


def get_model(name: str):
    if name not in _MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; ported: {sorted(_MODELS)}")
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
    """The segmentation UNet of general_config's `Seg` section (2-D)."""
    seg = (general_config or load_general_config()).Seg
    if seg.spatial_dims != 2:
        raise NotImplementedError(f"a {seg.spatial_dims}-D UNet is not "
                                  "ported (2-D only)")
    return UNet(out_channels=seg.out_channels, features=tuple(seg.channels),
                strides=tuple(seg.strides), in_channels=seg.in_channels)


def _not_ported(task: str, slice_: str):
    def ctor(config):
        raise NotImplementedError(f"task {task!r} is not ported yet "
                                  f"(ROADMAP: {slice_})")
    return ctor


TASK_NAME_TO_MODEL_CTOR = {
    "Diffusion": lambda config: NCSNv2Deepest(config),
    "Diffusion1D": NCSN1D,
    "Diffusion3D": _not_ported("Diffusion3D", "Slice C"),
    "Clf": _not_ported("Clf", "Slice B"),
    "Seg": lambda config: build_seg_unet(),
}


def example_input(config, task_name: str) -> torch.Tensor:
    """A zero batch of one, channel-last, at the shape the JAX package
    initializes a task's model with (its `_example_input`): (1, s, s, C)
    images, (1, T, C) tubes of the 1-D prior."""
    data = config.data
    if task_name == "Diffusion1D":
        return torch.zeros(1, data.image_size, data.channels)
    if task_name in ("Diffusion", "Seg"):
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
        return model(_to_nchw(x)).movedim(1, -1)

    return seg_fn


def make_score_fn(model: torch.nn.Module, sigmas: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Adapter `(x, labels) -> model(x, sigmas[labels])`, the interface of
    the ALD samplers, for the NCSNv2 family. x is channel-last (B, H, W, C)
    as in the JAX package; the net runs on contiguous NCHW (`_to_nchw`, no
    copy for C = 1) and the score comes back channel-last. The 1-D nets
    take channel-last tubes (B', T, C) the same way: for the C = win^2
    channels of a tube the move to (B', C, T) is a copy. `sigmas` moves
    to the model's device.

    compute_dtype=torch.bfloat16 runs the net on a bf16 copy of the weights
    with a bf16 input and sigmas, and casts the score back to float32; the
    Langevin state stays float32. "int8" (the JAX package's int8 conv
    mode) is not ported yet.
    """
    if compute_dtype == "int8":
        raise NotImplementedError("int8 convolutions are not ported yet "
                                  "(ROADMAP: Slice H)")
    device = next(model.parameters()).device
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=device)
    net = model
    if compute_dtype is not None:
        net = copy.deepcopy(model).to(compute_dtype)
        sigmas = sigmas.to(compute_dtype)

    def score_fn(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        h = _to_nchw(x)
        if compute_dtype is not None:
            h = h.to(compute_dtype)
        out = net(h, sigmas[labels]).movedim(1, -1)
        return out.float()

    return score_fn


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> contiguous (B, C, H, W), or (B, T, C) -> (B, C, T).
    For C = 1 this is a view of the same memory. The bare permute would
    not do: for C = 1 its strides are channels-last strides, and torch
    then runs every convolution of the net in NHWC against NCHW weights,
    converting them at every call."""
    if x.shape[-1] == 1:
        return x.reshape((x.shape[0], 1) + x.shape[1:-1])
    return x.movedim(-1, 1).contiguous()

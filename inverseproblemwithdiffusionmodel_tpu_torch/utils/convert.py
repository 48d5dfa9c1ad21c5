"""Weights for the port's NCSN++, NCSN v1, NCSNv2 family, 3-D nets,
UNET1D, seg UNet, classifier and ScoreNet: converted from a Flax parameter
tree, or drawn from a seed.

`flax_to_torch_ncsnpp` (NCSN++ and DDPM++), `flax_to_torch_ddpm`,
`flax_to_torch_ncsn`, `flax_to_torch_ncsnv2`, `flax_to_torch_ncsn3d`,
`flax_to_torch_unet1d`, `flax_to_torch_unet`, `flax_to_torch_clf` and
`flax_to_torch_scorenet` map the JAX package's
parameters onto the port's state dict, name by name (the port keeps the
Flax module names):

- conv kernels (*k, I, O) -> weight (O, I, *k), no flip, at every rank:
  (kh, kw, I, O) -> (O, I, kh, kw), the 1-D nets' (k, I, O) -> (O, I,
  k), the 3-D nets' (kx, ky, kt, I, O) -> (O, I, kx, ky, kt) (the
  temporal down convolution's (1, 1, 4, I, O) among them);
- transposed-conv kernels (*k, I, O) -> weight (I, O, *k), no flip: the
  JAX layer flips the kernel itself, as torch's conv_transpose does;
  Flax's own nn.ConvTranspose (ScoreNet) does not, so its kernel is
  flipped as well;
- Dense kernels (in, out) -> Linear weight (out, in);
- GroupNorm scale / bias -> weight / bias;
- NIN W / b, the Fourier W, the fused resamplers' Conv2d_0_weight
  (kh, kw, I, O) / Conv2d_0_bias, the InstanceNorm++ alpha / gamma /
  beta, the conditional norms' gamma_embed / alpha_embed / beta_embed
  (num_classes, C), BatchNorm's batch_stats mean / var and the PReLU
  alpha (a scalar) keep name and layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models import (layers, layerspp, ncsn3d, normalization, simple,
                      unet)
from ..models.registry import (build_clf, build_seg_unet, create_model,
                               get_model, get_network)

_TRANSPOSED = (layers.ConvTranspose, simple.FlaxConvTranspose)


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def _convert_leaf(path: str, value: np.ndarray, transposed=frozenset()):
    module, dot, leaf = path.rpartition(".")
    weight = f"{module}{dot}weight"
    if leaf == "kernel" and value.ndim >= 3:
        n = value.ndim
        spatial = tuple(range(n - 2))
        if module in transposed:
            return weight, value.transpose((n - 2, n - 1) + spatial)
        return weight, value.transpose((n - 1, n - 2) + spatial)
    if leaf == "kernel" and value.ndim == 2:
        return weight, value.T
    if leaf == "scale":
        return weight, value
    return path, value


def flax_to_torch(params: Mapping[str, Any], transposed=frozenset()
                  ) -> Dict[str, torch.Tensor]:
    """State dict of the port's layers from a Flax params tree of arrays;
    `transposed` names the transposed-convolution modules."""
    state = {}
    for path, value in _flatten(params):
        name, value = _convert_leaf(path, value, transposed)
        state[name] = torch.tensor(value, dtype=torch.float32)
    return state


def _checked(params: Mapping[str, Any], build, what: str
             ) -> Dict[str, torch.Tensor]:
    """flax_to_torch(params), held name by name and shape by shape to the
    state dict of the model `build()` makes; raises on any difference."""
    with torch.device("meta"):
        model = build()
    expected = model.state_dict()
    transposed = {name for name, module in model.named_modules()
                  if isinstance(module, _TRANSPOSED)}
    state = flax_to_torch(params, transposed)
    for name, value in state.items():
        if name not in expected:
            raise KeyError(f"no parameter {name!r} in the port's {what}")
        if value.shape != expected[name].shape:
            raise ValueError(f"{name}: converted shape {tuple(value.shape)}, "
                             f"the port expects {tuple(expected[name].shape)}")
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"parameters missing from the Flax tree: {missing}")
    return state


def flax_to_torch_model(params: Mapping[str, Any], build, what: str = "model"
                        ) -> Dict[str, torch.Tensor]:
    """State dict for the model `build()` makes (built on the meta device,
    so building costs nothing) from the JAX package's params tree of numpy
    arrays, or from any tree shaped like it (an Adam moment), with the
    layouts above. Raises if a name or shape does not match."""
    return _checked(params, build, what)


def flax_to_torch_ncsnpp(params: Mapping[str, Any], config
                         ) -> Dict[str, torch.Tensor]:
    """State dict for `create_model(config)` from a Flax NCSN++ params tree
    of numpy arrays (the tree under "params"). Raises if a name or shape
    does not match the port's model."""
    return _checked(params, lambda: create_model(config), config.model.name)


def flax_to_torch_ddpm(params: Mapping[str, Any], config
                       ) -> Dict[str, torch.Tensor]:
    """State dict for the port's DDPM (`create_model(config)`, model name
    "ddpm") from a Flax DDPM params tree of numpy arrays. Raises if a name
    or shape does not match."""
    if config.model.name != "ddpm":
        raise ValueError(f"flax_to_torch_ddpm: the config names "
                         f"{config.model.name!r}, not 'ddpm'")
    return _checked(params, lambda: create_model(config), "ddpm")


def _merged(params: Mapping[str, Any], extra: Optional[Mapping[str, Any]]
            ) -> Dict[str, Any]:
    """The params tree with a second tree (batch_stats) merged in."""
    out = dict(params)
    for key, value in (extra or {}).items():
        out[key] = (_merged(out[key], value) if isinstance(value, Mapping)
                    and key in out else value)
    return out


def flax_to_torch_ncsn(params: Mapping[str, Any], config,
                       name: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """State dict for an NCSN v1 net (the registry's `name`, "ncsn" or
    "ncsn_deeper", else `config.model.name`) from the JAX package's params
    tree of numpy arrays, with every conditional norm's embeddings. (No
    NCSN v1 net holds a BatchNorm: it has no conditional form; the
    NCSNv2 family's converter takes batch_stats.) Raises if a name or
    shape does not match."""
    name = name or config.model.name
    if name not in ("ncsn", "ncsn_deeper"):
        raise ValueError(f"flax_to_torch_ncsn: {name!r} is not an NCSN v1 "
                         "net")
    return _checked(params, lambda: get_model(name)(config), name)


def flax_to_torch_scorenet(params: Mapping[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """State dict for ScoreNet from the JAX package's params tree of numpy
    arrays; the widths, embedding size and channels come from the tree.
    Flax's nn.ConvTranspose correlates with its kernel unflipped, torch's
    conv_transpose with the kernel flipped, so the tconv kernels are
    flipped. Raises if a name or shape does not match."""
    channels = tuple(int(np.shape(params[f"conv{i}"]["kernel"])[-1])
                     for i in range(1, 5))
    embed_dim = int(np.shape(params["embed_dense"]["kernel"])[0])
    in_channels = int(np.shape(params["conv1"]["kernel"])[2])
    state = _checked(params, lambda: simple.ScoreNet(
        lambda t: t, channels, embed_dim, in_channels), "ScoreNet")
    for i in range(1, 5):
        key = f"tconv{i}.weight"
        state[key] = state[key].flip(-2, -1).contiguous()
    return state


def flax_to_torch_ncsnv2(params: Mapping[str, Any], config,
                         name: Optional[str] = None,
                         batch_stats: Optional[Mapping[str, Any]] = None
                         ) -> Dict[str, torch.Tensor]:
    """State dict for an NCSNv2-family model from the JAX package's params
    tree of numpy arrays (the tree under "params"). The model is the
    registry's `name` (e.g. "ncsnv2_deepest", or "ncsn1d" for the 1-D
    temporal prior), else `config.model.name`
    where the config has one, else the size dispatch of `get_network`
    (NCSNv2Deepest at 256 px, the ACDC prior). A BatchNorm config takes
    the `batch_stats` tree too: its running mean and var become the
    buffers of those names. Raises if a name or shape does not match."""
    name = name or config.model.get("name")
    params = _merged(params, batch_stats)
    if name is None:
        return _checked(params, lambda: get_network(config),
                        "NCSNv2 family (by image size)")
    return _checked(params, lambda: get_model(name)(config), name)


def flax_to_torch_ncsn3d(params: Mapping[str, Any], config,
                         name: str = "ncsn3d_shallow"
                         ) -> Dict[str, torch.Tensor]:
    """State dict for a 3-D net, the registry's `name`: "ncsn3d_shallow"
    (NCSN3DShallow, the Diffusion3D task's) or "ncsn3d" (NCSN3D), from the
    JAX package's params tree of numpy arrays. The temporal up
    convolution's kernel (1, 1, 4, I, O), which the JAX layer flips, goes
    to torch's unflipped (I, O, 1, 1, 4). Raises if a name or shape does
    not match."""
    if name not in ("ncsn3d", "ncsn3d_shallow"):
        raise ValueError(f"flax_to_torch_ncsn3d: {name!r} is not a 3-D net")
    return _checked(params, lambda: get_model(name)(config), name)


def flax_to_torch_unet1d(params: Mapping[str, Any], config
                         ) -> Dict[str, torch.Tensor]:
    """State dict for UNET1D (the registry's "unet1d") from the JAX
    package's params tree of numpy arrays (its UNet under `UNet_0`).
    Raises if a name or shape does not match."""
    return _checked(params, lambda: get_model("unet1d")(config), "unet1d")


def flax_to_torch_unet(params: Mapping[str, Any], general_config=None
                       ) -> Dict[str, torch.Tensor]:
    """State dict for `build_seg_unet(general_config)` from the JAX
    package's seg UNet params tree of numpy arrays (the tree under
    "params"). Raises if a name or shape does not match."""
    return _checked(params, lambda: build_seg_unet(general_config),
                    "seg UNet")


def flax_to_torch_clf(params: Mapping[str, Any], general_config=None
                      ) -> Dict[str, torch.Tensor]:
    """State dict for `build_clf(general_config, in_channels)` (ResNetClf,
    in_channels those of the tree's pre_conv kernel) from the JAX
    package's classifier params tree of numpy arrays (the tree under
    "params"): the convolution kernels (kh, kw, I, O) -> (O, I, kh, kw),
    the GroupNorm scale / bias -> weight / bias, the fc Dense kernel
    transposed. Raises if a name or shape does not match."""
    in_channels = int(np.shape(params["pre_conv"]["kernel"])[2])
    return _checked(params, lambda: build_clf(general_config, in_channels),
                    "ResNetClf")


def seeded_weights(model: nn.Module, seed: int, std_scale: float = 1.0
                   ) -> nn.Module:
    """Draw every parameter of `model` from a torch.Generator seeded with
    `seed`, in place, and return the model.

    NCSN++: weights and biases of convolutions, Linear and NIN layers are
    normal at fan-in scale, std_scale / sqrt(fan_in). GroupNorm scales are
    1 + 0.1 z and shifts 0.1 z. The Fourier projection keeps its configured
    std. The model's own init has init_scale 0 on the last conv of each
    block, which makes outputs near zero; these weights give outputs of
    order one.
    NCSNv2 family (both ranks) and NCSN v1: the JAX package's init
    distributions, convolution weights and biases U(+-std_scale /
    sqrt(fan_in)) (torch's default), InstanceNorm++ and VarianceNorm alpha
    and gamma N(1, 0.02), beta 0; the conditional norms' gamma_embed and
    alpha_embed N(1, 0.02), beta_embed 0; BatchNorm scale 1, bias 0 (its
    running statistics are left as they are).
    ScoreNet: convolutions as the NCSN family's, Linear layers and
    GroupNorm as NCSN++'s.
    Seg UNet and UNET1D: convolution and transposed-convolution weights and
    biases U(+-std_scale / sqrt(fan_in)), fan_in = I prod(k) for a
    convolution and O prod(k) for a transposed one (torch's default, the
    JAX init's bounds); the PReLU slopes 0.25. The 3-D nets as the NCSNv2
    family, the temporal down and up convolutions as a convolution and a
    transposed one.
    ResNetClf: convolution weights and the pre-conv's bias U(+-std_scale /
    sqrt(fan_in)), the GroupNorm weights 1 + 0.1 z and biases 0.1 z, the
    fc head normal at fan-in scale.
    The draws happen on the CPU, so a seed gives the same weights whatever
    device the model is on.
    """
    gen = torch.Generator().manual_seed(seed)

    def draw(p: torch.Tensor, std: float, mean: float = 0.0):
        z = torch.randn(p.shape, generator=gen, dtype=torch.float32)
        p.copy_((mean + std * z).to(p.device, p.dtype))

    def uniform(p: torch.Tensor, bound: float):
        u = torch.rand(p.shape, generator=gen, dtype=torch.float32)
        p.copy_((bound * (2 * u - 1)).to(p.device, p.dtype))

    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, (layers.Conv, layers.ConvTranspose,
                                   ncsn3d.TemporalDownConv, simple.FlaxConv,
                                   simple.FlaxConvTranspose)):
                # weight[0]: (I, *k) of a conv, (O, *k) of a transposed
                # one
                bound = std_scale / math.sqrt(module.weight[0].numel())
                uniform(module.weight, bound)
                if module.bias is not None:
                    uniform(module.bias, bound)
            elif isinstance(module, unet.PReLU):
                module.alpha.fill_(0.25)
            elif isinstance(module, (normalization.InstanceNormPlus,
                                     normalization.VarianceNorm)):
                draw(module.alpha, 0.02, mean=1.0)
                if isinstance(module, normalization.InstanceNormPlus):
                    draw(module.gamma, 0.02, mean=1.0)
                    module.beta.zero_()
            elif isinstance(module, normalization._Conditional):
                for pname, p in module.named_parameters(recurse=False):
                    if pname == "beta_embed":
                        p.zero_()
                    else:
                        draw(p, 0.02, mean=1.0)
            elif isinstance(module, normalization._BatchStats):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, (nn.Conv2d, nn.Linear)):
                fan_in = module.weight[0].numel()
                draw(module.weight, std_scale / math.sqrt(fan_in))
                if module.bias is not None:
                    draw(module.bias, std_scale / math.sqrt(fan_in))
            elif isinstance(module, layerspp.NIN):
                fan_in = module.W.shape[0]
                draw(module.W, std_scale / math.sqrt(fan_in))
                draw(module.b, std_scale / math.sqrt(fan_in))
            elif isinstance(module, nn.GroupNorm):
                draw(module.weight, 0.1, mean=1.0)
                draw(module.bias, 0.1)
            elif isinstance(module, layerspp.GaussianFourierProjection):
                draw(module.W, module.scale)
            elif isinstance(module, (layerspp.Upsample, layerspp.Downsample)
                            ) and module.with_conv and module.fir:
                fan_in = module.Conv2d_0_weight[..., 0].numel()
                draw(module.Conv2d_0_weight, std_scale / math.sqrt(fan_in))
                draw(module.Conv2d_0_bias, std_scale / math.sqrt(fan_in))
            elif list(module.parameters(recurse=False)):
                raise TypeError(f"seeded_weights: no rule for the parameters "
                                f"of {name} ({type(module).__name__})")
    return model

"""Weights for the port's NCSN++, NCSNv2 family and seg UNet: converted
from a Flax parameter tree, or drawn from a seed.

`flax_to_torch_ncsnpp`, `flax_to_torch_ncsnv2` and `flax_to_torch_unet` map
the JAX package's parameters onto the port's state dict, name by name (the
port keeps the Flax module names):

- conv kernels (kh, kw, I, O) -> weight (O, I, kh, kw), no flip; the
  1-D nets' kernels (k, I, O) -> weight (O, I, k);
- transposed-conv kernels (kh, kw, I, O) -> weight (I, O, kh, kw), no
  flip: the JAX layer flips the kernel itself, as torch's
  conv_transpose2d does;
- Dense kernels (in, out) -> Linear weight (out, in);
- GroupNorm scale / bias -> weight / bias;
- NIN W / b, the Fourier W, the fused resamplers' Conv2d_0_weight
  (kh, kw, I, O) / Conv2d_0_bias, the InstanceNorm++ alpha / gamma /
  beta and the PReLU alpha (a scalar) keep name and layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models import layers, layerspp, normalization, unet
from ..models.registry import (build_seg_unet, create_model, get_model,
                               get_network)


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
    if leaf == "kernel" and value.ndim == 4:
        if module in transposed:
            return weight, value.transpose(2, 3, 0, 1)
        return weight, value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 3:
        return weight, value.transpose(2, 1, 0)
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
                  if isinstance(module, nn.ConvTranspose2d)}
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


def flax_to_torch_ncsnpp(params: Mapping[str, Any], config
                         ) -> Dict[str, torch.Tensor]:
    """State dict for `create_model(config)` from a Flax NCSN++ params tree
    of numpy arrays (the tree under "params"). Raises if a name or shape
    does not match the port's model."""
    return _checked(params, lambda: create_model(config), config.model.name)


def flax_to_torch_ncsnv2(params: Mapping[str, Any], config,
                         name: Optional[str] = None
                         ) -> Dict[str, torch.Tensor]:
    """State dict for an NCSNv2-family model from the JAX package's params
    tree of numpy arrays (the tree under "params"). The model is the
    registry's `name` (e.g. "ncsnv2_deepest", or "ncsn1d" for the 1-D
    temporal prior), else `config.model.name`
    where the config has one, else the size dispatch of `get_network`
    (NCSNv2Deepest at 256 px, the ACDC prior). Raises if a name or shape
    does not match."""
    name = name or config.model.get("name")
    if name is None:
        return _checked(params, lambda: get_network(config),
                        "NCSNv2 family (by image size)")
    return _checked(params, lambda: get_model(name)(config), name)


def flax_to_torch_unet(params: Mapping[str, Any], general_config=None
                       ) -> Dict[str, torch.Tensor]:
    """State dict for `build_seg_unet(general_config)` from the JAX
    package's seg UNet params tree of numpy arrays (the tree under
    "params"). Raises if a name or shape does not match."""
    return _checked(params, lambda: build_seg_unet(general_config),
                    "seg UNet")


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
    NCSNv2 family (both ranks): the JAX package's init distributions,
    convolution weights and biases U(+-std_scale / sqrt(fan_in)) (torch's
    default), InstanceNorm++ and VarianceNorm alpha and gamma N(1, 0.02),
    beta 0.
    Seg UNet: convolution and transposed-convolution weights and biases
    U(+-std_scale / sqrt(fan_in)), fan_in = I kh kw for a convolution and
    O kh kw for a transposed one (torch's default, the JAX init's bounds);
    the PReLU slopes 0.25.
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
            if isinstance(module, (layers.Conv, layers.ConvTranspose)):
                # weight[0]: (I, kh, kw) of a conv, (O, kh, kw) of a
                # transposed one
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
                            ) and module.with_conv:
                fan_in = module.Conv2d_0_weight[..., 0].numel()
                draw(module.Conv2d_0_weight, std_scale / math.sqrt(fan_in))
                draw(module.Conv2d_0_bias, std_scale / math.sqrt(fan_in))
            elif list(module.parameters(recurse=False)):
                raise TypeError(f"seeded_weights: no rule for the parameters "
                                f"of {name} ({type(module).__name__})")
    return model

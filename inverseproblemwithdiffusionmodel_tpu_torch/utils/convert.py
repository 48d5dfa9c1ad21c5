"""Weights for the port's NCSN++: converted from a Flax parameter tree, or
drawn from a seed.

`flax_to_torch_ncsnpp` maps the JAX package's NCSN++ parameters onto the
port's state dict, name by name (the port keeps the Flax module names):

- conv kernels (kh, kw, I, O) -> weight (O, I, kh, kw), no flip;
- Dense kernels (in, out) -> Linear weight (out, in);
- GroupNorm scale / bias -> weight / bias;
- NIN W / b, the Fourier W and the fused resamplers' Conv2d_0_weight
  (kh, kw, I, O) / Conv2d_0_bias keep name and layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from ..models import layerspp
from ..models.registry import create_model


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def _convert_leaf(path: str, value: np.ndarray):
    module, _, leaf = path.rpartition(".")
    if leaf == "kernel" and value.ndim == 4:
        return f"{module}.weight", value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 2:
        return f"{module}.weight", value.T
    if leaf == "scale":
        return f"{module}.weight", value
    return path, value


def flax_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's layers from a Flax params tree of arrays."""
    state = {}
    for path, value in _flatten(params):
        name, value = _convert_leaf(path, value)
        state[name] = torch.tensor(value, dtype=torch.float32)
    return state


def flax_to_torch_ncsnpp(params: Mapping[str, Any], config
                         ) -> Dict[str, torch.Tensor]:
    """State dict for `create_model(config)` from a Flax NCSN++ params tree
    of numpy arrays (the tree under "params"). Raises if a name or shape
    does not match the port's model."""
    with torch.device("meta"):
        expected = create_model(config).state_dict()
    state = flax_to_torch(params)
    for name, value in state.items():
        if name not in expected:
            raise KeyError(f"no parameter {name!r} in the port's "
                           f"{config.model.name}")
        if value.shape != expected[name].shape:
            raise ValueError(f"{name}: converted shape {tuple(value.shape)}, "
                             f"the port expects {tuple(expected[name].shape)}")
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"parameters missing from the Flax tree: {missing}")
    return state


def seeded_weights(model: nn.Module, seed: int, std_scale: float = 1.0
                   ) -> nn.Module:
    """Draw every parameter of `model` from a torch.Generator seeded with
    `seed`, in place, and return the model.

    Weights and biases of convolutions, Linear and NIN layers are normal at
    fan-in scale, std_scale / sqrt(fan_in). GroupNorm scales are 1 + 0.1 z and
    shifts 0.1 z. The Fourier projection keeps its configured std. The
    model's own init has init_scale 0 on the last conv of each block, which
    makes outputs near zero; these weights give outputs of order one.
    The draws happen on the CPU, so a seed gives the same weights whatever
    device the model is on.
    """
    gen = torch.Generator().manual_seed(seed)

    def draw(p: torch.Tensor, std: float, mean: float = 0.0):
        z = torch.randn(p.shape, generator=gen, dtype=torch.float32)
        p.copy_((mean + std * z).to(p.device, p.dtype))

    with torch.no_grad():
        for name, module in model.named_modules():
            if isinstance(module, (nn.Conv2d, nn.Linear)):
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

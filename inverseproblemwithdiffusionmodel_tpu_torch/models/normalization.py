"""Normalization layers of the NCSNv2 score networks, NCHW, NCT or
NCDHW.

Port of the unconditional norms of inverseproblemwithdiffusionmodel_tpu/
models/normalization.py (reference: ncsn/models/normalization.py).
InstanceNorm++ is InstanceNorm with the per-channel means, normalized over
the channel axis, re-injected through a learned alpha. Instance statistics
use the biased variance with eps 1e-5; the statistics of the channel means
use the UNBIASED variance (torch.var's default, ddof=1), so C >= 2.
Statistics run over every spatial axis (H and W; T of the temporal
prior; the three axes of the 2D+time volumes). Parameters carry the Flax
names: alpha, gamma, beta of shape (C,). The norms take their width only
(the JAX modules' `bias` flag, unused by every net here, is left out).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def _spatial(x: torch.Tensor):
    return tuple(range(2, x.ndim))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) or (B, C) tensor shaped to broadcast against x."""
    return v.reshape(v.shape + (1,) * (x.ndim - 2))


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel standardization over the spatial axes
    (biased variance). torch's instance_norm refuses one spatial element,
    where x - mean is exactly 0 (as in the JAX package)."""
    if x[0, 0].numel() == 1:
        return torch.zeros_like(x)
    return F.instance_norm(x, eps=eps)


class InstanceNormPlus(nn.Module):
    """InstanceNorm++ (reference: normalization.py:150-177)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(num_features))
        self.gamma = nn.Parameter(torch.ones(num_features))
        self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        means = x.mean(dim=_spatial(x))                           # (B, C)
        m = means.mean(dim=-1, keepdim=True)
        v = means.var(dim=-1, keepdim=True)                       # unbiased
        means_norm = (means - m) / torch.sqrt(v + 1e-5)
        # gamma * (h + alpha * means_norm) + beta, with the per-(B, C) terms
        # folded into one shift
        shift = self.gamma * self.alpha * means_norm + self.beta
        return torch.addcmul(_per_channel(shift, x), _instance_norm(x),
                             _per_channel(self.gamma, x))


class InstanceNorm(nn.Module):
    """Plain InstanceNorm, no affine."""

    def __init__(self, num_features: int):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _instance_norm(x)


class VarianceNorm(nn.Module):
    """Variance-only normalization (reference: normalization.py:103-116)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.var(dim=_spatial(x), keepdim=True, unbiased=False)
        return _per_channel(self.alpha, x) * (x / torch.sqrt(var + 1e-5))


class NoneNorm(nn.Module):

    def __init__(self, num_features: int = 0):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


_NORMS = {
    "InstanceNorm++": InstanceNormPlus,
    "InstanceNorm": InstanceNorm,
    "VarianceNorm": VarianceNorm,
    "NoneNorm": NoneNorm,
}


def get_normalization(config, conditional: bool = False):
    """The norm class named by config.model.normalization. The conditional
    norms and BatchNorm are not ported yet."""
    name = config.model.normalization
    if conditional:
        raise NotImplementedError(
            f"conditional {name} is not ported yet (ROADMAP: Slices F, G)")
    if name not in _NORMS:
        raise NotImplementedError(f"normalization {name!r} is not ported; "
                                  f"ported: {sorted(_NORMS)}")
    return _NORMS[name]

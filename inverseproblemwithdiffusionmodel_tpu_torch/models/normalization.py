"""Normalization layers of the NCSN score networks, NCHW, NCT or NCDHW.

Port of inverseproblemwithdiffusionmodel_tpu/models/normalization.py
(reference: ncsn/models/normalization.py): the unconditional norms of the
NCSNv2 family, BatchNorm, and the class-conditional norms of NCSN v1, whose
per-class parameters are embeddings indexed by the integer label y (B,).
InstanceNorm++ is InstanceNorm with the per-channel means, normalized over
the channel axis, re-injected through a learned alpha. Instance statistics
use the biased variance with eps 1e-5; the statistics of the channel means
use the UNBIASED variance (torch.var's default, ddof=1), so C >= 2.
Statistics run over every spatial axis (H and W; T of the temporal
prior; the three axes of the 2D+time volumes). Parameters carry the Flax
names: alpha, gamma, beta of shape (C,); the conditional norms'
gamma_embed, alpha_embed, beta_embed of shape (num_classes, C). The norms
take their widths only (the JAX modules' `bias` flag, unused by every net
here, is left out).
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


class BatchNorm(nn.Module):
    """Flax `nn.BatchNorm` over the batch and spatial axes, under the JAX
    wrapper's name: the parameters and statistics live in the child
    `BatchNorm_0` (scale -> weight, bias; batch_stats mean and var as
    buffers of those names). As in the JAX package the mode is the
    module's `use_running_average` (default True), not torch's train()
    flag. With use_running_average=False the batch statistics normalize x
    (the biased variance) and update the running ones as Flax does,
    momentum 0.99 on the old value, the BIASED batch variance; torch's
    BatchNorm2d would keep momentum 0.1 of the new value and the unbiased
    variance. eps 1e-5 inside the square root."""
    MOMENTUM, EPS = 0.99, 1e-5

    def __init__(self, num_features: int, use_running_average: bool = True):
        super().__init__()
        self.use_running_average = use_running_average
        self.BatchNorm_0 = _BatchStats(num_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.BatchNorm_0
        if self.use_running_average:
            mean, var = bn.mean, bn.var
        else:
            axes = (0,) + _spatial(x)
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
            with torch.no_grad():
                bn.mean.mul_(self.MOMENTUM).add_((1 - self.MOMENTUM) * mean)
                bn.var.mul_(self.MOMENTUM).add_((1 - self.MOMENTUM) * var)
        scale = bn.weight * torch.rsqrt(var + self.EPS)
        return torch.addcmul(_per_channel(bn.bias - mean * scale, x), x,
                             _per_channel(scale, x))


class _BatchStats(nn.Module):
    """Flax BatchNorm's parameters (scale as weight, bias) and running
    statistics (mean 0, var 1 at init)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))


class _Conditional(nn.Module):
    """Per-class parameters (num_classes, C), picked by the label y (B,):
    `embeds` names those initialized at 1 (N(1, 0.02) in the JAX init),
    `zeros` those at 0."""

    def __init__(self, num_features: int, num_classes: int,
                 embeds=("gamma_embed",), zeros=("beta_embed",)):
        super().__init__()
        for name in embeds:
            setattr(self, name, nn.Parameter(
                torch.ones(num_classes, num_features)))
        for name in zeros:
            setattr(self, name, nn.Parameter(
                torch.zeros(num_classes, num_features)))

    def _affine(self, h: torch.Tensor, y: torch.Tensor,
                shift: torch.Tensor = None) -> torch.Tensor:
        """gamma[y] * h + beta[y] (+ shift, (B, C))."""
        gamma = self.gamma_embed[y]
        beta = self.beta_embed[y] if shift is None else \
            self.beta_embed[y] + shift
        return torch.addcmul(_per_channel(beta, h), h,
                             _per_channel(gamma, h))


class ConditionalInstanceNormPlus(_Conditional):
    """Class-conditional InstanceNorm++ (reference: normalization.py:
    179-208): InstanceNorm++ with gamma, alpha and beta per class."""

    def __init__(self, num_features: int, num_classes: int):
        super().__init__(num_features, num_classes,
                         embeds=("gamma_embed", "alpha_embed"))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        means = x.mean(dim=_spatial(x))                           # (B, C)
        m = means.mean(dim=-1, keepdim=True)
        v = means.var(dim=-1, keepdim=True)                       # unbiased
        means_norm = (means - m) / torch.sqrt(v + 1e-5)
        # gamma * (h + alpha * means_norm) + beta, per-(B, C) terms folded
        shift = self.gamma_embed[y] * self.alpha_embed[y] * means_norm
        return self._affine(_instance_norm(x), y, shift)


class ConditionalInstanceNorm(_Conditional):
    """Class-conditional InstanceNorm: gamma and beta per class on the
    affine-free instance statistics (reference: normalization.py:77-101)."""

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self._affine(_instance_norm(x), y)


class ConditionalVarianceNorm(_Conditional):
    """Class-conditional variance normalization, alpha per class
    (reference: normalization.py:43-60)."""

    def __init__(self, num_features: int, num_classes: int):
        super().__init__(num_features, num_classes, embeds=("alpha_embed",),
                         zeros=())

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        var = x.var(dim=_spatial(x), keepdim=True, unbiased=False)
        return _per_channel(self.alpha_embed[y], x) * (
            x / torch.sqrt(var + 1e-5))


class ConditionalNoneNorm(_Conditional):
    """Class-conditional affine without normalization (reference:
    normalization.py:122-147)."""

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self._affine(x, y)


_NORMS = {
    "InstanceNorm++": InstanceNormPlus,
    "InstanceNorm": InstanceNorm,
    "VarianceNorm": VarianceNorm,
    "NoneNorm": NoneNorm,
    "BatchNorm": BatchNorm,
}

_COND_NORMS = {
    "InstanceNorm++": ConditionalInstanceNormPlus,
    "InstanceNorm": ConditionalInstanceNorm,
    "VarianceNorm": ConditionalVarianceNorm,
    "NoneNorm": ConditionalNoneNorm,
}


def get_normalization(config, conditional: bool = False):
    """The norm class named by config.model.normalization; with
    `conditional` the class-conditional one, built as `cls(num_features,
    num_classes)` and called as `norm(x, y)`."""
    name = config.model.normalization
    table = _COND_NORMS if conditional else _NORMS
    if name not in table:
        raise NotImplementedError(
            f"{'conditional ' if conditional else ''}normalization {name!r} "
            f"does not exist; one of {sorted(table)}")
    return table[name]

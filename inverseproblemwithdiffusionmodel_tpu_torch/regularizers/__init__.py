"""Pluggable regularizers for the MAP-style reconstructions.

Port of inverseproblemwithdiffusionmodel_tpu/regularizers/__init__.py
(reference: ncsn/regularizers/__init__.py:4-15 `AbstractRegularizer`,
`ZeroReg`; the TV penalty of the reference's TV baseline, kornia's
TotalVariation on a complex parameter, scripts/acdc_SENSE_TV.py:16,78).

A regularizer is a callable on a complex image, or (`.pair`) on an (re,
im) pair of real tensors, returning the scalar penalty; autograd
differentiates it. `samplers.map_opt.tv_reconstruction` takes one through
its `regularizer=` argument.
"""
from __future__ import annotations

import abc
from typing import Tuple

import torch


class AbstractRegularizer(abc.ABC):
    """A scalar penalty R(x) added to a data-consistency objective
    (reference: ncsn/regularizers/__init__.py:4-11)."""

    @abc.abstractmethod
    def __call__(self, *args, **kwargs):
        ...

    def pair(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        """The penalty of re + i im. Default: complexify."""
        return self(torch.complex(re, im))


class ZeroReg(AbstractRegularizer):
    """No regularization (reference: ncsn/regularizers/__init__.py:13-15)."""

    def __call__(self, *args, **kwargs):
        return 0.0

    def pair(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        return torch.zeros((), dtype=re.dtype, device=re.device)


class TVRegularizer(AbstractRegularizer):
    """weight * the anisotropic complex-modulus total variation with open
    boundaries (samplers/map_opt.tv_norm_noncircular) over `spatial_axes`,
    H and W of the channel-last (B, H, W, C) layout by default."""

    def __init__(self, weight: float = 1.0,
                 spatial_axes: Tuple[int, int] = (1, 2)):
        self.weight = weight
        self.spatial_axes = spatial_axes

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from ..samplers.map_opt import tv_norm_noncircular
        return self.weight * tv_norm_noncircular(x, self.spatial_axes)

    def pair(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        from ..samplers.map_opt import tv_norm_noncircular_pair
        return self.weight * tv_norm_noncircular_pair(re, im,
                                                      self.spatial_axes)


__all__ = ["AbstractRegularizer", "ZeroReg", "TVRegularizer"]

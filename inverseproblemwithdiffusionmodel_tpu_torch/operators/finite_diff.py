"""Circular forward differences and the anisotropic-TV subgradient.

Port of inverseproblemwithdiffusionmodel_tpu/operators/finite_diff.py
(reference: ncsn/linear_transforms/finite_diff.py:7-35): the 'tv'
temporal prior of the 2D+time sampler, along the frame axis (dims=1 of
(B, T, H, W, C)).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class FiniteDiff:
    dims: Union[int, Tuple[int, ...]]

    def _roll(self, x: torch.Tensor, step: int) -> torch.Tensor:
        dims = (self.dims,) if isinstance(self.dims, int) else self.dims
        return torch.roll(x, (step,) * len(dims), dims=tuple(dims))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._roll(x, -1) - x

    def conj_op(self, s: torch.Tensor) -> torch.Tensor:
        return self._roll(s, 1) - s

    def log_lh_grad(self, x: torch.Tensor, lamda=1.0) -> torch.Tensor:
        """-lamda * nabla^T sign(nabla x) (reference: finite_diff.py:29-35)."""
        return -lamda * self.conj_op(torch.sign(self(x)))


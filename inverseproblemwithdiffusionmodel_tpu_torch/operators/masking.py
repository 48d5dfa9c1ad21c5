"""Row-decimation operator (inpainting-style line skipping).

Port of inverseproblemwithdiffusionmodel_tpu/operators/masking.py
(reference: ncsn/linear_transforms/masking.py:6-44): A = P * M keeps every
`num_skip_lines`-th row; the adjoint zero-pads. Channel-last (B, H, W, C);
rows are axis 1.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import LinearTransform


@dataclasses.dataclass(frozen=True)
class SkipLines(LinearTransform):
    num_skip_lines: int
    height: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, 0::self.num_skip_lines]

    def conj_op(self, s: torch.Tensor) -> torch.Tensor:
        out = s.new_zeros((s.shape[0], self.height) + tuple(s.shape[2:]))
        out[:, 0::self.num_skip_lines] = s
        return out

    def projection(self, x: torch.Tensor, s: torch.Tensor, lamda: float
                   ) -> torch.Tensor:
        """Kept rows <- lamda * s + (1 - lamda) * A x; skipped rows
        unchanged (reference: masking.py:30-44). x is not modified."""
        mixed = lamda * s + (1.0 - lamda) * self(x)
        out = x.clone()
        out[:, 0::self.num_skip_lines] = mixed
        return out

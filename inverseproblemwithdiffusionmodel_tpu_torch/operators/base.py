"""Linear forward-operator protocol of the inverse problems, and the
tensor-holding mixin both operator families share.

Port of inverseproblemwithdiffusionmodel_tpu/operators/base.py
(reference: ncsn/linear_transforms/__init__.py:6-33). The operators are
frozen dataclasses holding tensors (Flax `struct.PyTreeNode`s in the JAX
package): `.replace(...)` returns a changed copy and `.to(device)` moves
every tensor. Images are channel-last complex64 (B, H, W, C);
measurements are operator-defined (SENSE stacks a coil axis in front).
"""
from __future__ import annotations

import dataclasses

import torch


class _Tensors:
    """`.replace(**changes)` and `.to(device)` for frozen dataclasses whose
    tensor fields (and nested operators) move together."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        changes = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if isinstance(value, (torch.Tensor, _Tensors)):
                changes[f.name] = value.to(device)
        return self.replace(**changes)


class LinearTransform(_Tensors):
    """A |-> A x with adjoint and optional k-space projection."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def conj_op(self, s: torch.Tensor) -> torch.Tensor:
        """Adjoint A^H s."""
        raise NotImplementedError

    def projection(self, x: torch.Tensor, s: torch.Tensor, lamda: float
                   ) -> torch.Tensor:
        """Hard/soft data-consistency projection (operator specific)."""
        raise NotImplementedError

    def log_lh_grad(self, x: torch.Tensor, s: torch.Tensor,
                    lamda: float = 1.0) -> torch.Tensor:
        """grad_x log p(s | x) = -lamda * A^H (A x - s)
        (reference: linear_transforms/__init__.py:26-33)."""
        return -self.conj_op(self(x) - s) * lamda

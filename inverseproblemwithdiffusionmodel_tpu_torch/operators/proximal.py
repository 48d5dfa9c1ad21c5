"""Data-consistency proximal operators, complex64.

All solve  x <- argmin_x 1/2 ||x - z||^2 + 1/2 * (alpha/lamda) ||A x - y||^2
whose normal equation is  (I + c A^H A) x = z + c A^H y,  c = alpha / lamda.

Port of inverseproblemwithdiffusionmodel_tpu/operators/proximal.py
(reference: ncsn/models/proximal_op.py). `L2Penalty` solves the normal
equation with conjugate gradients (mode 'cg', the default) or takes the
reference's single SGD step (mode 'sgd', proximal_op.py:19-51);
`SingleCoil` is the closed form for a masked single-coil Fourier operator
(proximal_op.py:72-94). `check_solution` returns the normal equation's
residual (proximal_op.py:53-59,96-104).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .base import LinearTransform, _Tensors
from ..ops.fft import i2k_complex, k2i_complex


def _cdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re<a, b> summed over everything, the batch included: the chains of
    one CG solve share its step sizes, as in the JAX package. A 0-d
    float32 tensor on the inputs' device."""
    return torch.sum(torch.view_as_real(a) * torch.view_as_real(b))


def cg_solve(operator: Callable[[torch.Tensor], torch.Tensor],
             b: torch.Tensor, x0: torch.Tensor, num_iters: int
             ) -> torch.Tensor:
    """Conjugate gradients for a Hermitian PSD `operator`, a fixed number
    of iterations. The step sizes stay on the device (no host read in the
    loop); both divisions are guarded at 1e-30. The eigenvalues of I + c
    A^H A lie in [1, 1 + c], so a few iterations reach float32
    precision."""
    x = x0
    r = b - operator(x0)
    p = r
    rs = _cdot(r, r)
    for _ in range(num_iters):
        Ap = operator(p)
        alpha = rs / torch.clamp_min(_cdot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _cdot(r, r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = r + beta * p
        rs = rs_new
    return x


@dataclasses.dataclass(frozen=True)
class Proximal(_Tensors):
    lin_tfm: LinearTransform

    def __call__(self, z: torch.Tensor, y: torch.Tensor, alpha: float,
                 lamda: float) -> torch.Tensor:
        raise NotImplementedError

    def check_solution(self, x_sol: torch.Tensor, z: torch.Tensor,
                       y: torch.Tensor, alpha: float, lamda: float
                       ) -> torch.Tensor:
        """Mean squared normal-equation residual
        (reference: proximal_op.py:53-59)."""
        c = alpha / lamda
        lhs = x_sol + c * self.lin_tfm.conj_op(self.lin_tfm(x_sol))
        rhs = z + c * self.lin_tfm.conj_op(y)
        B = x_sol.shape[0]
        return torch.mean(torch.sum(
            torch.abs(lhs - rhs).reshape(B, -1) ** 2, dim=-1))


@dataclasses.dataclass(frozen=True)
class L2Penalty(Proximal):
    """CG solve of the prox normal equation (default), or the reference's
    single batch-mean SGD step (mode 'sgd', proximal_op.py:19-51)."""
    num_iters: int = 8
    mode: str = "cg"
    sgd_lr: float = 5e-2

    def __call__(self, z, y, alpha, lamda):
        c = alpha / lamda
        if self.mode == "cg":
            b = z + c * self.lin_tfm.conj_op(y)
            op = lambda v: v + c * self.lin_tfm.conj_op(self.lin_tfm(v))
            return cg_solve(op, b, z, self.num_iters)
        if self.mode == "sgd":
            # One SGD step at x = z on the batch-mean quadratic: the (x - z)
            # term vanishes, leaving z - lr/B * c * A^H (A z - y).
            B = z.shape[0]
            grad = c * self.lin_tfm.conj_op(self.lin_tfm(z) - y)
            return z - self.sgd_lr / B * grad
        raise ValueError(f"unknown L2Penalty mode {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class Constrained(Proximal):
    """Hard k-space replacement via the operator's projection
    (reference: proximal_op.py:62-69, Yang et al.)."""

    def __call__(self, z, y, alpha, lamda=None):
        # the signature is kept uniform; `alpha` plays the reference's
        # lamda role
        return self.lin_tfm.projection(z, y, alpha)


@dataclasses.dataclass(frozen=True)
class SingleCoil(Proximal):
    """Closed form for masked single-coil Fourier (orthonormal FFT):
    x = F' diag(1/(1 + c M)) F (z + c F' y)  (reference:
    proximal_op.py:72-94)."""

    def __call__(self, z, y, alpha, lamda):
        c = alpha / lamda
        x = z + c * k2i_complex(y)
        k = i2k_complex(x) / (1.0 + self.lin_tfm.mask * c)
        return k2i_complex(k)


def get_proximal(name: str) -> type:
    """Name dispatch (reference: proximal_op.py:107-119)."""
    table = {"L2Penalty": L2Penalty, "Constrained": Constrained,
             "SingleCoil": SingleCoil}
    if name not in table:
        raise NotImplementedError(f"unknown proximal {name!r}")
    return table[name]

"""Real-pair forward operators and the proximal CG solver.

Port of inverseproblemwithdiffusionmodel_tpu/operators/pair.py: complex
arrays are (re, im) float32 pairs, the FFT is the matmul DFT of
ops/fft_pair.py, and the multi-coil SENSE normal operator collapses to one
W x W matrix per mask row (`line_mask_normal_kernel`). The operators are
frozen dataclasses holding tensors (Flax `struct.PyTreeNode`s in the JAX
package; operators/base._Tensors): `.replace(...)` returns a changed copy
and `.to(device)` moves every tensor. Images are channel-last (B, H, W,
C); SENSE measurements (num_sens, B, H, W, C).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .base import _Tensors
from ..ops.fft_pair import _dft_mats, cconj_mul, cmul, i2k_pair, k2i_pair
from ..utils.precision import float32_matmul

Pair = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PairSENSE(_Tensors):
    """Multi-coil SENSE in pair form.

    mask: (1|T, 1, W, 1) float32; sens (num_sens, H, W, 1) as (re, im).
    Forward: (B, H, W, C) pair -> (num_sens, B, H, W, C) pair.
    """
    mask: torch.Tensor
    sens_re: torch.Tensor
    sens_im: torch.Tensor

    def __call__(self, xr: torch.Tensor, xi: torch.Tensor) -> Pair:
        cr, ci = cmul(self.sens_re[:, None], self.sens_im[:, None],
                      xr[None], xi[None])
        kr, ki = i2k_pair(cr, ci)
        return self.mask * kr, self.mask * ki

    def conj_op(self, sr: torch.Tensor, si: torch.Tensor) -> Pair:
        """The adjoint without the mask: measurements live on its support
        (as the reference's SkipLines zero-pad adjoint), so it is not
        applied again."""
        ir, ii = k2i_pair(sr, si)
        rr, ri = cconj_mul(self.sens_re[:, None], self.sens_im[:, None],
                           ir, ii)
        return rr.sum(0), ri.sum(0)


@dataclasses.dataclass(frozen=True)
class PairRandomUndersamplingFourier(_Tensors):
    """Single-coil masked DFT in pair form."""
    mask: torch.Tensor

    def __call__(self, xr, xi) -> Pair:
        kr, ki = i2k_pair(xr, xi)
        return self.mask * kr, self.mask * ki

    def conj_op(self, sr, si) -> Pair:
        return k2i_pair(sr, si)


LinTfm = Union[PairSENSE, PairRandomUndersamplingFourier]


def _pair_dot(ar, ai, br, bi) -> torch.Tensor:
    """Re<a, b> summed over everything."""
    return torch.sum(ar * br + ai * bi)


def line_mask_normal_kernel(mask: torch.Tensor) -> Pair:
    """Normal-equation kernel K = F_c^H diag(m) F_c of a Cartesian line
    mask (constant along H, shape (M0, 1, W, 1)): the H-axis DFTs cancel in
    A^H A, so the masked-Fourier normal operator is one W x W Hermitian
    matrix per mask row, applied along W. diag(m), not diag(m^2), because
    `conj_op` does not re-apply the mask: the kernel equals
    conj_op(forward(.)) for any real mask. Returns (Kr, Ki) of shape
    (M0, W, W), float32, on the mask's device."""
    m = np.asarray(mask.cpu(), np.float32)
    if m.ndim != 4 or m.shape[1] != 1 or m.shape[-1] != 1:
        raise ValueError(f"expected a line mask of shape (M0,1,W,1), "
                         f"got {m.shape}")
    fr, fi = _dft_mats(m.shape[2], inverse=False)
    Fc = fr.astype(np.complex64) + 1j * fi.astype(np.complex64)
    lines = m[:, 0, :, 0]                                   # (M0, W)
    K = np.einsum("vw,mv,vu->mwu", Fc.conj(), lines, Fc)    # F^H diag(m) F
    return (torch.as_tensor(K.real.astype(np.float32), device=mask.device),
            torch.as_tensor(K.imag.astype(np.float32), device=mask.device))


def _apply_line_kernel(kr: torch.Tensor, ki: torch.Tensor,
                       xr: torch.Tensor, xi: torch.Tensor) -> Pair:
    """Apply the (M0, W, W) complex kernel along the W axis of an
    (..., N, H, W, C) pair. M0 == 1 broadcasts; M0 == N is per row of the
    N axis; M0 dividing N repeats the kernel cyclically (a T-frame kernel
    over a B*T chain axis). Karatsuba: 3 real contractions."""
    M0, N = kr.shape[0], xr.shape[-4]
    if N % M0:
        raise ValueError(f"a kernel of {M0} rows does not tile {N} rows")

    def mat(m, v):
        if M0 == 1:
            # one (rows, V) @ (V, W) GEMM, the rows reshaped explicitly (a
            # view where C == 1): torch.matmul does not fold the size-1 C
            # axis into the rows and runs a batched GEMV instead
            vt = v.transpose(-1, -2)
            out = vt.reshape(-1, vt.shape[-1]) @ m[0].T
            return out.reshape(vt.shape).transpose(-1, -2)
        vb = v.reshape(v.shape[:-4] + (N // M0, M0) + v.shape[-3:])
        out = torch.einsum("nwv,...bnhvc->...bnhwc", m, vb)
        return out.reshape(v.shape)

    with float32_matmul():
        t1 = mat(kr, xr)
        t2 = mat(ki, xi)
        t3 = mat(kr + ki, xr + xi)
    return t1 - t2, t3 - t1 - t2


@dataclasses.dataclass(frozen=True)
class PairL2Penalty(_Tensors):
    """CG solve of (I + c A^H A) x = z + c A^H y on pairs, c = alpha /
    lamda, a fixed number of iterations.

    `kernel_re/kernel_im` (see `with_normal_kernel`) switch A^H A to the
    precomputed line-mask normal kernel; `ahy_re/ahy_im` pin a precomputed
    A^H y (loop-invariant across a sampling chain). Without them, A^H A is
    the operator composition and A^H y is computed at every call."""
    lin_tfm: LinTfm
    num_iters: int = 8
    kernel_re: Optional[torch.Tensor] = None
    kernel_im: Optional[torch.Tensor] = None
    ahy_re: Optional[torch.Tensor] = None
    ahy_im: Optional[torch.Tensor] = None

    @classmethod
    def with_normal_kernel(cls, lin_tfm: LinTfm, num_iters: int = 8,
                           measurement: Optional[Pair] = None
                           ) -> "PairL2Penalty":
        """Precompute the W x W normal kernel from the line mask and, when
        the measurement (yr, yi) is given, A^H y. A mask tiled over the
        chain axis is collapsed to one period first; the kernel is repeated
        cyclically when applied."""
        mask = lin_tfm.mask
        m = np.asarray(mask.cpu())
        M0 = m.shape[0]
        for p in range(1, M0 + 1):
            if M0 % p == 0 and np.array_equal(
                    m, np.tile(m[:p], (M0 // p, 1, 1, 1))):
                mask = mask[:p]
                break
        kr, ki = line_mask_normal_kernel(mask)
        ahy_r = ahy_i = None
        if measurement is not None:
            ahy_r, ahy_i = lin_tfm.conj_op(*measurement)
        return cls(lin_tfm=lin_tfm, num_iters=num_iters,
                   kernel_re=kr, kernel_im=ki, ahy_re=ahy_r, ahy_im=ahy_i)

    def _normal(self, vr, vi) -> Pair:
        """A^H A v through the precomputed line-mask kernel."""
        lin = self.lin_tfm
        if isinstance(lin, PairSENSE):
            cr, ci = cmul(lin.sens_re[:, None], lin.sens_im[:, None],
                          vr[None], vi[None])
            kr, ki = _apply_line_kernel(self.kernel_re, self.kernel_im,
                                        cr, ci)
            rr, ri = cconj_mul(lin.sens_re[:, None], lin.sens_im[:, None],
                               kr, ki)
            return rr.sum(0), ri.sum(0)
        return _apply_line_kernel(self.kernel_re, self.kernel_im, vr, vi)

    def _system(self, zr, zi, yr, yi, alpha, lamda):
        """(op, br, bi): the normal operator v -> (I + c A^H A) v and the
        right-hand side z + c A^H y of this solve."""
        c = alpha / lamda
        if self.ahy_re is not None:
            ar, ai = self.ahy_re, self.ahy_im
        else:
            ar, ai = self.lin_tfm.conj_op(yr, yi)
        br, bi = zr + c * ar, zi + c * ai

        if self.kernel_re is not None:
            def op(vr, vi):
                nr, ni = self._normal(vr, vi)
                return vr + c * nr, vi + c * ni
        else:
            def op(vr, vi):
                fr, fi = self.lin_tfm(vr, vi)
                gr, gi = self.lin_tfm.conj_op(fr, fi)
                return vr + c * gr, vi + c * gi
        return op, br, bi

    def __call__(self, zr, zi, yr, yi, alpha, lamda) -> Pair:
        return cg_shards([self], [(zr, zi, yr, yi)], [alpha], lamda)[0]


def cg_shards(proximals, args, alphas, lamda):
    """PairL2Penalty's CG over the shards of one batch: shard k is
    proximals[k] on (zr, zi, yr, yi) = args[k] with weight alphas[k], on
    its own device. The dot products are summed over the shards (on the
    first shard's device) and the step sizes sent back to each, so the
    iterates are those of one CG over the whole batch, whose dot products
    span every chain. Returns the (xr, xi) of each shard."""
    systems = [p._system(*a, alpha, lamda)
               for p, a, alpha in zip(proximals, args, alphas)]
    home = args[0][0].device

    def dot(us, vs):
        total = None
        for (ur, ui), (vr, vi) in zip(us, vs):
            d = _pair_dot(ur, ui, vr, vi).to(home)
            total = d if total is None else total + d
        return total

    def on(t, like):
        return t.to(like.device)

    # CG on the pair: a complex Hermitian system solved in R^2n. The
    # step sizes stay on the device; both divisions are guarded.
    xs = [(a[0], a[1]) for a in args]
    rs_ = []
    for (op, br, bi), (xr, xi) in zip(systems, xs):
        opr, opi = op(xr, xi)
        rs_.append((br - opr, bi - opi))
    ps = rs_
    rs = dot(rs_, rs_)
    for _ in range(proximals[0].num_iters):
        aps = [op(pr, pi) for (op, _, _), (pr, pi) in zip(systems, ps)]
        a = rs / torch.clamp_min(dot(ps, aps), 1e-30)
        xs = [(xr + on(a, xr) * pr, xi + on(a, xr) * pi)
              for (xr, xi), (pr, pi) in zip(xs, ps)]
        rs_ = [(rr - on(a, rr) * apr, ri - on(a, rr) * api)
               for (rr, ri), (apr, api) in zip(rs_, aps)]
        rs_new = dot(rs_, rs_)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        ps = [(rr + on(beta, rr) * pr, ri + on(beta, rr) * pi)
              for (rr, ri), (pr, pi) in zip(rs_, ps)]
        rs = rs_new
    return xs

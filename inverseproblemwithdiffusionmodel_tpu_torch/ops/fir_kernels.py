"""Factor-2 FIR resampling on hand-written CUDA kernels.

Port of the FIR half of inverseproblemwithdiffusionmodel_tpu/ops/
pallas_kernels.py:

- `upsample2x` (K1) and `downsample2x` (K2): the separable 4-tap polyphase
  resamplers. On a CUDA tensor each launches its kernel from csrc/fir2x.cu
  (built by ops/_build.py) or raises; on a CPU tensor it runs its plain
  PyTorch version, `upsample2x_plain` / `downsample2x_plain`, which is also
  the oracle the kernels are held against. Each counts its kernel launches in
  `LAUNCHES`.
- `fir_upsample_2x` / `fir_downsample_2x` (K3): the dispatchers the model
  calls. A 4-D input with even H and W and a separable 2..4-tap filter goes
  to K1/K2; anything else to the general plain `upfirdn2d`, differentiated
  by torch, as in the JAX package (minus its TPU VMEM guard).
- The K3 backward: both passes are linear, and per axis the exact transpose
  of the up pass with taps (k0, k1, k2, k3) is the down pass with the taps
  reversed, (k3, k2, k1, k0), unscaled, with the same zero borders; the
  transpose of the down pass is the up pass with its taps reversed. So
  `_Up2x.backward` runs K2 and `_Down2x.backward` runs K1, on either
  device, through the other direction's Function, which keeps the backward
  differentiable as JAX's `jax.linear_transpose` VJP is. A kernel launched
  as a backward counts under "<kernel>.bwd": "up2x.bwd" is K1 launched as
  the backward of a down pass.

Layout is channel-last (N, H, W, C), float32, as in the JAX package.
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .upfirdn2d import downsample_2d, upsample_2d

# Kernel launches since the last clear(), by kernel and direction ("up2x",
# "up2x.bwd", "down2x", "down2x.bwd"); read by chip_smoke.py to show that a
# run went through the kernels.
LAUNCHES: collections.Counter = collections.Counter()


def _sep_kernel_1d(k: Optional[Sequence[float]], gain_per_axis: float
                   ) -> np.ndarray:
    """The 4 taps of one axis: normalised, scaled, shorter kernels aligned."""
    k = np.asarray([1.0, 1.0] if k is None else k, dtype=np.float32)
    if not (k.ndim == 1 and 2 <= k.shape[0] <= 4):
        raise ValueError("the FIR kernels take separable kernels of length "
                         f"2..4, got shape {k.shape}")
    k = k / k.sum() * gain_per_axis
    if k.shape[0] < 4:
        # One leading zero re-aligns the shorter kernel's padding with the
        # 4-tap polyphase formulas (pad0 differs by exactly 1 per length
        # step); trailing zeros are inert.
        k = np.concatenate([np.zeros(1, np.float32), k,
                            np.zeros(3 - k.shape[0], np.float32)])
    return k


def _shift_down(x: torch.Tensor, dim: int) -> torch.Tensor:
    """y[i] = x[i-1], zero at i = 0."""
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([zero, x.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _shift_up(x: torch.Tensor, dim: int) -> torch.Tensor:
    """y[i] = x[i+1], zero at the last i."""
    zero = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([x.narrow(dim, 1, x.shape[dim] - 1), zero], dim)


def _up2_axis(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    even = float(k[1]) * x + float(k[3]) * _shift_down(x, dim)
    odd = float(k[2]) * x + float(k[0]) * _shift_up(x, dim)
    shape = list(x.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim + 1).reshape(shape)


def _down2_axis(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    pair = x.unflatten(dim, (-1, 2))
    e, o = pair.select(dim + 1, 0), pair.select(dim + 1, 1)
    return (float(k[3]) * _shift_down(o, dim) + float(k[2]) * e
            + float(k[1]) * o + float(k[0]) * _shift_up(e, dim))


def upsample2x_plain(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """K1's plain version: the polyphase formula on H, then on W."""
    return _up2_axis(_up2_axis(x, taps, 1), taps, 2)


def downsample2x_plain(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """K2's plain version: the polyphase formula on H, then on W."""
    return _down2_axis(_down2_axis(x, taps, 1), taps, 2)


def _launch(name: str, x: torch.Tensor, out: torch.Tensor,
            taps: np.ndarray, tag: str) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous (N, H, W, C) "
                         "tensor")
    lib = _build.build().lib
    N, H, W, C = x.shape
    t = [float(v) for v in taps]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"fir_{name}_f32")(
            x.data_ptr(), out.data_ptr(), N, H, W, C, *t, *t, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[tag] += 1
    return out


def _up(x: torch.Tensor, taps: np.ndarray, tag: str) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU one."""
    if x.device.type == "cpu":
        return upsample2x_plain(x, taps)
    N, H, W, C = x.shape
    out = torch.empty((N, 2 * H, 2 * W, C), dtype=x.dtype, device=x.device)
    return _launch("up2x", x, out, taps, tag)


def _down(x: torch.Tensor, taps: np.ndarray, tag: str) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU one."""
    if x.device.type == "cpu":
        return downsample2x_plain(x, taps)
    N, H, W, C = x.shape
    out = torch.empty((N, H // 2, W // 2, C), dtype=x.dtype, device=x.device)
    return _launch("down2x", x, out, taps, tag)


class _Up2x(torch.autograd.Function):
    """K1 forward; backward K2 with the taps reversed (the exact transpose)."""

    @staticmethod
    def forward(ctx, x, taps, tag):
        ctx.taps = taps
        return _up(x, taps, tag)

    @staticmethod
    def backward(ctx, g):
        return (_Down2x.apply(g.contiguous(), ctx.taps[::-1].copy(),
                              "down2x.bwd"), None, None)


class _Down2x(torch.autograd.Function):
    """K2 forward; backward K1 with the taps reversed (the exact transpose)."""

    @staticmethod
    def forward(ctx, x, taps, tag):
        ctx.taps = taps
        return _down(x, taps, tag)

    @staticmethod
    def backward(ctx, g):
        return (_Up2x.apply(g.contiguous(), ctx.taps[::-1].copy(),
                            "up2x.bwd"), None, None)


def _check(name: str, x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"{name}: expected (N, H, W, C), got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensor on {x.device}, expected cpu or cuda")


def upsample2x(x: torch.Tensor, k: Optional[Sequence[float]] = None,
               gain: float = 1.0) -> torch.Tensor:
    """FIR 2x upsample (N, H, W, C) -> (N, 2H, 2W, C); equals
    upsample_2d(x, k, factor=2, gain)."""
    _check("up2x", x)
    taps = _sep_kernel_1d(k, gain_per_axis=np.sqrt(gain) * 2.0)
    return _Up2x.apply(x, taps, "up2x")


def downsample2x(x: torch.Tensor, k: Optional[Sequence[float]] = None,
                 gain: float = 1.0) -> torch.Tensor:
    """FIR 2x downsample (N, H, W, C) -> (N, H/2, W/2, C), H and W even;
    equals downsample_2d(x, k, factor=2, gain)."""
    _check("down2x", x)
    N, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"down2x: H and W must be even, got {H}x{W}")
    taps = _sep_kernel_1d(k, gain_per_axis=np.sqrt(gain))
    return _Down2x.apply(x, taps, "down2x")


def _takes_kernel(x: torch.Tensor, k) -> bool:
    """The dispatch rule of the JAX package (_use_pallas and _seppable)."""
    even_4d = x.ndim == 4 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
    sep = k is None or (np.ndim(k) == 1 and 2 <= len(k) <= 4)
    return even_4d and sep


def fir_upsample_2x(x: torch.Tensor, k: Optional[Sequence[float]] = None,
                    gain: float = 1.0) -> torch.Tensor:
    """FIR 2x upsample: K1 where it applies, the general upfirdn2d else."""
    if _takes_kernel(x, k):
        return upsample2x(x, k, gain)
    return upsample_2d(x, k, factor=2, gain=gain)


def fir_downsample_2x(x: torch.Tensor, k: Optional[Sequence[float]] = None,
                      gain: float = 1.0) -> torch.Tensor:
    """FIR 2x downsample: K2 where it applies, the general upfirdn2d else."""
    if _takes_kernel(x, k):
        return downsample2x(x, k, gain)
    return downsample_2d(x, k, factor=2, gain=gain)

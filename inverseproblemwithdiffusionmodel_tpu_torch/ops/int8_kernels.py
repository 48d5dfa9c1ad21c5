"""The int8 convolution of the serving mode on hand-written CUDA kernels
(K5, K6, K7 in csrc/int8conv.cu, built by ops/_build.py).

No TPU kernel is replaced: the JAX package lowers its int8 convolution
through XLA (inverseproblemwithdiffusionmodel_tpu/ops/quant.py:82-120).
PyTorch has no s8 x s8 -> s32 convolution on a CUDA tensor, so the port
has these three kernels:

- `absmax` (K5): max |x| over the whole tensor, one float32 value;
- `quantize_s8` (K6): x (N, C, *spatial), contiguous, to int8 codes clip(round(x / scale), -127, 127) with scale = max(amax,
  1e-12) / 127, written channels-last (N, *spatial, Cp), the channels
  padded with zero codes to Cp, a multiple of 32;
- `conv_s8s8s32` (K7): the convolution of those codes with the weight
  codes (O, KH, KW, Cp) in int32, dequantized by scale * sw[o] and written
  channels-first (N, O, Ho, Wo) in float32 or bf16; optionally also the
  int32 sums.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its plain version (`absmax_plain`, `quantize_s8_plain`,
`conv_s8s8s32_plain`), which the kernels are held against bit for bit.
The plain convolution is a float64 convolution of the codes: exact, since
|sum| <= 127^2 K is far below 2^53; on the card it runs with cuDNN off, so
that no FFT or Winograd algorithm rounds it. Launches are counted in
`LAUNCHES` ("absmax", "quantize_s8", "conv_s8s8s32").
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES: collections.Counter = collections.Counter()

CHANNEL_ALIGN = 32     # Cp: the codes' channel count, a multiple of this
_EPS = 1e-12
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """One int8 convolution as K7 sees it: a 2-D convolution of an (N, H,
    W, Cp) image (a 1-D one is an image of height 1) with an (O, KH, KW,
    Cp) kernel, stride 1, zero padding pad_* before and pad_*_hi after."""
    N: int
    C: int
    H: int
    W: int
    O: int
    KH: int
    KW: int
    pad_h: int
    pad_h_hi: int
    pad_w: int
    pad_w_hi: int
    dil: int

    @property
    def Cp(self) -> int:
        return -(-self.C // CHANNEL_ALIGN) * CHANNEL_ALIGN

    @property
    def Ho(self) -> int:
        return self.H + self.pad_h + self.pad_h_hi - self.dil * (self.KH - 1)

    @property
    def Wo(self) -> int:
        return self.W + self.pad_w + self.pad_w_hi - self.dil * (self.KW - 1)

    def ops(self) -> int:
        """Multiply-adds times 2 over the true channels (C, not Cp)."""
        return 2 * self.N * self.Ho * self.Wo * self.O * self.C \
            * self.KH * self.KW


def exact_conv(t: torch.Tensor):
    """cuDNN off for a float64 convolution on the card, so that no FFT or
    Winograd algorithm rounds it; nothing on the CPU (the flag is global,
    so the CPU path leaves it alone)."""
    return (torch.backends.cudnn.flags(enabled=False) if t.is_cuda
            else contextlib.nullcontext())


def _guard(t: torch.Tensor):
    """A device guard only off the current device: it costs host time."""
    return (contextlib.nullcontext()
            if t.get_device() == torch.cuda.current_device()
            else torch.cuda.device(t.get_device()))


@functools.lru_cache(maxsize=None)
def _c_launcher(name: str):
    return getattr(_build.build().lib, name)


def _call(name: str, *args) -> None:
    rc = _c_launcher(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _check_float(name: str, x: torch.Tensor) -> str:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, expected cpu or cuda")
    return _SUFFIX[x.dtype]


# -- K5 ---------------------------------------------------------------------

def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """K5's plain version: max |x| as a float32 tensor of shape (1,)."""
    return x.float().abs().amax().reshape(1)


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the whole tensor, float32 (1,): K5 on a contiguous
    CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return absmax_plain(x)
    suffix = _check_float("absmax", x)
    if not x.is_contiguous():
        raise ValueError("absmax: the kernel takes a contiguous tensor")
    amax = torch.zeros(1, dtype=torch.float32, device=x.device)
    with _guard(x):
        _call(f"int8_absmax_{suffix}", x.data_ptr(), x.numel(),
              amax.data_ptr())
    LAUNCHES["absmax"] += 1
    return amax


# -- K6 ---------------------------------------------------------------------

def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """The symmetric scale max(amax, 1e-12) / 127, float32, by a true
    division. (A Python-number divisor would not do: on a CUDA tensor
    torch multiplies by its reciprocal instead, one ulp off the JAX
    package's scale for some amax.)"""
    amax = torch.clamp_min(amax.float(), _EPS)
    return amax / amax.new_full((), 127.0)


def quantize_s8_plain(x: torch.Tensor, amax: torch.Tensor, Cp: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: (codes (N, *spatial, Cp) int8, channels padded
    with 0, scale (1,) float32)."""
    scale = scale_of(amax)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    q = q.to(torch.int8).movedim(1, -1)
    q = F.pad(q, (0, Cp - q.shape[-1])) if Cp > q.shape[-1] else q
    return q.contiguous(), scale


def quantize_s8(x: torch.Tensor, amax: torch.Tensor, Cp: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, C, *spatial) -> (channels-last codes (N, *spatial, Cp) int8,
    scale (1,) float32), with amax from `absmax`: K6 on a CUDA tensor, the
    plain version on a CPU one."""
    if x.device.type == "cpu":
        return quantize_s8_plain(x, amax, Cp)
    suffix = _check_float("quantize_s8", x)
    if not x.is_contiguous():
        raise ValueError("quantize_s8: the kernel takes a contiguous x")
    N, C = x.shape[:2]
    if Cp % CHANNEL_ALIGN or Cp < C:
        raise ValueError(f"quantize_s8: Cp {Cp} must be a multiple of "
                         f"{CHANNEL_ALIGN} and at least C = {C}")
    if amax.dtype != torch.float32 or amax.device != x.device:
        raise ValueError("quantize_s8: amax must be a float32 tensor on x's "
                         "device")
    P = math.prod(x.shape[2:])
    codes = torch.empty((N,) + tuple(x.shape[2:]) + (Cp,), dtype=torch.int8,
                        device=x.device)
    scale = torch.empty(1, dtype=torch.float32, device=x.device)
    with _guard(x):
        _call(f"int8_quantize_{suffix}", x.data_ptr(), amax.data_ptr(),
              codes.data_ptr(), scale.data_ptr(), N, C, P, Cp)
    LAUNCHES["quantize_s8"] += 1
    return codes, scale


# -- K7 ---------------------------------------------------------------------

def conv_s8s8s32_plain(codes: torch.Tensor, scale: torch.Tensor,
                       kernel: torch.Tensor, sw: torch.Tensor,
                       geom: ConvGeometry, out_dtype: torch.dtype,
                       with_sums: bool = False):
    """K7's plain version: the float64 convolution of the codes, cast to
    int32, dequantized by scale * sw in float32 and rounded once to
    out_dtype. Returns out (N, O, Ho, Wo), and the int32 sums beside it
    with_sums."""
    g = geom
    x64 = codes.reshape(g.N, g.H, g.W, -1).permute(0, 3, 1, 2).double()
    x64 = F.pad(x64, (g.pad_w, g.pad_w_hi, g.pad_h, g.pad_h_hi))
    w64 = kernel.permute(0, 3, 1, 2).double()
    with exact_conv(x64):
        sums = F.conv2d(x64, w64, dilation=g.dil).to(torch.int32)
    out = (sums.float() * (scale * sw).reshape(1, -1, 1, 1)).to(out_dtype)
    return (out, sums) if with_sums else out


def conv_s8s8s32(codes: torch.Tensor, scale: torch.Tensor,
                 kernel: torch.Tensor, sw: torch.Tensor, geom: ConvGeometry,
                 out_dtype: torch.dtype, with_sums: bool = False):
    """The int8 convolution of channels-last codes (N, H, W, Cp) with the
    kernel's codes (O, KH, KW, Cp), dequantized to out_dtype (N, O, Ho,
    Wo): K7 on CUDA tensors, the plain version on CPU ones. with_sums also
    returns the int32 sums (N, O, Ho, Wo)."""
    if codes.device.type == "cpu":
        return conv_s8s8s32_plain(codes, scale, kernel, sw, geom, out_dtype,
                                  with_sums)
    g = geom
    if out_dtype not in _SUFFIX:
        raise TypeError(f"conv_s8s8s32: out_dtype float32 or bfloat16, got "
                        f"{out_dtype}")
    want = {"codes": (codes, torch.int8, (g.N, g.H, g.W, g.Cp)),
            "kernel": (kernel, torch.int8, (g.O, g.KH, g.KW, g.Cp)),
            "scale": (scale, torch.float32, (1,)),
            "sw": (sw, torch.float32, (g.O,))}
    for name, (t, dtype, shape) in want.items():
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != codes.device or not t.is_contiguous()):
            raise ValueError(f"conv_s8s8s32: {name} must be a contiguous "
                             f"{dtype} {shape} on {codes.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((g.N, g.O, g.Ho, g.Wo), dtype=out_dtype,
                      device=codes.device)
    sums = (torch.empty(out.shape, dtype=torch.int32, device=codes.device)
            if with_sums else None)
    with _guard(codes):
        _call(f"int8_conv_{_SUFFIX[out_dtype]}", codes.data_ptr(),
              kernel.data_ptr(), scale.data_ptr(), sw.data_ptr(),
              out.data_ptr(), None if sums is None else sums.data_ptr(), g.N,
              g.H, g.W, g.Cp, g.O, g.KH, g.KW, g.pad_h, g.pad_w, g.dil, g.Ho,
              g.Wo)
    LAUNCHES["conv_s8s8s32"] += 1
    return (out, sums) if with_sums else out

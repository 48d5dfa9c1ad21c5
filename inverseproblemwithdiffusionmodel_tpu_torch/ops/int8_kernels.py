"""The int8 convolution of the serving mode on hand-written CUDA kernels
(K5, K6, K7 in csrc/int8conv.cu, built by ops/_build.py).

No TPU kernel is replaced: the JAX package lowers its int8 convolution
through XLA (inverseproblemwithdiffusionmodel_tpu/ops/quant.py:82-120).
PyTorch has no s8 x s8 -> s32 convolution on a CUDA tensor, so the port
has these three kernels:

- `absmax` (K5): max |x| over the whole tensor, one float32 value, NaN
  where x holds a NaN (as jnp.max); one launch a call, one wave of
  blocks with eight 16-byte loads in flight a thread, the last block to
  finish reducing the partials; `absmax_plan` is its host-side plan;
- `quantize_s8` (K6, a tiled transpose through shared memory): x (N, C,
  *spatial), contiguous, to int8 codes clip(round(x / scale), -127, 127)
  with scale = max(amax, 1e-12) / 127 (NaN stays NaN), written
  channels-last (N, *spatial, Cp), the channels padded with zero codes to
  Cp, a multiple of 32; a NaN quotient (a non-finite scale) is code 0;
- `conv_s8s8s32` (K7): the convolution of those codes with the weight
  codes (O, KH, KW, Cp) in int32, dequantized by scale * sw[o] and written
  channels-first (N, O, Ho, Wo) in float32 or bf16; optionally also the
  int32 sums. A warp-specialised wgmma kernel fed by TMA im2col loads;
  `conv_plan` is its host-side plan per geometry (the template instance,
  the channel block and its swizzle, the im2col pixel box, the K stages,
  the ring), and a geometry it cannot map raises NotImplementedError,
  naming it.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its plain version (`absmax_plain`, `quantize_s8_plain`,
`conv_s8s8s32_plain`), which the kernels are held against bit for bit.
The plain convolution is a float64 convolution of the codes: exact, since
|sum| <= 127^2 K is far below 2^53; on the card it runs with cuDNN off, so
that no FFT or Winograd algorithm rounds it. A NaN anywhere in a
convolution's input makes its output NaN everywhere, and an inf (with no
NaN) too, as the JAX package's: the scale is NaN or inf, every code 0,
and 0 times it NaN. Launches are counted in `LAUNCHES` ("absmax",
"quantize_s8", "conv_s8s8s32").
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import threading
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

    def __str__(self) -> str:
        return (f"N={self.N} C={self.C} H={self.H} W={self.W} O={self.O} "
                f"k={self.KH}x{self.KW} pads (h {self.pad_h}, "
                f"{self.pad_h_hi}; w {self.pad_w}, {self.pad_w_hi}) "
                f"dil={self.dil}")


# K7's tile and the limits of its tensor maps (csrc/int8conv.cu)
BM = 128                    # output pixels per tile: two wgmma m64 halves
STAGE_K = 128               # bytes of K per stage: four wgmma K steps
BN_CHOICES = (8, 64, 128, 256)   # output channels per tile (template)
MAX_STAGES = 6              # the ring's depth (the kernel has 8 slots)
SMEM_HEAD = 3072            # mbarriers and scales, plus 1 KB of alignment
SMEM_ONE_BLOCK = 232448     # the most dynamic shared memory of a block
SMEM_TWO_BLOCKS = 115712    # each of two blocks on one SM (228 KB, 1 KB each
                            # reserved)
IM2COL_CORNER = (-128, 127)  # a rank-4 im2col map's pixel box corners
IM2COL_OFFSET_MAX = 255      # and a load's im2col offsets (8 bits each)


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """K7's launch at one geometry. A tile is BM output pixels (in (N, Ho,
    Wo) order, so it may cross images) by `bn` output channels. The K loop
    runs tap-major in TMA box pairs of `cb` channels (bytes), one tap and
    cb channels each, STAGE_K / cb of them to a stage of the ring (the
    last stage's spare pairs load zeros of B). A comes from a rank-4 TMA
    im2col map of the codes (C, W, H, N innermost first): the pixel box
    runs from `lower` to (W - 1, H - 1) + `upper` ((w, h) pairs, tensor
    coordinates), so output pixel (ho, wo) starts at (wo + lower[0],
    ho + lower[1]), and tap (ky, kx) adds its im2col offset (kx dil,
    ky dil); outside the image the TMA fills zeros. The epilogue stores
    runs of up to `run` pixels of one channel (a power of 2 dividing
    Ho Wo, at most 8: 16 bytes of bf16; 4 for float32).

    The plan is the one owner of K7's tiling: `conv_launch_args` hands
    every field to csrc/int8conv.cu's launcher, which takes them as they
    are and only checks that the kernel's instance and buffers hold
    them."""
    bn: int
    cb: int              # channels (bytes) per TMA box: 128, 64 or 32,
                         # each box row in the cb-byte swizzle
    chunks: int          # box pairs: KH KW Cp / cb
    k_iters: int         # stages per tile: chunks / (STAGE_K / cb), up
    stages: int          # ring depth
    blocks_per_sm: int
    lower: Tuple[int, int]
    upper: Tuple[int, int]
    m_tiles: int
    o_tiles: int
    stage_bytes: int
    smem_bytes: int
    run: int


@functools.lru_cache(maxsize=None)
def conv_plan(g: ConvGeometry) -> ConvPlan:
    """K7's plan at geometry g, or NotImplementedError naming g where its
    tensor maps cannot express it."""
    def refuse(why: str):
        raise NotImplementedError(f"conv_s8s8s32: the wgmma kernel does not "
                                  f"take {g}: {why}")

    if g.Ho <= 0 or g.Wo <= 0:
        refuse(f"output {g.Ho}x{g.Wo}")
    bn = next((b for b in BN_CHOICES if g.O <= b), BN_CHOICES[-1])
    Cp = g.Cp
    cb = 128 if Cp % 128 == 0 else 64 if Cp % 64 == 0 else 32
    lower = (-g.pad_w, -g.pad_h)
    upper = (g.pad_w_hi - (g.KW - 1) * g.dil, g.pad_h_hi - (g.KH - 1) * g.dil)
    lo, hi = IM2COL_CORNER
    if not all(lo <= v <= hi for v in lower + upper):
        refuse(f"pixel box corners {lower}, {upper} outside [{lo}, {hi}]")
    offset = (max(g.KH, g.KW) - 1) * g.dil   # the last tap's im2col offset
    if offset > IM2COL_OFFSET_MAX:
        refuse(f"im2col offset {offset} past {IM2COL_OFFSET_MAX}")
    M = g.N * g.Ho * g.Wo
    if M >= 2 ** 31 or g.N * g.H * g.W * Cp >= 2 ** 40:
        refuse(f"{M} output pixels")
    m_tiles = -(-M // BM)
    blocks = 1 if bn == 256 else 2
    stage_bytes = -(-(BM + bn) * STAGE_K // 1024) * 1024
    budget = (SMEM_ONE_BLOCK if blocks == 1 else SMEM_TWO_BLOCKS) - SMEM_HEAD
    stages = min(MAX_STAGES, budget // stage_bytes)
    chunks = g.KH * g.KW * Cp // cb
    hw = g.Ho * g.Wo
    return ConvPlan(
        bn=bn, cb=cb, chunks=chunks, k_iters=-(-chunks // (STAGE_K // cb)),
        stages=stages, blocks_per_sm=blocks, lower=lower, upper=upper,
        m_tiles=m_tiles, o_tiles=-(-g.O // bn),
        stage_bytes=stage_bytes,
        # the epilogue's float32 tile, rows BM + 4 floats apart, reuses the
        # ring
        smem_bytes=SMEM_HEAD + max(stages * stage_bytes, bn * (BM + 4) * 4),
        run=min(8, hw & -hw))


def conv_launch_args(g: ConvGeometry, out_dtype: torch.dtype
                     ) -> Tuple[int, ...]:
    """The integers K7's C launcher takes after its pointers
    (_build._ARGTYPES): the geometry, then conv_plan(g), the epilogue's run
    cut to 16 bytes of out_dtype."""
    p = conv_plan(g)
    run = min(p.run, 16 // (torch.finfo(out_dtype).bits // 8))
    return (g.N, g.H, g.W, g.Cp, g.O, g.KH, g.KW, g.dil, g.Ho, g.Wo, p.bn,
            p.cb, p.chunks, p.k_iters, p.stages, p.blocks_per_sm,
            p.stage_bytes, p.m_tiles, p.o_tiles, run, *p.lower, *p.upper,
            p.smem_bytes)


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


# csrc/int8conv.cu's codes past the CUDA runtime's errors
_LAUNCH_ERRORS = ((5000, "a plan the launcher does not take"),
                  (4000, "no kernel instance for the plan's bn"),
                  (3000, "the driver's tensor-map encoders not found"),
                  (2000, "cuTensorMapEncodeTiled (B) failed with CUresult"),
                  (1000, "cuTensorMapEncodeIm2col (A) failed with CUresult"))


def _call(name: str, *args) -> None:
    rc = _c_launcher(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc == 0:
        return
    for base, what in _LAUNCH_ERRORS:
        if rc >= base:
            raise RuntimeError(f"{name}: {what}"
                               + (f" {rc - base}" if base < 3000 else ""))
    raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def _check_float(name: str, x: torch.Tensor) -> str:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor on {x.device}, expected cpu or cuda")
    return _SUFFIX[x.dtype]


# -- K5 ---------------------------------------------------------------------

# K5's launch: the numbers of csrc/int8conv.cu's K5_THREADS, K5_UNROLL and
# K5_BLOCKS_PER_SM (its launch bounds)
K5_THREADS = 256
K5_UNROLL = 8               # 16-byte loads in flight a thread
K5_BLOCKS_PER_SM = 8        # 2,048 threads an SM


@dataclasses.dataclass(frozen=True)
class AbsmaxPlan:
    """K5's launch for one tensor. x is `head` elements up to its first
    16-byte boundary (scalar loads, block 0), a body of `body_bytes` (a
    multiple of 16) read as 16-byte vectors, and `tail` elements after it
    (scalar loads, block 0). Thread g of the grid's G = blocks x
    K5_THREADS reads vectors g, g + G, ..., K5_UNROLL loads in flight at a
    time. `scratch_words` are the ticket and one partial per block.

    The plan is the one owner of these numbers: `absmax_launch_args`
    hands them to csrc/int8conv.cu's launcher, which takes them as they
    are and only checks that they cover x."""
    blocks: int
    head: int
    body_bytes: int
    tail: int
    scratch_words: int


@functools.lru_cache(maxsize=4096)
def absmax_plan(n: int, dtype: torch.dtype, ptr_offset: int,
                sm_count: int) -> AbsmaxPlan:
    """K5's plan for n elements of dtype starting `ptr_offset` bytes past a
    16-byte boundary, on a card of `sm_count` SMs. One wave, for speed: at
    most K5_BLOCKS_PER_SM blocks on each SM, fewer where x is small, as
    many as give each thread one round of K5_UNROLL loads."""
    if dtype not in _SUFFIX:
        raise TypeError(f"absmax: the kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    size = torch.finfo(dtype).bits // 8
    if n < 1 or ptr_offset % size or not 0 <= ptr_offset < 16:
        raise ValueError(f"absmax: no plan for {n} elements at offset "
                         f"{ptr_offset} (element size {size})")
    head = min(n, (16 - ptr_offset) % 16 // size)
    body_bytes = (n - head) * size // 16 * 16
    blocks = max(1, min(sm_count * K5_BLOCKS_PER_SM,
                        -(-body_bytes // (16 * K5_UNROLL * K5_THREADS))))
    return AbsmaxPlan(blocks=blocks, head=head, body_bytes=body_bytes,
                      tail=n - head - body_bytes // size,
                      scratch_words=1 + blocks)


def absmax_launch_args(p: AbsmaxPlan) -> Tuple[int, ...]:
    """The plan's integers that K5's C launcher takes after its pointers
    (_build._ARGTYPES); the scratch's size in words follows them."""
    return (p.head, p.body_bytes, p.tail, p.blocks)


# Per device: (its SM count, K5's ticket and partials). The scratch is
# made zero at the device's first call; the ticket wraps back to zero at
# each launch's last draw (atomicInc). The lock makes one scratch a
# device where shards on threads of their own make the first calls.
_ABSMAX_DEVICE = {}
_ABSMAX_LOCK = threading.Lock()


def _absmax_device(index: int) -> Tuple[int, torch.Tensor]:
    """The device's SM count and K5 scratch, made at its first call, which
    must not fall inside a CUDA-graph capture (the zero fill would be
    captured with the graph, and replayed). Every K5 call on the device
    shares it (see `absmax`)."""
    with _ABSMAX_LOCK:
        found = _ABSMAX_DEVICE.get(index)
        if found is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "absmax: the first call on a device must come before "
                    "any CUDA-graph capture (it allocates and zeroes K5's "
                    "ticket); call it once outside the capture")
            sms = torch.cuda.get_device_properties(
                index).multi_processor_count
            found = (sms, torch.zeros(1 + sms * K5_BLOCKS_PER_SM,
                                      dtype=torch.int32,
                                      device=f"cuda:{index}"))
            _ABSMAX_DEVICE[index] = found
    return found


def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """K5's plain version: max |x| as a float32 tensor of shape (1,); a NaN
    anywhere makes it NaN, as jnp.max does."""
    return x.float().abs().amax().reshape(1)


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max |x| over the whole tensor, float32 (1,), NaN where x holds a NaN:
    K5 (one launch, no fill) on a contiguous CUDA tensor, the plain version
    on a CPU one.

    K5 must not run on two streams of one device at once. Every call on a
    device shares one ticket and one array of partials (`_absmax_device`),
    so two calls in flight together mix their partials, the wrong block can
    draw the last ticket, and amax comes out wrong with no error. The
    ticket wraps to 0 at each launch's last draw (atomicInc), so a ticket
    left over spoils no more than the next call. The port launches it on
    one stream a device: an engine's shards, each on a thread of its own,
    on the caller's current stream of their device (samplers/ald_pair.
    ShardedReconstructor), so two shards on one card take turns on it; a
    CUDA graph's replays in order on the graph's stream."""
    if x.device.type == "cpu":
        return absmax_plain(x)
    suffix = _check_float("absmax", x)
    if not x.is_contiguous():
        raise ValueError("absmax: the kernel takes a contiguous tensor")
    with _guard(x):
        sms, scratch = _absmax_device(x.get_device())
        plan = absmax_plan(x.numel(), x.dtype, x.data_ptr() % 16, sms)
        amax = torch.empty(1, dtype=torch.float32, device=x.device)
        _call(f"int8_absmax_{suffix}", x.data_ptr(), amax.data_ptr(),
              scratch.data_ptr(), *absmax_launch_args(plan),
              scratch.numel())
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
    args = conv_launch_args(g, out_dtype)
    out = torch.empty((g.N, g.O, g.Ho, g.Wo), dtype=out_dtype,
                      device=codes.device)
    sums = (torch.empty(out.shape, dtype=torch.int32, device=codes.device)
            if with_sums else None)
    with _guard(codes):
        _call(f"int8_conv_{_SUFFIX[out_dtype]}", codes.data_ptr(),
              kernel.data_ptr(), scale.data_ptr(), sw.data_ptr(),
              out.data_ptr(), None if sums is None else sums.data_ptr(),
              *args)
    LAUNCHES["conv_s8s8s32"] += 1
    return (out, sums) if with_sums else out

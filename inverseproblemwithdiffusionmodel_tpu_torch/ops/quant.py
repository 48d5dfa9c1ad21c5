"""int8 convolutions: the score nets' serving mode.

Port of inverseproblemwithdiffusionmodel_tpu/ops/quant.py:

- weights: symmetric per-output-channel int8, scale = amax / 127 over each
  output channel (`quantize_per_channel`; the port's weights are (O, I,
  *k), so the amax runs over every axis but the first, where JAX's (*k, I,
  O) kernels take every axis but the last), made once per score function
  (`QuantWeight`), as XLA hoists the JAX form out of the sampler's scan;
- activations: symmetric per-tensor int8 with a dynamic scale over the
  whole tensor, the batch included (`quantize_per_tensor`): the chains and
  the Re / Im halves of a request share one scale. Where a batch is split
  over the shards of a mesh, each run on a thread of its own, the shards
  meet at every int8 convolution and take the scale of the whole batch
  (`ScaleGroup`), as JAX's max over a sharded array does;
- the sum in int32, dequantized by the product of the two scales to x's
  dtype (`int8_conv`).

The rounding is the JAX package's: scale = max(amax, 1e-12) / 127 in
float32 and code = clip(round_half_even(x / scale), -127, 127), both by
true divisions (`int8_kernels.scale_of`), the output f32(sum) * (sx * sw[o]) rounded once to x's dtype.
Padding zeros come after the quantization and do not move amax.

`int8_conv` runs K5 (absmax), K6 (quantize_s8) and K7 (conv_s8s8s32) of
ops/int8_kernels.py: on a CUDA tensor the kernels, on a CPU tensor their
plain versions. K7 covers the served nets' convolutions: kernel size 1
and 3, stride 1, dilation 1, 2 and 4, symmetric padding plus `pre_pad`,
ndim 1 and 2, where its plan maps. Any other geometry (the 3-D temporal
prior's strided (1, 1, 4) convolution among them) takes
`int8_conv_unfold`: K5 and K6 as before, then the s8 x s8 -> s32 product
as an unfold of the codes and one integer matmul (`torch._int_mm` on the
card; the JAX package computes it as an XLA convolution, no TPU
kernel), dequantized as K7 does; bit for bit `int8_conv_plain`, the whole
op in one float64 convolution of the codes.

`models/layers.Conv` switches to this path per module (`enable_int8`, which
`models/registry.make_score_fn(..., "int8")` applies to its copy of the
score net only). Inference only: the codes carry no gradient, as JAX's
round has none.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import int8_kernels as ik

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
KERNEL_SIZES = (1, 3)
DILATIONS = (1, 2, 4)
UNFOLD_BYTES = 2 ** 30     # int8_conv_unfold's im2col rows at a time


def quantize_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """x -> (int8 codes of x's shape, float32 scalar scale): symmetric,
    dynamic, one scale for the whole tensor."""
    x32 = x.float()
    scale = ik.scale_of(x32.abs().amax())
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


class ScaleGroup:
    """The n shards of one batch, each run on a thread of its own, that
    quantize every activation with one scale: JAX's scale of the whole
    batch, the max over the shards of absmax(x_shard). At each int8
    convolution every shard puts its K5 result in its slot and waits for
    the others (a barrier); each then takes the max of all the slots,
    copied to its device: the scale stays on the devices, never read back
    to the host. A NaN in any shard makes the scale NaN, as jnp.max over
    the sharded array does. The slots come in two rows taken in turn, so
    that a shard through one meeting may fill its slot for the next while
    the others still read. The shards must make the same int8 calls in
    the same order (one net, equal blocks of the batch)."""

    def __init__(self, n: int):
        self.n = n
        self._barrier = threading.Barrier(n)
        self._slots = [[None] * n, [None] * n]

    @contextlib.contextmanager
    def member(self, index: int):
        """The calling thread's int8 convolutions as shard `index`'s. A
        failure breaks the barrier, so that the other shards raise rather
        than wait."""
        _SHARD.member = (self, index, [0])
        try:
            yield
        except BaseException:
            self._barrier.abort()
            raise
        finally:
            _SHARD.member = None

    def _meet(self, index: int, call: int, amax: torch.Tensor
              ) -> torch.Tensor:
        slots = self._slots[call % 2]
        slots[index] = amax
        self._barrier.wait()
        return torch.stack([s.to(amax.device) for s in slots]).amax(0)


_SHARD = threading.local()


def batch_absmax(x: torch.Tensor) -> torch.Tensor:
    """K5's max |x| (`int8_kernels.absmax`), over the whole batch where the
    calling thread runs a shard of it (`ScaleGroup.member`)."""
    amax = ik.absmax(x)
    member = getattr(_SHARD, "member", None)
    if member is None:
        return amax
    group, index, calls = member
    calls[0] += 1
    return group._meet(index, calls[0], amax)


def quantize_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(O, I, *k) weight -> (int8 codes, float32 scale (O,)): symmetric,
    q = round(w / s[o]), s[o] = max |w[o]| / 127."""
    w32 = w.float()
    scale = ik.scale_of(w32.abs().amax(dim=tuple(range(1, w.ndim))))
    q = torch.clamp(torch.round(w32 / scale.reshape(-1, *[1] * (w.ndim - 1))),
                    -127, 127).to(torch.int8)
    return q, scale


@dataclasses.dataclass(frozen=True)
class QuantWeight:
    """A convolution weight quantized once: its codes (O, I, *k) and scales
    (O,), and the codes in K7's layout (O, KH, KW, Cp), channels innermost
    and padded with zero codes to a multiple of 32 (KH = 1 for a 1-D
    kernel). Not made for rank 3, which K7 does not take."""
    codes: torch.Tensor
    scale: torch.Tensor
    kernel: Optional[torch.Tensor]

    @classmethod
    def of(cls, weight: torch.Tensor) -> "QuantWeight":
        with torch.no_grad():
            codes, scale = quantize_per_channel(weight.detach())
        kernel = None
        if codes.ndim in (3, 4):
            k = codes if codes.ndim == 4 else codes.unsqueeze(2)
            cp = -(-k.shape[1] // ik.CHANNEL_ALIGN) * ik.CHANNEL_ALIGN
            k = k.permute(0, 2, 3, 1)
            kernel = F.pad(k, (0, cp - k.shape[-1])).contiguous()
        return cls(codes, scale, kernel)

    def to(self, device) -> "QuantWeight":
        move = lambda t: None if t is None else t.to(device)
        return QuantWeight(move(self.codes), move(self.scale),
                           move(self.kernel))


def _pads(padding: int, pre_pad: Optional[Sequence[int]]):
    lo = hi = int(padding)
    if pre_pad is not None:
        lo, hi = lo + int(pre_pad[0]), hi + int(pre_pad[1])
    return lo, hi


def kernel_refusal(x: torch.Tensor, qw: QuantWeight, stride: int,
                   dilation: int, ndim: int) -> Optional[str]:
    """Why K7 does not take this convolution, or None where it does."""
    k = qw.codes.shape[2:]
    if ndim not in (1, 2) or x.ndim != ndim + 2:
        return f"ndim {ndim} (x {tuple(x.shape)})"
    if stride != 1:
        return f"stride {stride}"
    if dilation not in DILATIONS:
        return f"dilation {dilation}"
    if len(set(k)) != 1 or k[0] not in KERNEL_SIZES:
        return f"kernel size {tuple(k)}"
    return None


def geometry(x: torch.Tensor, qw: QuantWeight, padding: int, dilation: int,
             ndim: int, pre_pad=None) -> ik.ConvGeometry:
    """K7's view of a stride-1 convolution of x (N, C, *spatial), ndim 1
    or 2."""
    O, I = qw.codes.shape[:2]
    if x.shape[1] != I:
        raise ValueError(f"int8_conv: x has {x.shape[1]} channels, the "
                         f"weight {I}")
    lo, hi = _pads(padding, pre_pad)
    k = qw.codes.shape[-1]
    if ndim == 1:
        return ik.ConvGeometry(N=x.shape[0], C=I, H=1, W=x.shape[2], O=O,
                               KH=1, KW=k, pad_h=0, pad_h_hi=0, pad_w=lo,
                               pad_w_hi=hi, dil=dilation)
    return ik.ConvGeometry(N=x.shape[0], C=I, H=x.shape[2], W=x.shape[3],
                           O=O, KH=k, KW=k, pad_h=lo, pad_h_hi=hi, pad_w=lo,
                           pad_w_hi=hi, dil=dilation)


def int8_conv_plain(x: torch.Tensor, weight: Union[torch.Tensor,
                                                   QuantWeight], *,
                    stride: int = 1, padding: int = 0, dilation: int = 1,
                    ndim: int = 2, pre_pad=None) -> torch.Tensor:
    """The whole op's plain version, any rank and stride: both operands
    quantized, one float64 convolution of the codes (exact), cast to int32,
    dequantized by the scales' product, rounded once to x's dtype."""
    qw = weight if isinstance(weight, QuantWeight) else QuantWeight.of(
        weight)
    xq, sx = quantize_per_tensor(x)
    lo, hi = _pads(padding, pre_pad)
    x64 = F.pad(xq.double(), (lo, hi) * ndim)
    with ik.exact_conv(x64):
        sums = _CONV[ndim](x64, qw.codes.to(x.device).double(),
                           stride=stride, dilation=dilation).to(torch.int32)
    scale = (sx * qw.scale.to(x.device)).reshape(-1, *[1] * ndim)
    return (sums.float() * scale).to(x.dtype)


def _int_mm_s32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> int32 (M, N), exact: torch._int_mm
    (cuBLASLt) on a CUDA tensor, with M, K and N padded by zero rows to
    what it takes (M > 16, K and N multiples of 8); a float64 matmul
    (exact: |sum| <= 127^2 K) on a CPU one."""
    if a.device.type == "cpu":
        return (a.double() @ b.double()).to(torch.int32)
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(-(-M // 8) * 8, 24), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    # cuBLASLt takes the right operand column-major: b as the transpose
    # of a contiguous (Np, Kp)
    bt = F.pad(b.t(), (0, Kp - K, 0, Np - N)).contiguous()
    return torch._int_mm(a.contiguous(), bt.t())[:M, :N]


def _unfold_codes(codes: torch.Tensor, k: Sequence[int], stride: int,
                  dilation: int, lo: int, hi: int) -> torch.Tensor:
    """Channels-last codes (N, *spatial, Cp) -> the im2col rows (N
    prod(out), prod(k) Cp), at any rank: each spatial axis padded with
    zero codes by (lo, hi), then unfolded into its windows."""
    nd = len(k)
    x = F.pad(codes, (0, 0) + (lo, hi) * nd)
    for axis, kk in enumerate(k):
        span = dilation * (kk - 1) + 1
        # (N, o1.., Cp, w1..): the window of axis `axis` appended last
        x = x.unfold(1 + axis, span, stride)[..., ::dilation]
    # (N, *out, Cp, *k) -> (N, *out, *k, Cp)
    x = x.movedim(1 + nd, -1)
    rows = math.prod(x.shape[1:1 + nd])
    return x.reshape(x.shape[0] * rows, -1), tuple(x.shape[1:1 + nd])


def int8_conv_unfold(x: torch.Tensor, qw: QuantWeight, *, stride: int = 1,
                     padding: int = 0, dilation: int = 1, ndim: int = 2,
                     pre_pad=None) -> torch.Tensor:
    """The int8 convolution at any rank, stride, dilation and kernel: the
    activation quantized by K5 (`batch_absmax`) and K6 (their plain
    versions on the CPU)
    into channels-last codes, unfolded (`_unfold_codes`, a block of
    samples at a time, at most UNFOLD_BYTES of rows), multiplied with the
    weight codes in int32 (`_int_mm_s32`), dequantized by scale *
    sw[o] in float32 and rounded once to x's dtype, as K7 does. Bit for
    bit `int8_conv_plain`."""
    if qw.codes.device != x.device:
        qw = qw.to(x.device)
    O, C = qw.codes.shape[:2]
    if x.shape[1] != C:
        raise ValueError(f"int8_conv: x has {x.shape[1]} channels, the "
                         f"weight {C}")
    cp = -(-C // ik.CHANNEL_ALIGN) * ik.CHANNEL_ALIGN
    x = x.contiguous()
    codes, sx = ik.quantize_s8(x, batch_absmax(x), cp)
    lo, hi = _pads(padding, pre_pad)
    k = tuple(qw.codes.shape[2:])
    w = F.pad(qw.codes.movedim(1, -1), (0, cp - C)).reshape(O, -1)
    # the im2col rows are prod(k) times the codes: at most UNFOLD_BYTES of
    # them at a time, a block of samples each
    per_sample = math.prod(k) * cp * math.prod(
        (n + lo + hi - dilation * (kk - 1) - 1) // stride + 1
        for n, kk in zip(x.shape[2:], k))
    block = max(1, UNFOLD_BYTES // per_sample)
    parts = []
    for n0 in range(0, x.shape[0], block):
        a, out = _unfold_codes(codes[n0:n0 + block], k, stride, dilation,
                               lo, hi)
        parts.append(_int_mm_s32(a, w.t()).reshape(-1, *out, O))
    sums = torch.cat(parts).movedim(-1, 1)
    scale = (sx * qw.scale).reshape(-1, *[1] * ndim)
    return (sums.float() * scale).to(x.dtype)


def int8_conv(x: torch.Tensor, weight: Union[torch.Tensor, QuantWeight], *,
              stride: int = 1, padding: int = 0, dilation: int = 1,
              ndim: int = 2, pre_pad=None) -> torch.Tensor:
    """The int8 convolution of x (N, C, *spatial), channels first, with a
    weight (O, C, *k) or its QuantWeight: both quantized, summed in int32,
    dequantized to x's dtype (N, O, *spatial_out). `padding` zeros on each
    side and `pre_pad` (lo, hi) more on every axis. K5, K6 and K7 where K7
    takes the geometry, else `int8_conv_unfold`; on a CPU tensor their
    plain versions."""
    qw = weight if isinstance(weight, QuantWeight) else QuantWeight.of(
        weight)
    g = None
    if kernel_refusal(x, qw, stride, dilation, ndim) is None:
        g = geometry(x, qw, padding, dilation, ndim, pre_pad)
        if x.device.type != "cpu":
            try:
                ik.conv_plan(g)        # raises where K7's plan cannot map g
            except NotImplementedError:
                g = None
    if g is None:
        return int8_conv_unfold(x, qw, stride=stride, padding=padding,
                                dilation=dilation, ndim=ndim,
                                pre_pad=pre_pad)
    if qw.kernel.device != x.device:
        qw = qw.to(x.device)
    x = x.contiguous()
    codes, sx = ik.quantize_s8(x, batch_absmax(x), g.Cp)
    codes = codes.reshape(g.N, g.H, g.W, g.Cp)     # 1-D: height 1
    out = ik.conv_s8s8s32(codes, sx, qw.kernel, qw.scale, g, x.dtype)
    return out.reshape(out.shape[:2] + out.shape[4 - ndim:])


def enable_int8(net: torch.nn.Module) -> torch.nn.Module:
    """Switch every models.layers.Conv of `net` to the int8 path in place,
    quantizing each weight once, as it stands (cast the net first: the JAX
    package quantizes the bf16-cast weights). Returns net."""
    from ..models.layers import Conv
    for module in net.modules():
        if isinstance(module, Conv):
            module.quant = QuantWeight.of(module.weight)
    return net

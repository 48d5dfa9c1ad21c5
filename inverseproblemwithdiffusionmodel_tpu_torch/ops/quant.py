"""int8 convolutions: the score nets' serving mode.

Port of inverseproblemwithdiffusionmodel_tpu/ops/quant.py:

- weights: symmetric per-output-channel int8, scale = amax / 127 over each
  output channel (`quantize_per_channel`; the port's weights are (O, I,
  *k), so the amax runs over every axis but the first, where JAX's (*k, I,
  O) kernels take every axis but the last), made once per score function
  (`QuantWeight`), as XLA hoists the JAX form out of the sampler's scan;
- activations: symmetric per-tensor int8 with a dynamic scale over the
  whole tensor, the batch included (`quantize_per_tensor`): the chains and
  the Re / Im halves of a request share one scale, so the int8 path never
  splits a batch;
- the sum in int32, dequantized by the product of the two scales to x's
  dtype (`int8_conv`).

The rounding is the JAX package's: scale = max(amax, 1e-12) / 127 in
float32 and code = clip(round_half_even(x / scale), -127, 127), both by
true divisions (`int8_kernels.scale_of`), the output f32(sum) * (sx * sw[o]) rounded once to x's dtype.
Padding zeros come after the quantization and do not move amax.

`int8_conv` runs K5 (absmax), K6 (quantize_s8) and K7 (conv_s8s8s32) of
ops/int8_kernels.py: on a CUDA tensor the kernels, on a CPU tensor their
plain versions. K7 covers the score nets' convolutions: kernel size 1 and
3, stride 1, dilation 1, 2 and 4, symmetric padding plus `pre_pad`, ndim 1
and 2; on the card any other geometry raises NotImplementedError, naming
it, and nothing falls back to the plain version. On the CPU such a
geometry runs `int8_conv_plain`, the whole op in one float64 convolution
of the codes.

`models/layers.Conv` switches to this path per module (`enable_int8`, which
`models/registry.make_score_fn(..., "int8")` applies to its copy of the
score net only). Inference only: the codes carry no gradient, as JAX's
round has none.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import int8_kernels as ik

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
KERNEL_SIZES = (1, 3)
DILATIONS = (1, 2, 4)


def quantize_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """x -> (int8 codes of x's shape, float32 scalar scale): symmetric,
    dynamic, one scale for the whole tensor."""
    x32 = x.float()
    scale = ik.scale_of(x32.abs().amax())
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


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


def int8_conv(x: torch.Tensor, weight: Union[torch.Tensor, QuantWeight], *,
              stride: int = 1, padding: int = 0, dilation: int = 1,
              ndim: int = 2, pre_pad=None) -> torch.Tensor:
    """The int8 convolution of x (N, C, *spatial), channels first, with a
    weight (O, C, *k) or its QuantWeight: both quantized, summed in int32,
    dequantized to x's dtype (N, O, *spatial_out). `padding` zeros on each
    side and `pre_pad` (lo, hi) more on every axis. On a CUDA tensor K5,
    K6 and K7, or NotImplementedError where K7 does not take the geometry;
    on a CPU tensor their plain versions (int8_conv_plain where K7 would
    refuse)."""
    qw = weight if isinstance(weight, QuantWeight) else QuantWeight.of(
        weight)
    refusal = kernel_refusal(x, qw, stride, dilation, ndim)
    if refusal is not None:
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"int8_conv: the s8 x s8 -> s32 kernel does not take "
                f"{refusal}; it takes kernel size {KERNEL_SIZES}, stride 1, "
                f"dilation {DILATIONS}, ndim 1 or 2")
        return int8_conv_plain(x, qw, stride=stride, padding=padding,
                               dilation=dilation, ndim=ndim, pre_pad=pre_pad)
    if qw.kernel.device != x.device:
        qw = qw.to(x.device)
    g = geometry(x, qw, padding, dilation, ndim, pre_pad)
    if x.device.type != "cpu":
        ik.conv_plan(g)      # a geometry K7 cannot map raises before K5
    x = x.contiguous()
    codes, sx = ik.quantize_s8(x, ik.absmax(x), g.Cp)
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

"""Activations and the NCSN (RefineNet-family) building blocks, NCHW, NCT
or NCDHW.

Port of inverseproblemwithdiffusionmodel_tpu/models/layers.py: `get_act`,
`centered_input`, `Conv` (dilation, `pre_pad`), `conv1x1` / `conv3x3`,
`ConvTranspose`, the pools and `nearest_up_2x`, CRP / RCU / MSF /
RefineBlock, ConvMeanPool, MeanPoolConv, UpsampleConv, ResidualBlock and
ConditionalResidualBlock (reference:
ncsn/models/layers.py, layers1d.py, layers3d.py). As in the JAX package
every block takes `ndim`, the number of spatial axes: 2 for images, 1 for
the temporal prior's pixel tubes, 3 for the 2D+time volumes of
models/ncsn3d.py; the pools follow the rank of their input. The JAX
package is channel-last; these blocks are channels-first, torch's and
cuDNN's own layout, and take their input widths at construction.
Submodules carry the names Flax gives them (`Conv_0`, `ConvMeanPool_1`,
`adapt_0`, `norm1`, ...), so a Flax parameter tree maps onto the state
dict leaf by leaf (utils/convert.py). Torch's default init,
U(+-1/sqrt(fan_in)) for weights and biases, is the JAX package's
`torch_kernel_init`.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import int8_conv


def get_act(config) -> Callable[[torch.Tensor], torch.Tensor]:
    name = config.model.nonlinearity.lower()
    if name == "elu":
        return F.elu
    if name == "relu":
        return F.relu
    if name == "lrelu":
        return functools.partial(F.leaky_relu, negative_slope=0.2)
    if name == "swish":
        return F.silu
    raise NotImplementedError("activation function does not exist!")


def centered_input(config) -> bool:
    """Whether inputs already live in [-1, 1] (the net then skips its
    `2x - 1`): `data.centered` in the continuous configs,
    `data.logit_transform or data.rescaled` in the discrete ones."""
    data = config.data
    if hasattr(data, "centered"):
        return bool(data.centered)
    return bool(data.logit_transform or data.rescaled)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


class Conv(nn.Module):
    """N-D convolution (ndim 1, 2 or 3), symmetric padding (kernel_size // 2
    * dilation by default), optional extra zero padding `pre_pad` = (lo,
    hi) per axis. Weight (O, I, *k) and bias (O,), drawn as torch's
    nn.Conv2d draws them, U(+-1/sqrt(fan_in)).

    `quant`, None by default, holds the weight quantized by
    ops/quant.enable_int8: the conv then runs ops/quant.int8_conv (the JAX
    Conv under quantized_convs("int8")) and adds the bias after the
    dequantization, in x's dtype.

    `tp`, None by default, holds the weight's slices over a mesh's model
    axis (parallel/tp.Split) where parallel.shard_tp split it; the weight
    is None then, and the conv is column-parallel. A weight passed in its
    place (torch.func.functional_call) takes the plain path."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: Optional[int] = None,
                 dilation: int = 1, use_bias: bool = True,
                 pre_pad: Optional[Tuple[int, int]] = None, ndim: int = 2):
        super().__init__()
        k = kernel_size
        self.padding = padding if padding is not None else (
            (k // 2) * dilation if k > 1 else 0)
        self.stride, self.dilation, self.pre_pad = stride, dilation, pre_pad
        self.in_channels, self.out_channels = in_features, features
        self.ndim = ndim
        self.quant = None
        self.tp = None
        self.weight = nn.Parameter(torch.empty((features, in_features)
                                               + (k,) * ndim))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        bound = 1.0 / math.sqrt(in_features * k ** ndim)
        with torch.no_grad():
            for p in (self.weight, self.bias):
                if p is not None:
                    p.uniform_(-bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is not None:
            out = int8_conv(x, self.quant, stride=self.stride,
                            padding=self.padding, dilation=self.dilation,
                            ndim=self.ndim, pre_pad=self.pre_pad)
            if self.bias is None:
                return out
            return out + self.bias.reshape(-1, *[1] * self.ndim)
        if self.weight is None:
            return self.tp.forward(x, self._conv, self.bias)
        return self._conv(x, self.weight, self.bias)

    def _conv(self, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.pre_pad is not None:
            x = F.pad(x, tuple(self.pre_pad) * self.ndim)
        return _CONV[self.ndim](x, weight, bias, self.stride, self.padding,
                                self.dilation)


def conv1x1(in_features: int, features: int, stride: int = 1,
            use_bias: bool = True, ndim: int = 2) -> Conv:
    return Conv(in_features, features, 1, stride=stride, padding=0,
                use_bias=use_bias, ndim=ndim)


def conv3x3(in_features: int, features: int, stride: int = 1,
            use_bias: bool = True, dilation: int = 1, ndim: int = 2
            ) -> Conv:
    return Conv(in_features, features, 3, stride=stride, dilation=dilation,
                use_bias=use_bias, ndim=ndim)


class ConvTranspose(nn.Module):
    """N-D transposed convolution (ndim 1, 2 or 3) with a kernel size,
    stride, padding and output padding per axis (an int is the same on
    every axis): output size (in - 1) s - 2p + k + o, `output_padding` o
    on the high side, as the JAX `ConvTranspose` (reference: ncsn3d.py:177
    for the asymmetric temporal form). The JAX layer correlates the
    zero-dilated input with the spatially flipped kernel (*k, I, O);
    torch's conv_transpose weight (I, O, *k) is that kernel transposed,
    unflipped (utils/convert.py). Weight and bias are drawn U(+-1 /
    sqrt(O prod(k))), torch's default. `tp` as `Conv`'s: the weight's
    slices along O where parallel.shard_tp split it."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 stride, padding, output_padding=0, ndim: int = 2):
        super().__init__()
        per_axis = lambda v: (tuple(v) if isinstance(v, (tuple, list))
                              else (v,) * ndim)
        k = per_axis(kernel_size)
        self.stride, self.padding = per_axis(stride), per_axis(padding)
        self.output_padding = per_axis(output_padding)
        self.in_channels, self.out_channels = in_features, features
        self.ndim = ndim
        self.tp = None
        self.weight = nn.Parameter(torch.empty((in_features, features) + k))
        self.bias = nn.Parameter(torch.empty(features))
        bound = 1.0 / math.sqrt(features * math.prod(k))
        with torch.no_grad():
            for p in (self.weight, self.bias):
                p.uniform_(-bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight is None:
            return self.tp.forward(x, self._conv, self.bias)
        return self._conv(x, self.weight, self.bias)

    def _conv(self, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
        return _CONV_T[self.ndim](x, weight, bias, self.stride,
                                  self.padding, self.output_padding)


_MAX_POOL = {3: F.max_pool1d, 4: F.max_pool2d, 5: F.max_pool3d}
_AVG_POOL = {3: F.avg_pool1d, 4: F.avg_pool2d, 5: F.avg_pool3d}


def max_pool(x: torch.Tensor, window: int = 5, stride: int = 1,
             padding: int = 2) -> torch.Tensor:
    """Max pool over the spatial axes of an NCT, NCHW or NCDHW x; the
    padding counts as -inf."""
    return _MAX_POOL[x.ndim](x, window, stride, padding)


def avg_pool(x: torch.Tensor, window: int = 5, stride: int = 1,
             padding: int = 2) -> torch.Tensor:
    """Mean over the full window, padding included (count_include_pad)."""
    return _AVG_POOL[x.ndim](x, window, stride, padding,
                             count_include_pad=True)


def mean_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x decimating mean pool (the reference's sum of shifted slices /
    2^ndim, layers.py:311-313)."""
    return _AVG_POOL[x.ndim](x, 2, 2)


def nearest_up_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample over every spatial axis (the
    reference's cat-4-copies + PixelShuffle, layers.py:337-341)."""
    for axis in range(2, x.ndim):
        x = torch.repeat_interleave(x, 2, dim=axis)
    return x


class _FlaxNamed(nn.Module):
    """Registers submodules under the names Flax gives them inside
    `nn.compact`: <Class>_<i>, counted per class in construction order."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def _auto(self, module: nn.Module, register: bool = True) -> nn.Module:
        cls = type(module).__name__
        i = self._counts.get(cls, 0)
        self._counts[cls] = i + 1
        if register:
            self.add_module(f"{cls}_{i}", module)
        return module


class CRPBlock(_FlaxNamed):
    """Chained residual pooling (reference: layers.py:62-83)."""

    def __init__(self, features: int, n_stages: int, act: Callable,
                 maxpool: bool = True, ndim: int = 2):
        super().__init__()
        self.act = act
        self.pool = max_pool if maxpool else avg_pool
        self.convs = [self._auto(conv3x3(features, features, use_bias=False,
                                         ndim=ndim))
                      for _ in range(n_stages)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(self.pool(path))
            x = path + x
        return x


class RCUBlock(_FlaxNamed):
    """Residual conv units (reference: layers.py:112-134)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 act: Callable, ndim: int = 2):
        super().__init__()
        self.act = act
        self.blocks = [[self._auto(conv3x3(features, features,
                                           use_bias=False, ndim=ndim))
                        for _ in range(n_stages)] for _ in range(n_blocks)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for convs in self.blocks:
            residual = x
            for conv in convs:
                x = conv(self.act(x))
            x = x + residual
        return x


class MSFBlock(_FlaxNamed):
    """Multi-scale fusion: a conv per input, resized (multi-linear,
    aligned corners) to the output shape, summed (reference:
    layers.py:165-184)."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 ndim: int = 2):
        super().__init__()
        self.convs = [self._auto(conv3x3(c, features, ndim=ndim))
                      for c in in_planes]

    def forward(self, xs: Sequence[torch.Tensor], shape: Sequence[int]
                ) -> torch.Tensor:
        from ..ops.resize import resize_align_corners
        total = None
        for conv, x in zip(self.convs, xs):
            h = resize_align_corners(conv(x), shape)
            total = h if total is None else total + h
        return total


class RefineBlock(nn.Module):
    """RefineNet block: adapt RCUs -> MSF -> CRP -> output RCUs
    (reference: layers.py:214-249)."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 act: Callable, start: bool = False, end: bool = False,
                 maxpool: bool = True, ndim: int = 2):
        super().__init__()
        self.n_inputs = len(in_planes)
        for i, c in enumerate(in_planes):
            self.add_module(f"adapt_{i}", RCUBlock(c, 2, 2, act, ndim))
        if self.n_inputs > 1:
            self.msf = MSFBlock(in_planes, features, ndim)
        self.crp = CRPBlock(features, 2, act, maxpool, ndim)
        self.output = RCUBlock(features, 3 if end else 1, 2, act, ndim)

    def forward(self, xs: Sequence[torch.Tensor],
                output_shape: Sequence[int]) -> torch.Tensor:
        hs = [getattr(self, f"adapt_{i}")(x) for i, x in enumerate(xs)]
        h = self.msf(hs, output_shape) if self.n_inputs > 1 else hs[0]
        return self.output(self.crp(h))


class ConvMeanPool(nn.Module):
    """Conv (stride 1), then a 2x mean pool (reference: layers.py:291-313).
    adjust_padding pre-pads (1, 0) per axis (28x28 inputs)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, use_bias: bool = True,
                 adjust_padding: bool = False, ndim: int = 2):
        super().__init__()
        self.Conv_0 = Conv(
            in_features, features, kernel_size, padding=kernel_size // 2,
            use_bias=use_bias, pre_pad=(1, 0) if adjust_padding else None,
            ndim=ndim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mean_pool_2x(self.Conv_0(x))


class MeanPoolConv(nn.Module):
    """A 2x mean pool, then a conv (reference: layers.py:315-326)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, use_bias: bool = True, ndim: int = 2):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel_size,
                           padding=kernel_size // 2, use_bias=use_bias,
                           ndim=ndim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(mean_pool_2x(x))


class UpsampleConv(nn.Module):
    """A 2x nearest-neighbour upsample, then a conv (reference:
    layers.py:329-341)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, use_bias: bool = True, ndim: int = 2):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel_size,
                           padding=kernel_size // 2, use_bias=use_bias,
                           ndim=ndim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(nearest_up_2x(x))


class ResidualBlock(_FlaxNamed):
    """Pre-activation residual block (reference: layers.py:401-456).

    resample='down' with dilation: two dilated convs and a dilated
    shortcut, no change of size; 'down' without dilation: a conv, then a
    ConvMeanPool, with a 1x1 ConvMeanPool shortcut; None: plain or dilated
    convs, with a conv1x1 (or dilated conv) shortcut where widths differ.
    The convs are named in construction order, conv1, conv2, shortcut; the
    shortcut has no parameters where the block keeps its input.
    """

    def __init__(self, input_dim: int, output_dim: int, normalization,
                 act: Callable, resample: Optional[str] = None,
                 dilation: Optional[int] = None,
                 adjust_padding: bool = False, ndim: int = 2):
        super().__init__()
        self.act = act
        d = dilation if dilation is not None and dilation > 1 else None
        c3 = functools.partial(conv3x3, dilation=d or 1, ndim=ndim)
        if resample == "down":
            mid = input_dim
            if d:
                conv1 = c3(input_dim, input_dim)
                conv2 = c3(input_dim, output_dim)
                shortcut = c3(input_dim, output_dim)
            else:
                conv1 = c3(input_dim, input_dim)
                conv2 = ConvMeanPool(input_dim, output_dim,
                                     adjust_padding=adjust_padding,
                                     ndim=ndim)
                shortcut = ConvMeanPool(input_dim, output_dim, kernel_size=1,
                                        adjust_padding=adjust_padding,
                                        ndim=ndim)
        elif resample is None:
            mid = output_dim
            conv1 = c3(input_dim, output_dim)
            conv2 = c3(output_dim, output_dim)
            shortcut = (c3(input_dim, output_dim) if d
                        else conv1x1(input_dim, output_dim, ndim=ndim))
        else:
            raise ValueError("invalid resample value")
        identity = output_dim == input_dim and resample is None
        self._auto(conv1)
        self._auto(conv2)
        self._auto(shortcut, register=not identity)
        # plain references: the modules are registered under their Flax
        # names above
        self.convs = (conv1, conv2, None if identity else shortcut)
        self.norm1 = normalization(input_dim)
        self.norm2 = normalization(mid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1, conv2, shortcut = self.convs
        out = conv1(self.act(self.norm1(x)))
        out = conv2(self.act(self.norm2(out)))
        return (x if shortcut is None else shortcut(x)) + out


class ConditionalResidualBlock(ResidualBlock):
    """The class-conditional residual block of NCSN v1 (reference:
    layers.py:344-398): ResidualBlock's convolutions, with norms
    `normalization(width, num_classes)` called as norm(x, y) on the integer
    labels y (B,)."""

    def __init__(self, input_dim: int, output_dim: int, normalization,
                 num_classes: int, act: Callable,
                 resample: Optional[str] = None,
                 dilation: Optional[int] = None,
                 adjust_padding: bool = False, ndim: int = 2):
        super().__init__(
            input_dim, output_dim,
            functools.partial(normalization, num_classes=num_classes), act,
            resample=resample, dilation=dilation,
            adjust_padding=adjust_padding, ndim=ndim)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        conv1, conv2, shortcut = self.convs
        out = conv1(self.act(self.norm1(x, y)))
        out = conv2(self.act(self.norm2(out, y)))
        return (x if shortcut is None else shortcut(x)) + out

"""NCSN v1 score networks, NCHW: the class-conditional RefineNet.

Port of inverseproblemwithdiffusionmodel_tpu/models/ncsn.py (reference:
ncsn/models/ncsn.py, NCSN :9-100, NCSNdeeper :102-188, and the conditional
RefineNet blocks of ncsn/models/layers.py: CondCRPBlock :85-109,
CondRCUBlock :136-162, CondMSFBlock :186-212, CondRefineBlock :252-289).

The noise level enters through the conditional norms (ConditionalInstance
NormPlus by default) as the integer ladder label y (B,); unlike NCSNv2 the
output is NOT divided by sigma. `forward(x, y)` takes x as (B, C, H, W).
The stages and RefineBlocks are NCSNv2's and NCSNv2Deeper's
(models/ncsnv2.py); submodules carry the Flax names (`res1_0`, `refine1`,
`adapt_0`, `norm_0_1`, `Conv_2`, ...), so utils/convert.flax_to_torch_ncsn
maps a JAX parameter tree onto the state dict leaf by leaf.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
import torch.nn as nn

from .layers import (Conv, ConditionalResidualBlock, _FlaxNamed, avg_pool,
                     centered_input, conv3x3, get_act)
from .ncsnv2 import NCSNv2, NCSNv2Deeper
from .normalization import get_normalization


class CondCRPBlock(_FlaxNamed):
    """Conditional chained residual pooling, average pools (reference:
    layers.py:85-109)."""

    def __init__(self, features: int, n_stages: int, num_classes: int,
                 normalizer, act: Callable, ndim: int = 2):
        super().__init__()
        self.act = act
        for i in range(n_stages):
            self.add_module(f"norm_{i}", normalizer(features, num_classes))
        self.convs = [self._auto(conv3x3(features, features, use_bias=False,
                                         ndim=ndim))
                      for _ in range(n_stages)]

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = self.act(x)
        path = x
        for i, conv in enumerate(self.convs):
            path = conv(avg_pool(getattr(self, f"norm_{i}")(path, y)))
            x = path + x
        return x


class CondRCUBlock(_FlaxNamed):
    """Conditional residual conv units (reference: layers.py:136-162)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 num_classes: int, normalizer, act: Callable, ndim: int = 2):
        super().__init__()
        self.act = act
        self.blocks = []
        for i in range(n_blocks):
            stage = []
            for j in range(n_stages):
                self.add_module(f"norm_{i}_{j}",
                                normalizer(features, num_classes))
                stage.append((f"norm_{i}_{j}", self._auto(conv3x3(
                    features, features, use_bias=False, ndim=ndim))))
            self.blocks.append(stage)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        for stage in self.blocks:
            residual = x
            for norm, conv in stage:
                x = conv(self.act(getattr(self, norm)(x, y)))
            x = x + residual
        return x


class CondMSFBlock(_FlaxNamed):
    """Conditional multi-scale fusion: per input a norm and a conv, resized
    (multi-linear, aligned corners) to the output shape, summed
    (reference: layers.py:186-212)."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 num_classes: int, normalizer, ndim: int = 2):
        super().__init__()
        for i, c in enumerate(in_planes):
            self.add_module(f"norm_{i}", normalizer(c, num_classes))
        self.convs = [self._auto(conv3x3(c, features, ndim=ndim))
                      for c in in_planes]

    def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor,
                shape: Sequence[int]) -> torch.Tensor:
        from ..ops.resize import resize_align_corners
        total = None
        for i, (conv, x) in enumerate(zip(self.convs, xs)):
            h = conv(getattr(self, f"norm_{i}")(x, y))
            h = resize_align_corners(h, shape)
            total = h if total is None else total + h
        return total


class CondRefineBlock(nn.Module):
    """Conditional RefineNet block: adapt RCUs -> MSF -> CRP -> output RCUs
    (reference: layers.py:252-289)."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 num_classes: int, normalizer, act: Callable,
                 start: bool = False, end: bool = False, ndim: int = 2):
        super().__init__()
        self.n_inputs = len(in_planes)
        for i, c in enumerate(in_planes):
            self.add_module(f"adapt_{i}", CondRCUBlock(
                c, 2, 2, num_classes, normalizer, act, ndim))
        if self.n_inputs > 1:
            self.msf = CondMSFBlock(in_planes, features, num_classes,
                                    normalizer, ndim)
        self.crp = CondCRPBlock(features, 2, num_classes, normalizer, act,
                                ndim)
        self.output = CondRCUBlock(features, 3 if end else 1, 2, num_classes,
                                   normalizer, act, ndim)

    def forward(self, xs: Sequence[torch.Tensor], y: torch.Tensor,
                output_shape: Sequence[int]) -> torch.Tensor:
        hs = [getattr(self, f"adapt_{i}")(x, y) for i, x in enumerate(xs)]
        h = self.msf(hs, y, output_shape) if self.n_inputs > 1 else hs[0]
        return self.output(self.crp(h, y), y)


class _NCSNFamily(nn.Module):
    """begin_conv, conditional residual stages (NCSNv2's STAGES), the
    conditional RefineBlocks from the deepest stage up (REFINES), then the
    conditional normalizer, activation and end_conv."""
    STAGES = ()
    REFINES = ()

    def __init__(self, config, ndim: int = 2):
        super().__init__()
        self.config = config
        m = config.model
        ngf, K = m.ngf, m.num_classes
        self.act = act = get_act(config)
        norm = get_normalization(config, conditional=True)
        self.centered = centered_input(config)
        channels = config.data.channels
        self.begin_conv = Conv(channels, ngf, 3, ndim=ndim)
        res = functools.partial(ConditionalResidualBlock, normalization=norm,
                                num_classes=K, act=act, ndim=ndim)
        width, widths = ngf, []
        for name, mult, resample, dilation in self.STAGES:
            self.add_module(f"{name}_0", res(
                width, mult * ngf, resample=resample, dilation=dilation,
                adjust_padding=self._adjust_padding(name)))
            width = mult * ngf
            self.add_module(f"{name}_1", res(width, width,
                                             dilation=dilation))
            widths.append(width)
        ref_width = None
        last = len(self.REFINES) - 1
        for i, ((name, mult), width) in enumerate(
                zip(self.REFINES, reversed(widths))):
            planes = [width] if ref_width is None else [width, ref_width]
            self.add_module(name, CondRefineBlock(
                planes, mult * ngf, K, norm, act, start=i == 0,
                end=i == last, ndim=ndim))
            ref_width = mult * ngf
        self.normalizer = norm(ngf, K)
        self.end_conv = Conv(ngf, channels, 3, ndim=ndim)

    def _adjust_padding(self, stage: str) -> bool:
        return False

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        y = y.long()
        h = x if self.centered else 2 * x - 1.0
        h = self.begin_conv(h)
        layers = []
        for name, *_ in self.STAGES:
            h = getattr(self, f"{name}_0")(h, y)
            h = getattr(self, f"{name}_1")(h, y)
            layers.append(h)
        ref = None
        for (name, _), layer in zip(self.REFINES, reversed(layers)):
            xs = [layer] if ref is None else [layer, ref]
            ref = getattr(self, name)(xs, y, layer.shape[2:])
        return self.end_conv(self.act(self.normalizer(ref, y)))


class NCSN(_NCSNFamily):
    """NCSN v1, 4 conditional residual stages and 4 conditional RefineNet
    stages (reference: ncsn.py:9-100); at 28 px res4_0 pre-pads its
    ConvMeanPool inputs (adjust_padding), as the JAX net does."""
    STAGES = NCSNv2.STAGES
    REFINES = NCSNv2.REFINES

    def _adjust_padding(self, stage: str) -> bool:
        return stage == "res4" and self.config.data.image_size == 28


class NCSNdeeper(_NCSNFamily):
    """5-stage NCSN v1 (reference: ncsn.py:102-188)."""
    STAGES = NCSNv2Deeper.STAGES
    REFINES = NCSNv2Deeper.REFINES

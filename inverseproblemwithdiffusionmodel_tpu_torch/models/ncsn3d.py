"""3-D (2D + time) score networks on pixel-window volumes, NCDHW.

Port of inverseproblemwithdiffusionmodel_tpu/models/ncsn3d.py (reference:
ncsn/models/ncsn3d.py): NCSN3D (:14-120) is the NCSNv2 body at ndim=3 with
`config.data.channels_3d` input and output channels; NCSN3DShallow
(:123-224), what the "Diffusion3D" task builds, is a shallower variant with
a temporal down convolution (kernel (1, 1, 4), stride (1, 1, 2), padding
(0, 0, 1)) and its transposed twin on the way up.

A volume is (B, C3, kx, ky, T): the JAX package's channel-last (B, kx, ky,
T, C3) with the channel axis moved first. A rank-3 input is a batch of
pixel tubes, channel-first (B, kx ky, T) as the port's 1-D nets take them
(models/registry.make_score_fn hands the net the (B, T, kx ky) tubes of
the cine sampler in that form); the net views it as the (B, 1, kx, ky, T)
volume, which holds the elements in the order of JAX's `_tube_to_volume`,
and returns tubes of the same shape. `config.data.channels` is kx ky, the
tube window's size.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Conv, ConvTranspose, RefineBlock, ResidualBlock,
                     centered_input, get_act)
from .ncsnv2 import NCSNv2, _divide_by_sigmas
from .normalization import get_normalization


def tube_window(config) -> int:
    """The tube window kx = ky of a 3-D net's config: the square root of
    `config.data.channels`."""
    return int(math.isqrt(int(config.data.channels)))


def _tube_to_volume(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, kx ky, T) -> (B, 1, kx, ky, T), a view where x is contiguous."""
    B, C, T = x.shape
    return x.reshape(B, 1, win, win, T)


def _volume_to_tube(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, kx, ky, T) -> (B, kx ky, T)."""
    B, _, kx, ky, T = x.shape
    return x.reshape(B, kx * ky, T)


class NCSN3D(NCSNv2):
    """Full-depth 3-D NCSNv2 (reference: ncsn3d.py:14-120): the 4-stage
    NCSNv2 at ndim=3, `channels_3d` (default 1) channels in and out, the
    last RefineBlock `end=True`, `adjust_padding` on res4 for 28-frame
    configs."""

    def __init__(self, config):
        super().__init__(config, ndim=3)
        self.win = tube_window(config)

    def _io_channels(self) -> int:
        return self.config.data.get("channels_3d", 1)

    def forward(self, x: torch.Tensor, used_sigmas: torch.Tensor
                ) -> torch.Tensor:
        if x.ndim == 3:
            out = super().forward(_tube_to_volume(x, self.win), used_sigmas)
            return _volume_to_tube(out)
        return super().forward(x, used_sigmas)


class TemporalDownConv(nn.Module):
    """Conv3d with kernel (1, 1, 4), stride (1, 1, 2), padding (0, 0, 1):
    halves the temporal axis only (reference: ncsn3d.py:176). Weight (O,
    I, 1, 1, 4) and bias drawn U(+-1/sqrt(4 I))."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               1, 1, 4))
        self.bias = nn.Parameter(torch.empty(features))
        bound = 1.0 / math.sqrt(4 * in_features)
        with torch.no_grad():
            for p in (self.weight, self.bias):
                p.uniform_(-bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight, self.bias, stride=(1, 1, 2),
                        padding=(0, 0, 1))


class NCSN3DShallow(nn.Module):
    """Shallow 2D+time score net, the "Diffusion3D" task's (reference:
    ncsn3d.py:123-224, helpers/load_model.py:26): two stages at the full
    volume (the second dilated 2), the temporal down convolution, a stage
    dilated 4 at half the frames, two RefineBlocks there, the transposed
    temporal convolution back to all frames, one RefineBlock with the
    first stage.

    As in the JAX package (its note at models/ncsn3d.py:150-154), the last
    RefineBlock is not `end=True`: its output RCU has 1 block, so the
    reference's checkpoints import exactly."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        ngf = config.model.ngf
        c3 = config.data.get("channels_3d", 1)
        self.win = tube_window(config)
        self.act = act = get_act(config)
        norm = get_normalization(config, conditional=False)
        self.centered = centered_input(config)

        def res(c_in, c_out, resample=None, dilation=None):
            return ResidualBlock(c_in, c_out, norm, act, resample=resample,
                                 dilation=dilation, ndim=3)

        self.begin_conv = Conv(c3, ngf, 3, ndim=3)
        self.res1_0 = res(ngf, ngf)
        self.res1_1 = res(ngf, ngf)
        self.res3_0 = res(ngf, 2 * ngf, resample="down", dilation=2)
        self.res3_1 = res(2 * ngf, 2 * ngf, dilation=2)
        self.conv_temporal_down = TemporalDownConv(2 * ngf, 2 * ngf)
        self.res4_0 = res(2 * ngf, 2 * ngf, resample="down", dilation=4)
        self.res4_1 = res(2 * ngf, 2 * ngf, dilation=4)
        self.refine1 = RefineBlock([2 * ngf], 2 * ngf, act, start=True,
                                   ndim=3)
        self.refine2 = RefineBlock([2 * ngf, 2 * ngf], 2 * ngf, act, ndim=3)
        self.conv_temporal_up = ConvTranspose(
            2 * ngf, ngf, (1, 1, 4), stride=(1, 1, 2), padding=(0, 0, 1),
            ndim=3)
        self.refine3 = RefineBlock([ngf, ngf], ngf, act, ndim=3)
        self.normalizer = norm(ngf)
        self.end_conv = Conv(ngf, c3, 3, ndim=3)

    def forward(self, x: torch.Tensor, used_sigmas: torch.Tensor
                ) -> torch.Tensor:
        tubes = x.ndim == 3
        if tubes:
            x = _tube_to_volume(x, self.win)
        h = x if self.centered else 2 * x - 1.0
        h = self.begin_conv(h)
        layer1 = self.res1_1(self.res1_0(h))
        layer2 = self.res3_1(self.res3_0(layer1))
        layer3 = self.conv_temporal_down(layer2)
        layer4 = self.res4_1(self.res4_0(layer3))
        ref1 = self.refine1([layer4], layer4.shape[2:])
        ref2 = self.refine2([layer3, ref1], layer3.shape[2:])
        ref3 = self.conv_temporal_up(ref2)
        out = self.refine3([layer1, ref3], layer1.shape[2:])
        out = self.end_conv(self.act(self.normalizer(out)))
        out = _divide_by_sigmas(out, used_sigmas)
        return _volume_to_tube(out) if tubes else out

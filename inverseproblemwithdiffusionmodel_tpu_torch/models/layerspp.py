"""NCSN++ building blocks (continuous model zoo).

Port of inverseproblemwithdiffusionmodel_tpu/models/layerspp.py. Tensors
are channel-last (N, H, W, C), as in the JAX package, so the FIR kernels see
the layout their TPU counterparts saw: convolutions run on a channels-last
view of the same memory, group norm and attention work on NHWC directly.
Module and parameter names are the JAX package's, so a Flax parameter tree
maps onto a state dict name by name (utils/convert.py).

FIR resampling goes through ops/fir_kernels.py, which launches the CUDA
kernels for CUDA tensors; the FIR resamplers that fuse a convolution
(`with_conv=True`) are plain PyTorch (ops/upfirdn2d.py), as the JAX package
leaves them to XLA. The naive resamplers (nearest-neighbour up, 2x2 mean
or strided convolution down) of DDPM++ and DDPM are plain PyTorch too.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.fir_kernels import fir_downsample_2x, fir_upsample_2x
from ..ops.upfirdn2d import conv_downsample_2d, upsample_conv_2d

def default_init(tensor: torch.Tensor, fan_in: int, fan_out: int,
                 scale: float = 1.0) -> torch.Tensor:
    """DDPM-style variance-scaling uniform init, fan_avg; scale 0 means
    1e-10."""
    scale = 1e-10 if scale == 0 else scale
    limit = math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2.0))
    with torch.no_grad():
        return tensor.uniform_(-limit, limit)


def _group_count(ch: int) -> int:
    return min(max(ch // 4, 1), 32)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over channel-last input, eps 1e-6, min(ch // 4, 32) groups
    unless num_groups is given."""

    def __init__(self, ch: int, num_groups: Optional[int] = None):
        super().__init__(num_groups or _group_count(ch), ch, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, H, W, C = x.shape
        g = x.reshape(N, H * W, self.num_groups, C // self.num_groups)
        var, mean = torch.var_mean(g, dim=(1, 3), keepdim=True, correction=0)
        g = (g - mean) * torch.rsqrt(var + self.eps)
        return g.reshape(N, H, W, C) * self.weight + self.bias


class Conv2d(nn.Conv2d):
    """Convolution of channel-last input, zero bias, default_init weights."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 init_scale: float = 1.0, padding: int = 0,
                 use_bias: bool = True, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride,
                         padding=padding, bias=use_bias)
        rf = kernel_size * kernel_size
        default_init(self.weight, in_ch * rf, out_ch * rf, init_scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = super().forward(x.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1).contiguous()


def ddpm_conv3x3(in_ch: int, out_ch: int, init_scale: float = 1.0) -> Conv2d:
    return Conv2d(in_ch, out_ch, 3, init_scale, padding=1)


def ddpm_conv1x1(in_ch: int, out_ch: int, init_scale: float = 1.0) -> Conv2d:
    return Conv2d(in_ch, out_ch, 1, init_scale, padding=0)


def dense(in_dim: int, out_dim: int) -> nn.Linear:
    """Linear layer with default_init weights and zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    default_init(layer.weight, in_dim, out_dim)
    nn.init.zeros_(layer.bias)
    return layer


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings."""
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                 device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GaussianFourierProjection(nn.Module):
    """Random Fourier features of log-sigma; the projection is frozen."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.randn(embedding_size) * scale,
                              requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


class NIN(nn.Module):
    """1x1 'network-in-network' dense over the channel axis; W is (in, out)."""

    def __init__(self, in_dim: int, num_units: int, init_scale: float = 0.1):
        super().__init__()
        self.W = nn.Parameter(default_init(torch.empty(in_dim, num_units),
                                           in_dim, num_units, init_scale))
        self.b = nn.Parameter(torch.zeros(num_units))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.W + self.b


class Combine(nn.Module):
    """Combine a pyramid input with a skip."""

    def __init__(self, in_ch: int, features: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"combine method {method!r} not recognized")
        self.method = method
        self.Conv_0 = ddpm_conv1x1(in_ch, features)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x)
        if self.method == "cat":
            return torch.cat([h, y], dim=-1)
        return h + y


class AttnBlockpp(nn.Module):
    """Channel self-attention over all spatial positions."""

    def __init__(self, channels: int, skip_rescale: bool = False,
                 init_scale: float = 0.0, num_groups: Optional[int] = None):
        super().__init__()
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(channels, num_groups)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels, init_scale=init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.GroupNorm_0(x)
        q = self.NIN_0(h).reshape(B, H * W, C)
        k = self.NIN_1(h).reshape(B, H * W, C)
        v = self.NIN_2(h).reshape(B, H * W, C)
        w = torch.softmax(q @ k.transpose(1, 2) * (C ** -0.5), dim=-1)
        h = self.NIN_3((w @ v).reshape(B, H, W, C))
        out = x + h
        return out / math.sqrt(2.0) if self.skip_rescale else out


def naive_upsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of channel-last x: at an integer factor
    jax.image.resize's "nearest" repeats each pixel."""
    return x.repeat_interleave(factor, 1).repeat_interleave(factor, 2)


def naive_downsample_2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """The mean over each factor x factor block of channel-last x."""
    B, H, W, C = x.shape
    return x.reshape(B, H // factor, factor, W // factor, factor, C).mean(
        dim=(2, 4))


class _Resample(nn.Module):
    """2x resampling, FIR-filtered or naive, alone or with a convolution.
    FIR with_conv fuses a 3x3 convolution (the parameters are the JAX
    package's `Conv2d_0_weight`, (3, 3, in_ch, out_ch) HWIO, and
    `Conv2d_0_bias`); naive with_conv runs a 3x3 convolution `Conv_0`."""

    def __init__(self, in_ch: Optional[int] = None,
                 out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.with_conv = with_conv
        self.fir = fir
        self.fir_kernel = tuple(fir_kernel)
        if with_conv:
            if in_ch is None:
                raise ValueError("with_conv needs in_ch")
            out_ch = out_ch or in_ch
            if fir:
                self.Conv2d_0_weight = nn.Parameter(default_init(
                    torch.empty(3, 3, in_ch, out_ch), 9 * in_ch,
                    9 * out_ch))
                self.Conv2d_0_bias = nn.Parameter(torch.zeros(out_ch))
            else:
                self.Conv_0 = self._naive_conv(in_ch, out_ch)


class Upsample(_Resample):
    """2x upsample. FIR: with_conv fuses a transposed 3x3 conv
    (ops/upfirdn2d.upsample_conv_2d, plain PyTorch as in the JAX package),
    else the FIR kernel K1. Naive: nearest neighbour, then the 3x3
    `Conv_0` with_conv."""

    @staticmethod
    def _naive_conv(in_ch: int, out_ch: int) -> Conv2d:
        return ddpm_conv3x3(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fir:
            h = naive_upsample_2d(x)
            return self.Conv_0(h) if self.with_conv else h
        if not self.with_conv:
            return fir_upsample_2x(x, self.fir_kernel)
        return upsample_conv_2d(x, self.Conv2d_0_weight, k=self.fir_kernel,
                                factor=2) + self.Conv2d_0_bias


class Downsample(_Resample):
    """2x downsample. FIR: with_conv fuses a strided 3x3 conv
    (ops/upfirdn2d.conv_downsample_2d), else the FIR kernel K2. Naive:
    with_conv pads right and bottom by 1 and runs the stride-2 VALID 3x3
    `Conv_0` (the DDPM convention), else a 2x2 average pool."""

    @staticmethod
    def _naive_conv(in_ch: int, out_ch: int) -> Conv2d:
        return Conv2d(in_ch, out_ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fir:
            if self.with_conv:
                return self.Conv_0(F.pad(x, (0, 0, 0, 1, 0, 1)))
            return naive_downsample_2d(x)
        if not self.with_conv:
            return fir_downsample_2x(x, self.fir_kernel)
        return conv_downsample_2d(x, self.Conv2d_0_weight, k=self.fir_kernel,
                                  factor=2) + self.Conv2d_0_bias


class ResnetBlockDDPMpp(nn.Module):
    """DDPM-style residual block."""

    def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
                 conv_shortcut: bool = False, dropout: float = 0.1,
                 skip_rescale: bool = False, init_scale: float = 0.0,
                 temb_dim: Optional[int] = None,
                 num_groups: Optional[int] = None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(in_ch, num_groups)
        self.Conv_0 = ddpm_conv3x3(in_ch, out_ch)
        self.Dense_0 = None if temb_dim is None else dense(temb_dim, out_ch)
        self.GroupNorm_1 = GroupNorm(out_ch, num_groups)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = ddpm_conv3x3(out_ch, out_ch, init_scale=init_scale)
        self.Conv_2 = self.NIN_0 = None
        if in_ch != out_ch:
            if conv_shortcut:
                self.Conv_2 = ddpm_conv3x3(in_ch, out_ch)
            else:
                self.NIN_0 = NIN(in_ch, out_ch)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.Conv_0(self.act(self.GroupNorm_0(x)))
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, None, None, :]
        h = self.Conv_1(self.Dropout_0(self.act(self.GroupNorm_1(h))))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        elif self.NIN_0 is not None:
            x = self.NIN_0(x)
        out = x + h
        return out / math.sqrt(2.0) if self.skip_rescale else out


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN-style residual block with in-block FIR up/down sampling."""

    def __init__(self, act: Callable, in_ch: int, out_ch: Optional[int] = None,
                 up: bool = False, down: bool = False, dropout: float = 0.1,
                 fir: bool = False, fir_kernel: Sequence[int] = (1, 3, 3, 1),
                 skip_rescale: bool = True, init_scale: float = 0.0,
                 temb_dim: Optional[int] = None,
                 num_groups: Optional[int] = None):
        super().__init__()
        out_ch = out_ch or in_ch
        self.act = act
        self.up, self.down = up, down
        self.fir = fir
        self.fir_kernel = tuple(fir_kernel)
        self.skip_rescale = skip_rescale
        self.GroupNorm_0 = GroupNorm(in_ch, num_groups)
        self.Conv_0 = ddpm_conv3x3(in_ch, out_ch)
        self.Dense_0 = None if temb_dim is None else dense(temb_dim, out_ch)
        self.GroupNorm_1 = GroupNorm(out_ch, num_groups)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = ddpm_conv3x3(out_ch, out_ch, init_scale=init_scale)
        self.Conv_2 = (ddpm_conv1x1(in_ch, out_ch)
                       if in_ch != out_ch or up or down else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.act(self.GroupNorm_0(x))
        if self.up:
            up = ((lambda v: fir_upsample_2x(v, self.fir_kernel)) if self.fir
                  else naive_upsample_2d)
            h, x = up(h), up(x)
        elif self.down:
            down = ((lambda v: fir_downsample_2x(v, self.fir_kernel))
                    if self.fir else naive_downsample_2d)
            h, x = down(h), down(x)
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(self.act(temb))[:, None, None, :]
        h = self.Conv_1(self.Dropout_0(self.act(self.GroupNorm_1(h))))
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        out = x + h
        return out / math.sqrt(2.0) if self.skip_rescale else out

"""NCSN++ score UNet.

Port of inverseproblemwithdiffusionmodel_tpu/models/ncsnpp.py: Fourier or
positional noise embedding, the FIR input/output pyramids (`input_skip`,
`output_skip`, `residual`), BigGAN or DDPM residual blocks, attention at
the configured resolutions and `scale_by_sigma` output division.
`forward(x, time_cond)` takes channel-last x (N, H, W, C) and returns the
same layout; for `embedding_type='fourier'` time_cond is the per-sample
sigma values, for 'positional' the integer ladder indices.

Modules are built in `__init__` by the same walk over levels that `forward`
takes, and carry the Flax module names (`res_<i>`, `attn_d<level>_<block>`,
`pyr_conv_<level>`, ...). The `residual` pyramids resample through the FIR
resamplers that fuse a convolution (layerspp `with_conv=True`).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn

from . import layerspp
from .layers import get_act
from ..samplers.sigmas import sigma_ladder

conv3x3 = layerspp.ddpm_conv3x3


class NCSNpp(nn.Module):
    """NCSN++ (reference: models/ncsnpp.py:35)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        m = config.model
        self.act = act = get_act(config)
        nf = m.nf
        ch_mult = tuple(m.ch_mult)
        self.num_res_blocks = num_res_blocks = m.num_res_blocks
        self.num_resolutions = num_resolutions = len(ch_mult)
        self.all_resolutions = [config.data.image_size // (2 ** i)
                                for i in range(num_resolutions)]
        attn_resolutions = tuple(m.attn_resolutions)
        self.conditional = m.conditional
        fir, fir_kernel = m.fir, tuple(m.fir_kernel)
        self.skip_rescale = skip_rescale = m.skip_rescale
        self.resblock_type = resblock_type = m.resblock_type.lower()
        self.progressive = progressive = m.progressive.lower()
        self.progressive_input = progressive_input = m.progressive_input.lower()
        self.embedding_type = embedding_type = m.embedding_type.lower()
        init_scale = m.init_scale
        self.centered = config.data.centered
        self.scale_by_sigma = m.scale_by_sigma
        channels = config.data.num_channels
        if progressive not in ("none", "output_skip", "residual"):
            raise ValueError(f"progressive {progressive!r} unrecognized")
        if progressive_input not in ("none", "input_skip", "residual"):
            raise ValueError(f"progressive_input {progressive_input!r} "
                             "unrecognized")
        if embedding_type not in ("fourier", "positional"):
            raise ValueError(f"embedding type {embedding_type!r} unrecognized")

        AttnBlock = functools.partial(layerspp.AttnBlockpp,
                                      init_scale=init_scale,
                                      skip_rescale=skip_rescale)
        temb_dim = nf * 4 if self.conditional else None
        if resblock_type == "ddpm":
            ResnetBlock = functools.partial(
                layerspp.ResnetBlockDDPMpp, act=act, dropout=m.dropout,
                init_scale=init_scale, skip_rescale=skip_rescale,
                temb_dim=temb_dim)
        elif resblock_type == "biggan":
            ResnetBlock = functools.partial(
                layerspp.ResnetBlockBigGANpp, act=act, dropout=m.dropout,
                fir=fir, fir_kernel=fir_kernel, init_scale=init_scale,
                skip_rescale=skip_rescale, temb_dim=temb_dim)
        else:
            raise ValueError(f"resblock type {resblock_type} unrecognized")

        # --- noise embedding ------------------------------------------------
        if embedding_type == "fourier":
            self.fourier_proj = layerspp.GaussianFourierProjection(
                embedding_size=nf, scale=m.fourier_scale)
            embed_dim = 2 * nf
        else:
            self.register_buffer(
                "sigmas", sigma_ladder(m.sigma_max, m.sigma_min,
                                       m.num_scales, "geometric"),
                persistent=False)
            embed_dim = nf
        if self.conditional:
            self.temb_dense0 = layerspp.dense(embed_dim, nf * 4)
            self.temb_dense1 = layerspp.dense(nf * 4, nf * 4)

        # --- modules, in the order forward() uses them -------------------
        blocks = 0

        def add_rb(in_ch, **kw):
            nonlocal blocks
            self.add_module(f"res_{blocks}", ResnetBlock(in_ch=in_ch, **kw))
            blocks += 1

        self.conv_in = conv3x3(channels, nf)
        hs_ch = [nf]
        in_ch = nf
        pyr_ch = channels    # channels of the residual pyramid
        for i_level in range(num_resolutions):
            for i_block in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                add_rb(in_ch, out_ch=out_ch)
                in_ch = out_ch
                if self.all_resolutions[i_level] in attn_resolutions:
                    self.add_module(f"attn_d{i_level}_{i_block}",
                                    AttnBlock(in_ch))
                hs_ch.append(in_ch)
            if i_level != num_resolutions - 1:
                if resblock_type == "ddpm":
                    self.add_module(f"down_{i_level}", layerspp.Downsample(
                        in_ch=in_ch, with_conv=m.resamp_with_conv, fir=fir,
                        fir_kernel=fir_kernel))
                else:
                    add_rb(in_ch, down=True)
                if progressive_input == "input_skip":
                    self.add_module(f"pyr_down_{i_level}", layerspp.Downsample(
                        fir=fir, fir_kernel=fir_kernel, with_conv=False))
                    self.add_module(f"combine_{i_level}", layerspp.Combine(
                        channels, in_ch, method=m.progressive_combine.lower()))
                elif progressive_input == "residual":
                    self.add_module(f"pyr_down_{i_level}", layerspp.Downsample(
                        in_ch=pyr_ch, out_ch=in_ch, fir=fir,
                        fir_kernel=fir_kernel, with_conv=True))
                    pyr_ch = in_ch
                hs_ch.append(in_ch)

        add_rb(in_ch)
        self.attn_mid = AttnBlock(in_ch)
        add_rb(in_ch)

        for i_level in reversed(range(num_resolutions)):
            for i_block in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                add_rb(in_ch + hs_ch.pop(), out_ch=out_ch)
                in_ch = out_ch
            if self.all_resolutions[i_level] in attn_resolutions:
                self.add_module(f"attn_u{i_level}", AttnBlock(in_ch))
            if progressive == "output_skip":
                if i_level != num_resolutions - 1:
                    self.add_module(f"pyr_up_{i_level}", layerspp.Upsample(
                        fir=fir, fir_kernel=fir_kernel, with_conv=False))
                self.add_module(f"pyr_norm_{i_level}",
                                layerspp.GroupNorm(in_ch))
                self.add_module(f"pyr_conv_{i_level}",
                                conv3x3(in_ch, channels, init_scale))
            elif progressive == "residual":
                if i_level == num_resolutions - 1:
                    self.add_module(f"pyr_norm_{i_level}",
                                    layerspp.GroupNorm(in_ch))
                    self.add_module(f"pyr_conv_{i_level}",
                                    conv3x3(in_ch, in_ch))
                else:
                    self.add_module(f"pyr_up_{i_level}", layerspp.Upsample(
                        in_ch=pyr_ch, out_ch=in_ch, fir=fir,
                        fir_kernel=fir_kernel, with_conv=True))
                pyr_ch = in_ch
            if i_level != 0:
                if resblock_type == "ddpm":
                    self.add_module(f"up_{i_level}", layerspp.Upsample(
                        in_ch=in_ch, with_conv=m.resamp_with_conv, fir=fir,
                        fir_kernel=fir_kernel))
                else:
                    add_rb(in_ch, up=True)
        if progressive != "output_skip":
            self.norm_out = layerspp.GroupNorm(in_ch)
            self.conv_out = conv3x3(in_ch, channels, init_scale)

    def _skip(self, s: torch.Tensor) -> torch.Tensor:
        """A residual pyramid's sum, divided by sqrt(2) with skip_rescale."""
        return s / math.sqrt(2.0) if self.skip_rescale else s

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor
                ) -> torch.Tensor:
        act = self.act
        # --- noise embedding ------------------------------------------------
        if self.embedding_type == "fourier":
            used_sigmas = time_cond
            temb = self.fourier_proj(torch.log(used_sigmas))
        else:
            # as JAX's gather: a negative index counts from the end (the
            # ODE sampler's last step overshoots to t < 0), and an index
            # past the ladder (t * 999 on a ladder cut below 1000 scales)
            # is clamped into it
            n = len(self.sigmas)
            idx = time_cond.long()
            used_sigmas = self.sigmas[torch.where(idx < 0, idx + n, idx)
                                      .clamp(0, n - 1)]
            # The sinusoids are computed in float32 and then take x's dtype,
            # so a bf16 net runs in bf16 throughout (see
            # training/train._mixed_precision_apply).
            temb = layerspp.get_timestep_embedding(
                time_cond, self.config.model.nf).to(x.dtype)
        if self.conditional:
            temb = self.temb_dense1(act(self.temb_dense0(temb)))
        else:
            temb = None

        if not self.centered:
            x = 2 * x - 1.0

        blocks = 0

        def rb(h, temb):
            nonlocal blocks
            out = getattr(self, f"res_{blocks}")(h, temb)
            blocks += 1
            return out

        # --- downsampling ---------------------------------------------------
        input_pyramid = x if self.progressive_input != "none" else None
        hs = [self.conv_in(x)]
        for i_level in range(self.num_resolutions):
            for i_block in range(self.num_res_blocks):
                h = rb(hs[-1], temb)
                name = f"attn_d{i_level}_{i_block}"
                if hasattr(self, name):
                    h = getattr(self, name)(h)
                hs.append(h)
            if i_level != self.num_resolutions - 1:
                if self.resblock_type == "ddpm":
                    h = getattr(self, f"down_{i_level}")(hs[-1])
                else:
                    h = rb(hs[-1], temb)
                if self.progressive_input == "input_skip":
                    input_pyramid = getattr(self, f"pyr_down_{i_level}")(
                        input_pyramid)
                    h = getattr(self, f"combine_{i_level}")(input_pyramid, h)
                elif self.progressive_input == "residual":
                    input_pyramid = self._skip(getattr(
                        self, f"pyr_down_{i_level}")(input_pyramid) + h)
                    h = input_pyramid
                hs.append(h)

        h = rb(hs[-1], temb)
        h = self.attn_mid(h)
        h = rb(h, temb)

        # --- upsampling -----------------------------------------------------
        pyramid = None
        for i_level in reversed(range(self.num_resolutions)):
            for i_block in range(self.num_res_blocks + 1):
                h = rb(torch.cat([h, hs.pop()], dim=-1), temb)
            if hasattr(self, f"attn_u{i_level}"):
                h = getattr(self, f"attn_u{i_level}")(h)
            if self.progressive == "output_skip":
                pyramid_h = getattr(self, f"pyr_conv_{i_level}")(
                    act(getattr(self, f"pyr_norm_{i_level}")(h)))
                if i_level == self.num_resolutions - 1:
                    pyramid = pyramid_h
                else:
                    pyramid = getattr(self, f"pyr_up_{i_level}")(pyramid) \
                        + pyramid_h
            elif self.progressive == "residual":
                if i_level == self.num_resolutions - 1:
                    pyramid = getattr(self, f"pyr_conv_{i_level}")(
                        act(getattr(self, f"pyr_norm_{i_level}")(h)))
                else:
                    pyramid = self._skip(getattr(
                        self, f"pyr_up_{i_level}")(pyramid) + h)
                    h = pyramid
            if i_level != 0:
                if self.resblock_type == "ddpm":
                    h = getattr(self, f"up_{i_level}")(h)
                else:
                    h = rb(h, temb)

        if self.progressive == "output_skip":
            h = pyramid
        else:
            h = self.conv_out(act(self.norm_out(h)))

        if self.scale_by_sigma:
            h = h / used_sigmas.reshape(-1, *([1] * (h.ndim - 1)))
        return h

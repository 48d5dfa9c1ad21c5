"""DDPM score UNet (continuous stack), registered "ddpm".

Port of inverseproblemwithdiffusionmodel_tpu/models/ddpm.py: sinusoidal
timestep embedding, DDPM residual blocks with attention at the configured
resolutions, nearest-neighbour / strided-conv resampling, and the optional
`scale_by_sigma` division. `forward(x, labels)` takes channel-last x (N, H,
W, C) and returns the same layout. Modules carry the Flax names
(`conv_in`, `res_<i>`, `attn_d<level>_<block>`, `attn_mid`, `attn_u<level>`,
`down_<level>`, `up_<level>`, `temb_dense0/1`, `norm_out`, `conv_out`), so
utils/convert.flax_to_torch_ddpm maps a Flax tree name by name.
"""
from __future__ import annotations

import functools

import torch
import torch.nn as nn

from . import layerspp
from .layers import get_act
from ..samplers.sigmas import sigma_ladder

conv3x3 = layerspp.ddpm_conv3x3

# The original DDPM UNet pins GroupNorm to 32 groups at every width, unlike
# NCSN++'s min(ch // 4, 32).
_GROUPS = 32


class DDPM(nn.Module):
    """DDPM UNet (reference: models/ddpm.py:40)."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        m = config.model
        self.act = act = get_act(config)
        self.nf = nf = m.nf
        ch_mult = tuple(m.ch_mult)
        self.num_res_blocks = num_res_blocks = m.num_res_blocks
        self.num_resolutions = num_resolutions = len(ch_mult)
        resolutions = [config.data.image_size // (2 ** i)
                       for i in range(num_resolutions)]
        attn_resolutions = tuple(m.attn_resolutions)
        self.conditional = m.conditional
        self.centered = config.data.centered
        self.scale_by_sigma = m.scale_by_sigma
        channels = config.data.num_channels
        with_conv = m.resamp_with_conv

        ResnetBlock = functools.partial(
            layerspp.ResnetBlockDDPMpp, act=act, dropout=m.dropout,
            skip_rescale=False, num_groups=_GROUPS,
            temb_dim=4 * nf if self.conditional else None)
        AttnBlock = functools.partial(layerspp.AttnBlockpp,
                                      skip_rescale=False, init_scale=0.0,
                                      num_groups=_GROUPS)
        if self.conditional:
            self.temb_dense0 = layerspp.dense(nf, nf * 4)
            self.temb_dense1 = layerspp.dense(nf * 4, nf * 4)
        if self.scale_by_sigma:
            self.register_buffer(
                "sigmas", sigma_ladder(m.sigma_max, m.sigma_min,
                                       m.num_scales, "geometric"),
                persistent=False)

        # --- modules, in the order forward() uses them -------------------
        blocks = 0

        def add_rb(in_ch, **kw):
            nonlocal blocks
            self.add_module(f"res_{blocks}", ResnetBlock(in_ch=in_ch, **kw))
            blocks += 1

        self.conv_in = conv3x3(channels, nf)
        hs_ch = [nf]
        in_ch = nf
        for i_level in range(num_resolutions):
            for i_block in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                add_rb(in_ch, out_ch=out_ch)
                in_ch = out_ch
                if resolutions[i_level] in attn_resolutions:
                    self.add_module(f"attn_d{i_level}_{i_block}",
                                    AttnBlock(in_ch))
                hs_ch.append(in_ch)
            if i_level != num_resolutions - 1:
                self.add_module(f"down_{i_level}", layerspp.Downsample(
                    in_ch=in_ch, with_conv=with_conv))
                hs_ch.append(in_ch)

        add_rb(in_ch)
        self.attn_mid = AttnBlock(in_ch)
        add_rb(in_ch)

        for i_level in reversed(range(num_resolutions)):
            for i_block in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                add_rb(in_ch + hs_ch.pop(), out_ch=out_ch)
                in_ch = out_ch
            if resolutions[i_level] in attn_resolutions:
                self.add_module(f"attn_u{i_level}", AttnBlock(in_ch))
            if i_level != 0:
                self.add_module(f"up_{i_level}", layerspp.Upsample(
                    in_ch=in_ch, with_conv=with_conv))
        self.norm_out = layerspp.GroupNorm(in_ch, _GROUPS)
        self.conv_out = conv3x3(in_ch, channels, init_scale=0.0)

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        act = self.act
        if self.conditional:
            # float32 sinusoids in x's dtype, as NCSN++'s positional
            # embedding
            temb = layerspp.get_timestep_embedding(labels, self.nf).to(
                x.dtype)
            temb = self.temb_dense1(act(self.temb_dense0(temb)))
        else:
            temb = None
        h = x if self.centered else 2 * x - 1.0

        blocks = 0

        def rb(h):
            nonlocal blocks
            out = getattr(self, f"res_{blocks}")(h, temb)
            blocks += 1
            return out

        hs = [self.conv_in(h)]
        for i_level in range(self.num_resolutions):
            for i_block in range(self.num_res_blocks):
                h = rb(hs[-1])
                attn = getattr(self, f"attn_d{i_level}_{i_block}", None)
                if attn is not None:
                    h = attn(h)
                hs.append(h)
            if i_level != self.num_resolutions - 1:
                hs.append(getattr(self, f"down_{i_level}")(hs[-1]))

        h = rb(hs[-1])
        h = self.attn_mid(h)
        h = rb(h)

        for i_level in reversed(range(self.num_resolutions)):
            for i_block in range(self.num_res_blocks + 1):
                h = rb(torch.cat([h, hs.pop()], dim=-1))
            attn = getattr(self, f"attn_u{i_level}", None)
            if attn is not None:
                h = attn(h)
            if i_level != 0:
                h = getattr(self, f"up_{i_level}")(h)

        h = self.conv_out(act(self.norm_out(h)))
        if self.scale_by_sigma:
            # clamped at the ladder's end, as JAX's gather
            used = self.sigmas[labels.long().clamp(max=len(self.sigmas) - 1)]
            h = h / used.reshape(-1, *([1] * (h.ndim - 1)))
        return h

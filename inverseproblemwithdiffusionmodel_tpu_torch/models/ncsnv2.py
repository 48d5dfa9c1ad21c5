"""NCSNv2 score networks, NCHW.

Port of inverseproblemwithdiffusionmodel_tpu/models/ncsnv2.py (reference:
ncsn/models/ncsnv2.py, NCSNv2 :11-101, NCSNv2Deeper :104-195,
NCSNv2Deepest :198-299): residual stages (dilations 1/1/2/4) and a
RefineNet decoder; the input goes through 2x - 1 unless the data are
centered; the output is divided by the per-sample noise level.

`forward(x, used_sigmas)` takes x as (B, C, H, W) and the sigma VALUES
(B,), not ladder labels. With ndim=1 the same family runs on (B, C, T)
pixel tubes (models/ncsn1d.py, the temporal prior), and NCSNv2 at ndim=3
on 2D+time volumes (models/ncsn3d.NCSN3D), as in the JAX package. The
JAX package is channel-last; for the C = 1 of the MRI configs an NHWC
(B, H, W, 1) tensor and its contiguous NCHW form share their memory, so
the samplers keep the JAX axis order and hand the
net a view (models/registry.make_score_fn). The view must carry NCHW
strides: given channels-last strides, torch runs the convolutions in
NHWC instead (PERF.md).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv, RefineBlock, ResidualBlock, centered_input, get_act
from .normalization import get_normalization


def _divide_by_sigmas(out: torch.Tensor, used_sigmas: torch.Tensor
                      ) -> torch.Tensor:
    return out / used_sigmas.reshape(-1, *([1] * (out.ndim - 1)))


class _NCSNv2Family(nn.Module):
    """begin_conv, residual stages of two blocks each (`<stage>_0` resamples
    where the stage says so, `<stage>_1` does not), RefineBlocks from the
    deepest stage up, then normalizer, activation, end_conv.

    STAGES: (name, width in ngf, resample, dilation) per stage, shallow to
    deep. REFINES: (name, width in ngf) per RefineBlock, deep to shallow.
    """
    STAGES = ()
    REFINES = ()

    def __init__(self, config, ndim: int = 2):
        super().__init__()
        self.config = config
        self.ndim = ndim
        ngf = config.model.ngf
        self.act = act = get_act(config)
        norm = get_normalization(config, conditional=False)
        self.centered = centered_input(config)
        self.begin_conv = Conv(self._io_channels(), ngf, 3, ndim=ndim)
        width = ngf
        self.widths = []
        for name, mult, resample, dilation in self.STAGES:
            adjust = self._adjust_padding(name)
            self.add_module(f"{name}_0", ResidualBlock(
                width, mult * ngf, norm, act, resample=resample,
                dilation=dilation, adjust_padding=adjust, ndim=ndim))
            width = mult * ngf
            self.add_module(f"{name}_1", ResidualBlock(
                width, width, norm, act, dilation=dilation, ndim=ndim))
            self.widths.append(width)
        ref_width = None
        last = len(self.REFINES) - 1
        for i, ((name, mult), width) in enumerate(
                zip(self.REFINES, reversed(self.widths))):
            planes = [width] if ref_width is None else [width, ref_width]
            self.add_module(name, RefineBlock(planes, mult * ngf, act,
                                              start=i == 0, end=i == last,
                                              ndim=ndim))
            ref_width = mult * ngf
        self.normalizer = norm(ngf)
        self.end_conv = Conv(ngf, self._io_channels(), 3, ndim=ndim)

    def _io_channels(self) -> int:
        """The net's input and output channels."""
        return self.config.data.channels

    def _adjust_padding(self, stage: str) -> bool:
        return False

    def forward(self, x: torch.Tensor, used_sigmas: torch.Tensor
                ) -> torch.Tensor:
        h = x if self.centered else 2 * x - 1.0
        h = self.begin_conv(h)
        layers = []
        for name, *_ in self.STAGES:
            h = getattr(self, f"{name}_0")(h)
            h = getattr(self, f"{name}_1")(h)
            layers.append(h)
        ref = None
        for (name, _), layer in zip(self.REFINES, reversed(layers)):
            xs = [layer] if ref is None else [layer, ref]
            ref = getattr(self, name)(xs, layer.shape[2:])
        out = self.end_conv(self.act(self.normalizer(ref)))
        return _divide_by_sigmas(out, used_sigmas)


class NCSNv2(_NCSNv2Family):
    """4-stage NCSNv2 (reference: ncsnv2.py:11-101)."""
    STAGES = (("res1", 1, None, None), ("res2", 2, "down", None),
              ("res3", 2, "down", 2), ("res4", 2, "down", 4))
    REFINES = (("refine1", 2), ("refine2", 2), ("refine3", 1),
               ("refine4", 1))

    def _adjust_padding(self, stage: str) -> bool:
        return stage == "res4" and self.config.data.image_size == 28


class NCSNv2Deeper(_NCSNv2Family):
    """5-stage NCSNv2 for 96-128 px (reference: ncsnv2.py:104-195)."""
    STAGES = (("res1", 1, None, None), ("res2", 2, "down", None),
              ("res3", 2, "down", None), ("res4", 4, "down", 2),
              ("res5", 4, "down", 4))
    REFINES = (("refine1", 4), ("refine2", 2), ("refine3", 2),
               ("refine4", 1), ("refine5", 1))


class NCSNv2Deepest(_NCSNv2Family):
    """6-stage NCSNv2 for 256 px, the ACDC prior's net (reference:
    ncsnv2.py:198-299, helpers/load_model.py:24)."""
    STAGES = (("res1", 1, None, None), ("res2", 2, "down", None),
              ("res3", 2, "down", None), ("res31", 2, "down", None),
              ("res4", 4, "down", 2), ("res5", 4, "down", 4))
    REFINES = (("refine1", 4), ("refine2", 2), ("refine31", 2),
               ("refine3", 2), ("refine4", 1), ("refine5", 1))

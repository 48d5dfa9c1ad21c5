"""1-D temporal score networks on pixel tubes (B, C, T).

Port of inverseproblemwithdiffusionmodel_tpu/models/ncsn1d.py (reference:
ncsn/models/ncsn1d.py): NCSN1D, NCSN1DDeeper and NCSN1DDeepest are the
NCSNv2 family at ndim=1, one implementation for both ranks. The cine
reconstruction feeds them tubes of T frames with win^2 channels
(utils/reshape.py). UNET1D (reference: ncsn1d.py:14-36) is the 1-D UNet
divided by sigma.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .ncsnv2 import NCSNv2, NCSNv2Deeper, NCSNv2Deepest, _divide_by_sigmas
from .unet import UNet


def NCSN1D(config) -> NCSNv2:
    return NCSNv2(config, ndim=1)


def NCSN1DDeeper(config) -> NCSNv2Deeper:
    return NCSNv2Deeper(config, ndim=1)


def NCSN1DDeepest(config) -> NCSNv2Deepest:
    return NCSNv2Deepest(config, ndim=1)


class UNET1D(nn.Module):
    """1-D UNet score net divided by sigma (reference: ncsn1d.py:14-36): the
    MONAI UNet at ndim 1 with features (64, 256, 1024, 4196), strides (2,
    2, 2), instance norm unless `training.use_IN` is false, on (B, C, T)
    tubes of `config.data.channels` channels. The UNet is the submodule
    `UNet_0`, the name Flax gives it."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        use_in = bool(config.training.get("use_IN", True))
        C = config.data.channels
        self.UNet_0 = UNet(out_channels=C, features=(64, 256, 1024, 4196),
                           strides=(2, 2, 2), in_channels=C,
                           norm="instance" if use_in else None, ndim=1)

    def forward(self, x: torch.Tensor, used_sigmas: torch.Tensor
                ) -> torch.Tensor:
        return _divide_by_sigmas(self.UNet_0(x), used_sigmas)

"""1-D temporal score networks on pixel tubes (B, C, T).

Port of inverseproblemwithdiffusionmodel_tpu/models/ncsn1d.py (reference:
ncsn/models/ncsn1d.py): NCSN1D, NCSN1DDeeper and NCSN1DDeepest are the
NCSNv2 family at ndim=1, one implementation for both ranks. The cine
reconstruction feeds them tubes of T frames with win^2 channels
(utils/reshape.py). UNET1D (reference: ncsn1d.py:14-36) is not ported.
"""
from __future__ import annotations

from .ncsnv2 import NCSNv2, NCSNv2Deeper, NCSNv2Deepest


def NCSN1D(config) -> NCSNv2:
    return NCSNv2(config, ndim=1)


def NCSN1DDeeper(config) -> NCSNv2Deeper:
    return NCSNv2Deeper(config, ndim=1)


def NCSN1DDeepest(config) -> NCSNv2Deepest:
    return NCSNv2Deepest(config, ndim=1)


def UNET1D(config):
    raise NotImplementedError("UNET1D is not ported yet (ROADMAP: Slice C)")

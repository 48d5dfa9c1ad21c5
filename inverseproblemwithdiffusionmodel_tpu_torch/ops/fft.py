"""Centered orthonormal FFT pair for MR k-space, complex64.

Port of inverseproblemwithdiffusionmodel_tpu/ops/fft.py (reference:
ncsn/linear_transforms/__init__.py:36-57): i2k = fftshift(fftn(ifftshift(
x))), norm "ortho", over the spatial axes of channel-last (B, H, W, C)
tensors. On the card torch.fft runs cuFFT. The real-pair DFT of
ops/fft_pair.py stays beside it for the pair operators and the serving
engines.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

# (B, H, W, C) spatial axes
DEFAULT_AXES: Tuple[int, int] = (-3, -2)


def i2k_complex(x: torch.Tensor, axes: Sequence[int] = DEFAULT_AXES
                ) -> torch.Tensor:
    """Image -> centered k-space (orthonormal), complex64."""
    axes = tuple(axes)
    x = torch.fft.ifftshift(x.to(torch.complex64), dim=axes)
    k = torch.fft.fftn(x, dim=axes, norm="ortho")
    return torch.fft.fftshift(k, dim=axes)


def k2i_complex(k: torch.Tensor, axes: Sequence[int] = DEFAULT_AXES
                ) -> torch.Tensor:
    """Centered k-space -> image (orthonormal), complex64."""
    axes = tuple(axes)
    k = torch.fft.ifftshift(k.to(torch.complex64), dim=axes)
    x = torch.fft.ifftn(k, dim=axes, norm="ortho")
    return torch.fft.fftshift(x, dim=axes)

"""Multi-linear resize, with aligned corners or half-pixel centres, as
interpolation matmuls.

Port of `resize_align_corners` and `resize_half_pixel` from
inverseproblemwithdiffusionmodel_tpu/ops/resize.py. The RefineNet MSF
blocks use the first (reference: ncsn/models/layers.py:182,
`F.interpolate(mode='bilinear', align_corners=True)`); the second is
`F.interpolate(align_corners=False)`, the data pipeline's resize. Each axis is contracted with a dense (out, in)
interpolation matrix built in float64 with numpy, H first, then W, as in
the JAX package; the 1-D RefineNet of the temporal prior resizes its one
axis. `F.interpolate` computes its weights in float32 and
differs from it by up to 4e-6 of values of order one (32 -> 64 px), more
than the 1e-6 it is held to (tests/test_torch_ncsnv2.py).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch


@lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int,
                   align_corners: bool = True) -> np.ndarray:
    """Dense 1-D linear interpolation matrix W, y = W @ x, with aligned
    corners or half-pixel centres (clamped at the edges)."""
    W = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        W[:, 0] = 1.0
        return W
    if align_corners:
        pos = np.arange(out_size) * (in_size - 1) / max(out_size - 1, 1)
    else:
        scale = in_size / out_size
        pos = np.clip((np.arange(out_size) + 0.5) * scale - 0.5, 0.0,
                      in_size - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (pos - lo).astype(np.float32)
    W[np.arange(out_size), lo] += 1.0 - frac
    W[np.arange(out_size), hi] += frac
    return W


@lru_cache(maxsize=None)
def _interp_tensor(in_size: int, out_size: int, dtype: torch.dtype,
                   device: torch.device, align_corners: bool = True
                   ) -> torch.Tensor:
    """`_interp_matrix` as a tensor, made once per dtype and device (no
    host-to-device copy in the forward). Made outside inference mode
    whoever asks first: a cached inference tensor could not be saved for
    the backward of a later call that tracks gradients."""
    with torch.inference_mode(False):
        return torch.as_tensor(_interp_matrix(in_size, out_size,
                                              align_corners),
                               dtype=dtype, device=device)


def _resize(x: torch.Tensor, sizes: Sequence[int],
            axes: Optional[Sequence[int]], align_corners: bool
            ) -> torch.Tensor:
    sizes = [int(s) for s in sizes]
    if axes is None:
        axes = range(x.ndim - len(sizes), x.ndim)
    for size, axis in zip(sizes, (a % x.ndim for a in axes)):
        if x.shape[axis] == size:
            continue
        W = _interp_tensor(x.shape[axis], size, x.dtype, x.device,
                           align_corners)
        if axis == x.ndim - 1:
            x = x @ W.T
        elif axis == x.ndim - 2:
            x = torch.einsum("oh,...hw->...ow", W, x)
        else:
            x = torch.movedim(torch.movedim(x, axis, -1) @ W.T, -1, axis)
    return x


def resize_align_corners(x: torch.Tensor, sizes: Sequence[int],
                         axes: Optional[Sequence[int]] = None
                         ) -> torch.Tensor:
    """Resize the `axes` of x to `sizes`, in order, in x's dtype; an axis
    whose size already matches is left alone. `axes` defaults to the
    trailing len(sizes) axes: the spatial axes of an NCHW (or NCT)
    tensor."""
    return _resize(x, sizes, axes, align_corners=True)


def resize_half_pixel(x: torch.Tensor, sizes: Sequence[int],
                      axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`resize_align_corners` with half-pixel centres: torch
    F.interpolate(align_corners=False), the standard linear resize."""
    return _resize(x, sizes, axes, align_corners=False)

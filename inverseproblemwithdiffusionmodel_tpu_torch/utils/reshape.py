"""Pixel-tube reshapes of the 2D+time (cine) sampler.

Port of `reshape_temporal_dim` and `apply_in_tube_space` from
inverseproblemwithdiffusionmodel_tpu/utils/reshape.py (reference:
helpers/utils.py:330-359, ALD_optimizers.py:452-502). A tube is the time
course of a kx x ky pixel window: forward, (N, T, H, W) -> (N H1 W1, T,
kx ky), channel-last as in the JAX package; backward is its inverse.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .device import Shift


def reshape_temporal_dim(x: torch.Tensor, kx: int, ky: int,
                         direction: str = "forward",
                         img_size: Optional[Tuple[int, int]] = None
                         ) -> torch.Tensor:
    """forward: (N, T, H, W) -> (N * H/kx * W/ky, T, kx * ky); backward:
    the inverse, given the image size (H, W)."""
    if direction == "forward":
        N, T, H, W = x.shape
        if H % kx or W % ky:
            raise ValueError(f"window ({kx}, {ky}) does not tile ({H}, {W})")
        t = x.reshape(N, T, H // kx, kx, W // ky, ky)
        return t.permute(0, 2, 4, 1, 3, 5).reshape(-1, T, kx * ky)
    if direction != "backward" or img_size is None:
        raise ValueError("direction is 'forward', or 'backward' with "
                         "img_size")
    H, W = img_size
    _, T, _ = x.shape
    t = x.reshape(-1, H // kx, W // ky, T, kx, ky)
    return t.permute(0, 3, 1, 4, 2, 5).reshape(-1, T, H, W)


def apply_in_tube_space(fn: Callable, arrays: Sequence[torch.Tensor],
                        win_size: int, shift: Optional[Shift] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """Apply `fn` to the pixel tubes of (B, T, H, W, C) arrays, all
    transformed alike: channels into the batch, (B C, T, H, W); rolled by
    shift(win_size) = (sh, sw) over (H, W) where a shift is given (window
    de-aliasing); tubes (B', T, win^2). `fn(*tubes)` returns tubes of the
    same shapes, which go back through the inverse, the roll undone. The
    JAX package draws the shift from a PRNG key; here it is a host pair,
    so the roll needs no device read."""
    B, T, H, W, C = arrays[0].shape
    sh = sw = 0
    if shift is not None:
        sh, sw = (int(v) for v in shift(win_size))

    def fwd(a):
        fr = a.movedim(-1, 1).reshape(B * C, T, H, W)
        if sh or sw:
            fr = torch.roll(fr, (sh, sw), dims=(-2, -1))
        return reshape_temporal_dim(fr, win_size, win_size)

    def bwd(t):
        fr = reshape_temporal_dim(t, win_size, win_size, "backward",
                                  img_size=(H, W))
        if sh or sw:
            fr = torch.roll(fr, (-sh, -sw), dims=(-2, -1))
        return fr.reshape(B, C, T, H, W).movedim(1, -1)

    return tuple(bwd(t) for t in fn(*(fwd(a) for a in arrays)))

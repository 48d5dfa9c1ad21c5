"""The device an entry point runs on, and the seeded noise and shift
sources the samplers draw from."""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

Noise = Callable[[Sequence[int]], torch.Tensor]
# `shift(win) -> (sh, sw)`: the random spatial roll of one temporal step of
# the cine sampler, host ints in [0, win)
Shift = Callable[[int], Tuple[int, int]]


def resolve_device(device) -> torch.device:
    """torch.device(device); raises for a CUDA device where torch sees
    none (no quiet fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}, but torch sees no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return device


def gaussian_noise(seed: int, device) -> Noise:
    """`noise(shape)`: standard normal float32 draws on `device` from a
    torch.Generator there, seeded with `seed`."""
    gen = torch.Generator(device).manual_seed(seed)

    def noise(shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=gen, device=device)

    return noise


def random_shift(seed: int) -> Shift:
    """`shift(win) -> (sh, sw)`: two ints in [0, win) per call, drawn on
    the host from a torch.Generator seeded with `seed` (host ints need no
    device read)."""
    gen = torch.Generator().manual_seed(seed)

    def shift(win: int):
        sh, sw = torch.randint(0, win, (2,), generator=gen).tolist()
        return sh, sw

    return shift

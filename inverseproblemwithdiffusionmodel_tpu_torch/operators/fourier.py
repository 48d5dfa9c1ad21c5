"""Undersampled-Fourier forward operators (single-coil and SENSE
multi-coil), complex64.

Port of inverseproblemwithdiffusionmodel_tpu/operators/fourier.py
(reference: ncsn/linear_transforms/undersampling_fourier.py).
Channel-last complex64 images (B, H, W, C). Masks select k-space columns
(phase-encode lines along W) and broadcast over rows; per-frame cine masks
carry a leading frame axis that broadcasts against the batch. SENSE
evaluates all coils at once, a broadcast multiply and one batched FFT over
a coil axis. Masks and coil maps are made with numpy, bit-identical to the
JAX package's for a seed; the real-pair forms are in operators/pair.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import LinearTransform
from .masking import SkipLines
from .masks import generate_mask, random_cartesian_mask
from ..ops.fft import i2k_complex, k2i_complex

# Variable-density mask presets keyed by acceleration factor R
# (reference: undersampling_fourier.py:63-75).
MASK_PRESETS = {
    8: dict(sw=0.196, sm=0.5, sa=0.02),
    16: dict(sw=0.07926, sm=0.42, sa=0.02),
    20: dict(sw=0.07, sm=0.3, sa=0.01782),
}


@dataclasses.dataclass(frozen=True)
class UndersamplingFourier(LinearTransform):
    """Centered FFT followed by row decimation
    (reference: undersampling_fourier.py:10-36)."""
    skip_lines: SkipLines

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.skip_lines(i2k_complex(x))

    def conj_op(self, s: torch.Tensor) -> torch.Tensor:
        return k2i_complex(self.skip_lines.conj_op(s.to(torch.complex64)))

    @classmethod
    def create(cls, num_skip_lines: int, height: int
               ) -> "UndersamplingFourier":
        return cls(skip_lines=SkipLines(num_skip_lines=num_skip_lines,
                                        height=height))


@dataclasses.dataclass(frozen=True)
class RandomUndersamplingFourier(LinearTransform):
    """Variable-density masked centered FFT
    (reference: undersampling_fourier.py:39-97).

    mask: float32, broadcastable to the k-space of x - (1, 1, W, 1) for a
    static mask or (T, 1, W, 1) for per-frame cine masks (then batch == T
    frames, as in the 2D+time sampler).
    """
    mask: torch.Tensor

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask * i2k_complex(x)

    def conj_op(self, s: torch.Tensor) -> torch.Tensor:
        return k2i_complex(s.to(torch.complex64))

    def projection(self, x: torch.Tensor, s: torch.Tensor, lamda: float
                   ) -> torch.Tensor:
        """k-space replacement mixture (reference:
        undersampling_fourier.py:89-97): sampled lines blend toward the
        measurement, unsampled lines keep the estimate."""
        k_from_x = i2k_complex(x)
        mixed = lamda * s + (1.0 - lamda) * self.mask * k_from_x
        untouched = (1.0 - self.mask) * k_from_x
        return k2i_complex(mixed + untouched)

    @classmethod
    def create(cls, R: int, center_lines_frac: float,
               in_shape: Tuple[int, ...], seed: Optional[int] = None,
               num_frames: int = 24, mask_type: str = "vd"
               ) -> "RandomUndersamplingFourier":
        """in_shape: (H, W, C). mask_type 'vd' builds the per-frame
        variable-density masks (reference default, T = 24 frames);
        'uniform' builds a single uniform-random line mask. On the CPU."""
        H, W, C = in_shape
        if mask_type == "vd":
            preset = MASK_PRESETS.get(int(R))
            if preset is None:
                raise ValueError(f"no VD mask preset for R={R}; available: "
                                 f"{sorted(MASK_PRESETS)}")
            m = generate_mask(num_frames, W, seed=seed, **preset)
            m = m.reshape(-1, 1, W, 1)  # (T, 1, W, 1)
        elif mask_type == "uniform":
            m = random_cartesian_mask(W, R, center_lines_frac, seed=seed)
            m = m.reshape(1, 1, W, 1)
        else:
            raise ValueError(f"unknown mask_type {mask_type!r}")
        return cls(mask=torch.as_tensor(m, dtype=torch.float32))


def _exp_sens_map(H: int, W: int, seed: Optional[int]) -> np.ndarray:
    """Exponential-kernel synthetic coil sensitivity anchored at a random
    pixel (reference: undersampling_fourier.py:119-138). Returns (H, W)
    float32."""
    rng = np.random.RandomState(seed)
    anchor_h, anchor_w = rng.choice(H), rng.choice(W)
    hh, ww = np.mgrid[0:H, 0:W]
    dist = np.sqrt((hh - anchor_h) ** 2 + (ww - anchor_w) ** 2)
    l = dist.max() / 2.0
    return np.exp(-dist / (2.0 * l)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SENSE(LinearTransform):
    """Multi-coil SENSE forward operator
    (reference: undersampling_fourier.py:100-176).

    sens_maps: (num_sens, H, W, 1) complex64, SOS-normalized so that
    sum_i |S_i|^2 == 1 everywhere. Forward output: (num_sens, B, H, W, C).
    """
    base: RandomUndersamplingFourier
    sens_maps: torch.Tensor

    @property
    def num_sens(self) -> int:
        return self.sens_maps.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # (num_sens, 1, H, W, 1) * (B, H, W, C) -> (num_sens, B, H, W, C)
        coil_imgs = self.sens_maps[:, None] * x[None]
        return self.base.mask * i2k_complex(coil_imgs)

    def conj_op(self, s: torch.Tensor) -> torch.Tensor:
        """(num_sens, B, H, W, C) -> (B, H, W, C). No mask: measurements
        live on its support (as the reference's SkipLines zero-pad
        adjoint)."""
        imgs = k2i_complex(s.to(torch.complex64))
        return torch.sum(self.sens_maps.conj()[:, None] * imgs, dim=0)

    def ssos(self, s: torch.Tensor) -> torch.Tensor:
        """Root sum-of-squares coil combine (reference:
        undersampling_fourier.py:162-170)."""
        imgs = k2i_complex(s.to(torch.complex64))
        return torch.sqrt(torch.sum(torch.abs(imgs) ** 2, dim=0))


def make_sense(sens_type: str, num_sens: int, R: int,
               center_lines_frac: float, in_shape: Tuple[int, ...],
               seed: Optional[int] = None, num_frames: int = 24,
               mask_type: str = "vd") -> SENSE:
    """A SENSE operator with synthetic SOS-normalized coil maps
    (reference: undersampling_fourier.py:101-117), on the CPU."""
    if sens_type != "exp":
        raise ValueError(f"unknown coil-map family {sens_type!r} (exp)")
    H, W, C = in_shape
    base = RandomUndersamplingFourier.create(
        R, center_lines_frac, in_shape, seed=seed, num_frames=num_frames,
        mask_type=mask_type)
    maps = np.stack([
        # seed=None stays None (fresh maps per call, like the reference's
        # un-seeded torch draws, undersampling_fourier.py:104-110); only a
        # given seed is offset per coil
        _exp_sens_map(H, W, None if seed is None else seed + i)
        for i in range(num_sens)
    ], axis=0)  # (num_sens, H, W)
    norm = np.sqrt((np.abs(maps) ** 2).sum(axis=0, keepdims=True))
    maps = maps / norm
    energy = (np.abs(maps) ** 2).sum(axis=0)
    if not np.allclose(energy, 1.0, atol=1e-5):
        raise AssertionError("coil-map energy must be 1")
    sens = torch.as_tensor(maps[..., None].astype(np.complex64))
    return SENSE(base=base, sens_maps=sens)

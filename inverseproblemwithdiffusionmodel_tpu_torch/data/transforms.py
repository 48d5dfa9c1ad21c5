"""Host-side numpy data transforms (MONAI-free).

A copy of inverseproblemwithdiffusionmodel_tpu/data/transforms.py:18-97
(numpy and scipy.ndimage; the port imports nothing of the JAX package).
The slices of MONAI the reference's ACDC pipeline uses (reference:
helpers/load_data.py:206-283: ScaleIntensityd, CropForegroundd,
RandRotated, RandAdjustContrastd, RandGaussianNoised, Resized) plus the
CINE resize. Augmentations take an explicit np.random.RandomState. Layout:
(C, H, W) per sample, made channel-last at dataset assembly.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def scale_intensity(img: np.ndarray) -> np.ndarray:
    """Min-max scale to [0, 1] (MONAI ScaleIntensity default)."""
    lo, hi = img.min(), img.max()
    if hi - lo < 1e-12:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo)


def crop_foreground(img: np.ndarray, *others: np.ndarray,
                    source: Optional[np.ndarray] = None, margin: int = 0):
    """Crop all arrays to the bounding box where `source` > 0
    (MONAI CropForeground). Arrays are (C, H, W); returns tuple in order."""
    src = img if source is None else source
    mask = src > 0
    if not mask.any():
        return (img, *others) if others else img
    idx = np.nonzero(mask.any(axis=0))
    h0, h1 = idx[0].min(), idx[0].max() + 1
    w0, w1 = idx[1].min(), idx[1].max() + 1
    h0, w0 = max(h0 - margin, 0), max(w0 - margin, 0)
    h1, w1 = h1 + margin, w1 + margin
    out = tuple(a[:, h0:h1, w0:w1] for a in (img, *others))
    return out if others else out[0]


def resize(img: np.ndarray, spatial_size: Sequence[int],
           mode: str = "bilinear") -> np.ndarray:
    """Resize the trailing spatial dims of (C, *spatial) (MONAI Resized).
    mode: 'bilinear' (order=1) or 'nearest' (order=0)."""
    order = 1 if mode == "bilinear" else 0
    spatial = img.shape[1:]
    zoom = [1.0] + [t / s for t, s in zip(spatial_size, spatial)]
    out = ndimage.zoom(img, zoom, order=order, grid_mode=True,
                       mode="grid-constant")
    # guard rounding: force exact target shape
    slices = tuple(slice(0, t) for t in (img.shape[0], *spatial_size))
    if out.shape != (img.shape[0], *spatial_size):
        pad = [(0, max(0, t - s)) for t, s in
               zip((img.shape[0], *spatial_size), out.shape)]
        out = np.pad(out, pad, mode="edge")[slices]
    return out


def rand_rotate(img: np.ndarray, label: Optional[np.ndarray],
                rng: np.random.RandomState, range_deg: float = 15.0,
                prob: float = 0.5):
    """Random in-plane rotation; bilinear image / nearest label
    (MONAI RandRotated)."""
    if rng.rand() >= prob:
        return img, label
    angle = rng.uniform(-range_deg, range_deg)
    out = ndimage.rotate(img, angle, axes=(1, 2), reshape=False, order=1,
                         mode="constant")
    lab = None
    if label is not None:
        lab = ndimage.rotate(label, angle, axes=(1, 2), reshape=False,
                             order=0, mode="constant")
    return out, lab


def rand_adjust_contrast(img: np.ndarray, rng: np.random.RandomState,
                         gamma_range: Tuple[float, float] = (0.5, 4.5),
                         prob: float = 0.5) -> np.ndarray:
    """Random gamma adjustment (MONAI RandAdjustContrast)."""
    if rng.rand() >= prob:
        return img
    gamma = rng.uniform(*gamma_range)
    lo, hi = img.min(), img.max()
    if hi - lo < 1e-12:
        return img
    norm = (img - lo) / (hi - lo)
    return norm ** gamma * (hi - lo) + lo


def rand_gaussian_noise(img: np.ndarray, rng: np.random.RandomState,
                        mean: float = 0.0, std: float = 0.5,
                        prob: float = 0.1) -> np.ndarray:
    if rng.rand() >= prob:
        return img
    return img + rng.normal(mean, std, img.shape).astype(img.dtype)

"""Batch collation for the training steps, the synthetic phase, the 1-D
foreground filter, the Re/Im interleave of the inverse samplers, and the
data scaling and normalization helpers.

Port of inverseproblemwithdiffusionmodel_tpu/utils/misc.py: `collate_batch`,
`add_phase`, `filter_batch`, `stack_parts`, `unstack_parts`,
`undersample_seg_mask` (reference: helpers/load_data.py:324-440,
helpers/utils.py:314-327), and `expand_like`, `logit_transform`,
`data_transform`, `inverse_data_scaler`, `normalize`, `denormalize`,
`normalize_phase`, `compute_angle` (reference: helpers/utils.py:20-36,
212-226, 276-305, 402-410). The random draws (a global phase per sample, a
low-resolution phase patch, the kept seg pixels, the dequantization noise)
come from a torch.Generator on the batch's device unless they are given:
tests feed the numbers JAX draws.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import DATA_MODES as MODES
from ..ops.resize import resize_align_corners


def stack_parts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interleave two (B, ...) batches into (2B, ...): row 2i is a[i], row
    2i+1 is b[i] (not a concatenation). The inverse samplers batch the Re
    and Im score evaluations into one forward this way."""
    return torch.stack([a, b], dim=1).reshape(-1, *a.shape[1:])


def unstack_parts(x: torch.Tensor):
    """Inverse of `stack_parts`: (2B, ...) -> two (B, ...) tensors."""
    pair = x.reshape(-1, 2, *x.shape[1:])
    return pair[:, 0], pair[:, 1]


def _rotate(x: torch.Tensor, phase: torch.Tensor) -> List[torch.Tensor]:
    """[Re, Im] of x * exp(i phase) for real x: x cos(phase), x sin(phase),
    which is what the complex product of the JAX package computes."""
    return [x * torch.cos(phase), x * torch.sin(phase)]


def add_phase(imgs: torch.Tensor, generator: Optional[torch.Generator] = None,
              init_shape: Sequence[int] = (5, 5), mode: str = "spatial",
              patch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """imgs * exp(i phase), complex64, with a smooth random phase map: a
    standard normal low-resolution patch resized with aligned corners
    (reference: helpers/load_data.py:372-397; linear where the reference
    is bicubic, as in the JAX package).

    mode 'spatial': imgs (B, H, W, C), patch (B, *init_shape, C), one map
    per sample. mode '2D+time': imgs (T, H, W, C), init_shape (it, ih, iw),
    patch (it, ih, iw, C), one volume resized over (T, H, W). The patch is
    drawn from `generator` unless given.
    """
    if mode not in ("spatial", "2D+time"):
        raise ValueError(f"unknown phase mode {mode!r}")
    if mode == "spatial":
        B, H, W, C = imgs.shape
        shape, sizes, axes = (B, *init_shape[:2], C), (H, W), (1, 2)
    else:
        if len(init_shape) != 3:
            raise ValueError("mode '2D+time' takes init_shape (it, ih, iw)")
        T, H, W, C = imgs.shape
        shape, sizes, axes = (*init_shape, C), (T, H, W), (0, 1, 2)
    if patch is None:
        patch = torch.randn(shape, generator=generator, device=imgs.device)
    phase = resize_align_corners(patch, sizes, axes=axes)
    return torch.complex(*_rotate(imgs.float(), phase))


def collate_batch(batch: torch.Tensor, mode: str = "real-valued",
                  generator: Optional[torch.Generator] = None,
                  phi: Optional[torch.Tensor] = None,
                  patch: Optional[torch.Tensor] = None):
    """Prepare a real-valued batch (B, H, W, 1) or (B, T, C) for a data
    mode:
    - 'real-valued', 'mag': unchanged;
    - 'complex': a zero imaginary channel appended, (B, H, W, 2);
    - 'real-imag': times exp(i phi), one global phase per sample, phi ~
      U(-pi, pi) of shape (B,) -> the list [Re, Im];
    - 'real-imag-random': times a smooth phase map (`add_phase`, images
      only; `patch` its (B, 5, 5, C) draw) -> [Re, Im].
    """
    if mode not in MODES:
        raise ValueError(f"unknown data mode {mode!r}; one of {MODES}")
    if mode in ("real-valued", "mag"):
        return batch
    if mode == "complex":
        if batch.ndim != 4:
            raise ValueError("mode 'complex' expects image batches")
        return torch.cat([batch, torch.zeros_like(batch)], dim=-1)
    if mode == "real-imag":
        if phi is None:
            phi = (torch.rand(batch.shape[0], generator=generator,
                              device=batch.device) * 2 - 1) * math.pi
        phi = phi.reshape(-1, *([1] * (batch.ndim - 1)))
        return _rotate(batch, phi)
    if batch.ndim != 4:
        raise ValueError("mode 'real-imag-random' expects image batches")
    z = add_phase(batch, generator, patch=patch)
    return [z.real, z.imag]


def filter_batch(batch: torch.Tensor, th: float,
                 generator: Optional[torch.Generator] = None,
                 keep_prob: float = 0.0) -> torch.Tensor:
    """TV-norm foreground weight of 1-D tube batches (B, T, C), float32
    (B,): 1 where the mean absolute temporal difference (circular) exceeds
    `th`, else 0; rows 0 and 1 always 1 (reference: helpers/load_data.py:
    417-440, which drops the rows; a weight of 0 gives the same expected
    gradient). With keep_prob > 0 a row is also kept with that
    probability, drawn from `generator`. Other ranks: all ones."""
    if batch.ndim != 3:
        return torch.ones(batch.shape[0], device=batch.device)
    B, T, C = batch.shape
    norm = torch.sum(torch.abs(torch.roll(batch, -1, dims=1) - batch),
                     dim=(1, 2)) / (C * T)
    mask = norm > th
    if keep_prob > 0:
        mask = mask | (torch.rand(B, generator=generator,
                                  device=batch.device) <= keep_prob)
    mask[0:2] = True
    return mask.float()


def undersample_seg_mask(label: torch.Tensor, fraction: float,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Keep exactly max(1, int(num_foreground * fraction)) of the
    foreground (> 0) pixels of `label`, chosen uniformly: the kept pixels
    are 1, all others 0, in label's dtype and shape (reference:
    helpers/utils.py:314-327 randperm-selects that count). The uniform
    ranks come from `generator`, on label's device."""
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(f"fraction {fraction} outside [0, 1]")
    flat = label.reshape(-1)
    fg = flat > 0
    k = torch.clamp_min(torch.floor(fg.sum() * fraction).long(), 1)
    # foreground pixels ranked by i.i.d. uniforms; keep the k best ranks
    scores = torch.where(fg, torch.rand(flat.shape, generator=generator,
                                        device=flat.device), torch.inf)
    ranks = torch.empty_like(flat, dtype=torch.long)
    ranks[torch.argsort(scores)] = torch.arange(flat.numel(),
                                                device=flat.device)
    kept = ((ranks < k) & fg).to(flat.dtype)
    return kept.reshape(label.shape)


def expand_like(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) matching `like`'s rank."""
    return v.reshape(v.shape[0], *([1] * (like.ndim - 1)))


def logit_transform(image: torch.Tensor, lam: float = 1e-6) -> torch.Tensor:
    image = lam + (1 - 2 * lam) * image
    return torch.log(image) - torch.log1p(-image)


def data_transform(config, X: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """The input scaling pipeline (reference: helpers/utils.py:212-226):
    uniform then Gaussian dequantization where the config asks for them
    (drawn from `generator`, on X's device), then 2x - 1 (rescaled) or the
    logit transform, then the config's `image_mean` subtracted where it
    has one."""
    if config.data.uniform_dequantization:
        X = X / 256.0 * 255.0 + torch.rand(
            X.shape, generator=generator, dtype=X.dtype,
            device=X.device) / 256.0
    if config.data.gaussian_dequantization:
        X = X + torch.randn(X.shape, generator=generator, dtype=X.dtype,
                            device=X.device) * 0.01
    if config.data.rescaled:
        X = 2 * X - 1.0
    elif config.data.logit_transform:
        X = logit_transform(X)
    image_mean = config.get("image_mean") if hasattr(config, "get") else None
    if image_mean is not None:
        X = X - torch.as_tensor(np.asarray(image_mean), dtype=X.dtype,
                                device=X.device)[None, ...]
    return X


def inverse_data_scaler(is_centered: bool):
    """(reference: helpers/utils.py:30-36)."""
    if is_centered:
        return lambda x: (x + 1.0) / 2.0
    return lambda x: x


def normalize(img: torch.Tensor, low_q: float = 0.02, high_q: float = 0.98,
              return_q: bool = False):
    """Quantile normalization to [0, 1], the quantiles linearly
    interpolated as jnp.quantile's (reference: helpers/utils.py:287-297)."""
    if not 0 <= low_q < high_q <= 1:
        raise ValueError(f"quantiles {low_q}, {high_q}: need 0 <= low < "
                         "high <= 1")
    flat = img.reshape(-1)
    low_val, high_val = torch.quantile(
        flat, torch.tensor([low_q, high_q], dtype=flat.dtype,
                           device=flat.device))
    out = torch.clamp((img - low_val) / (high_val - low_val), 0.0, 1.0)
    if return_q:
        return out, low_val, high_val
    return out


def denormalize(img: torch.Tensor, a_min: float, a_max: float
                ) -> torch.Tensor:
    """(reference: helpers/utils.py:300-305; a_max unused there too)."""
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo) + a_min


def normalize_phase(x_phase: torch.Tensor) -> torch.Tensor:
    """(reference: helpers/utils.py:402-410)."""
    return (x_phase - math.pi) / (2 * math.pi)


def compute_angle(img, if_normalize: bool = False) -> np.ndarray:
    """Phase map of a complex image, optionally min-max normalized; host
    numpy (reference: helpers/utils.py:276-285)."""
    img = img.cpu().numpy() if isinstance(img, torch.Tensor) else img
    angle = np.angle(np.asarray(img))
    if if_normalize:
        angle = angle - angle.min()
        angle = angle / angle.max()
    return angle

"""Reconstruction quality metrics (NRMSE / SSIM / L1 / L2 / SNR) on torch
tensors.

Port of inverseproblemwithdiffusionmodel_tpu/utils/metrics.py (reference:
helpers/metrics.py:119-137, which uses skimage). SSIM matches
skimage.metrics.structural_similarity's defaults for float inputs: 7x7
uniform windows, C1 = (0.01 L)^2, C2 = (0.03 L)^2, L = data_range
(img_orig.max() - img_orig.min() by default), sample covariance
(N/(N-1)). Its window mean is an average pool, never a cuDNN
convolution: with TF32 on, that would lose the digits that the variances
uxx - ux^2 cancel down to.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def mse(img: torch.Tensor, img_orig: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - img_orig) ** 2)


def mae(img: torch.Tensor, img_orig: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(img - img_orig))


def nrmse(img: torch.Tensor, img_orig: torch.Tensor) -> torch.Tensor:
    """Euclidean-normalized RMSE: ||img - orig|| / ||orig||
    (skimage normalized_root_mse(normalization='euclidean'))."""
    num = torch.sqrt(torch.sum((img - img_orig) ** 2))
    den = torch.sqrt(torch.sum(img_orig ** 2))
    return num / den


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over 'valid' size x size windows of an (H, W) tensor."""
    return F.avg_pool2d(x[None, None], size, stride=1)[0, 0]


def ssim(img: torch.Tensor, img_orig: torch.Tensor, win_size: int = 7,
         data_range: Optional[float] = None, K1: float = 0.01,
         K2: float = 0.03) -> torch.Tensor:
    """Structural similarity of 2-D single-channel images (H, W)."""
    img = img.float()
    img_orig = img_orig.float()
    if data_range is None:
        data_range = img_orig.max() - img_orig.min()
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2

    NP = win_size * win_size
    cov_norm = NP / (NP - 1.0)  # skimage's sample covariance

    ux = _uniform_filter(img, win_size)
    uy = _uniform_filter(img_orig, win_size)
    uxx = _uniform_filter(img * img, win_size)
    uyy = _uniform_filter(img_orig * img_orig, win_size)
    uxy = _uniform_filter(img * img_orig, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux ** 2 + uy ** 2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    return torch.mean(S)


REGISTERED_METRICS = {"L2": mse, "L1": mae, "SSIM": ssim, "NRMSE": nrmse}


def compute_metrics(metric_names: Sequence[str], img: torch.Tensor,
                    img_orig: torch.Tensor, reduce: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """Batched metrics (reference: helpers/metrics.py:21-45).

    img: (B, H, W) or (B, H, W, C); img_orig: the same, or one reference
    broadcast over the batch. SSIM of C > 1 images is the mean over
    channels (the reference's SSIM_wrapper channel_axis,
    helpers/metrics.py:56-68).
    """
    if img.ndim == 4 and img.shape[-1] == 1:
        img = img[..., 0]
    if img_orig.ndim == 4 and img_orig.shape[-1] == 1:
        img_orig = img_orig[..., 0]
    if img_orig.ndim == img.ndim - 1:
        img_orig = torch.broadcast_to(img_orig[None], img.shape)
    elif img_orig.shape[0] == 1:
        img_orig = torch.broadcast_to(img_orig, img.shape)

    def one(name, a, b):
        if name == "SSIM" and a.ndim == 3:  # (H, W, C > 1): channel mean
            return torch.mean(torch.stack([ssim(a[..., c], b[..., c])
                                           for c in range(a.shape[-1])]))
        return REGISTERED_METRICS[name](a, b)

    out: Dict[str, torch.Tensor] = {}
    for name in metric_names:
        vals = torch.stack([one(name, img[i], img_orig[i])
                            for i in range(img.shape[0])])
        if reduce == "mean":
            vals = vals.mean()
        elif reduce == "sum":
            vals = vals.sum()
        elif reduce == "max":
            vals = vals.max()
        out[name] = vals
    return out


def compute_snr(imgs: torch.Tensor) -> torch.Tensor:
    """Peak SNR in dB of each batch element, the population std
    (reference: helpers/metrics.py:95-102)."""
    mags = torch.abs(imgs)
    dims = tuple(range(1, mags.ndim))
    snr = mags.amax(dim=dims) / mags.std(dim=dims, correction=0)
    return 20 * torch.log10(snr)


def nrmse_np(img, img_orig) -> float:
    """Host-side NRMSE for result aggregation (skimage convention)."""
    img, img_orig = np.asarray(img), np.asarray(img_orig)
    return float(np.sqrt(np.mean((img - img_orig) ** 2))
                 / max(np.sqrt(np.mean(img_orig ** 2)), 1e-20))


def ssim_np(img, img_orig) -> float:
    """Host-side SSIM (wraps the tensor implementation)."""
    return float(ssim(torch.as_tensor(np.asarray(img)),
                      torch.as_tensor(np.asarray(img_orig))))


def compute_snr_np(img) -> float:
    """Host-side peak SNR in dB of a single image."""
    mag = np.abs(np.asarray(img))
    return float(20 * np.log10(mag.max() / max(mag.std(), 1e-20)))


def compute_mean_and_std(imgs: torch.Tensor):
    """Ensemble mean and population std over axis 0; complex inputs give
    magnitude and phase statistics (reference: helpers/metrics.py:77-92)."""
    if imgs.is_complex():
        mag, phase = torch.abs(imgs), torch.angle(imgs)
        return (mag.mean(0), phase.mean(0), mag.std(0, correction=0),
                phase.std(0, correction=0))
    return imgs.mean(0), torch.abs(imgs).std(0, correction=0)

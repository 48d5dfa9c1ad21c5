"""Dataset statistics for hyperparameter selection, in numpy.

Port of inverseproblemwithdiffusionmodel_tpu/utils/dataset_stats.py.
Reference semantics: helpers/dataset_stats.py:19-104 — the Song & Ermon
"Techniques for training score-based models" heuristics: sigma_max should be
about the maximum pairwise distance in the training set; TV/L2-norm
histograms pick the foreground threshold for 1-D tube filtering
(helpers/load_data.py:417-440).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def max_pairwise_distance(data: np.ndarray, max_samples: int = 1024,
                          seed: int = 0) -> float:
    """Max L2 distance between flattened samples - the sigma_max heuristic
    (reference: dataset_stats.py:19-31 samples random pairs; here the exact
    max over a subsample, from one |x|^2 + |y|^2 - 2 x.y Gram matrix in
    float32, as the JAX form computes it)."""
    rng = np.random.RandomState(seed)
    n = data.shape[0]
    if n > max_samples:
        data = data[rng.choice(n, max_samples, replace=False)]
    x = np.asarray(data.reshape(data.shape[0], -1), np.float32)
    sq = np.sum(x ** 2, axis=1)
    d2 = sq[:, None] + sq[None, :] - np.float32(2.0) * (x @ x.T)
    return float(np.sqrt(np.maximum(d2, np.float32(0.0)).max()))


def norm_histogram(samples: np.ndarray, tfm: str = "TV", bins: int = 50,
                   normalized: bool = True, time_axis: int = 1,
                   ) -> Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Per-sample transform norms + histogram
    (reference: dataset_stats.py:34-75 compute_norm_hist, minus the
    matplotlib side effects). tfm: "TV" (circular temporal total variation,
    signal_transform_TV :83-90) or "norm" (L2, signal_transform_norm
    :77-81). `normalized` divides each norm by the sample's element count.
    samples: (N, ...) with time on `time_axis`."""
    x = np.asarray(samples)
    per_sample_numel = x[0].size
    if tfm == "TV":
        vals = np.abs(np.roll(x, -1, axis=time_axis) - x).sum(
            axis=tuple(range(1, x.ndim)))
    elif tfm == "norm":
        vals = np.sqrt((x.astype(np.float64) ** 2).sum(
            axis=tuple(range(1, x.ndim))))
    else:
        raise KeyError(f"unknown signal transform {tfm!r}")
    if normalized:
        vals = vals / per_sample_numel
    hist, edges = np.histogram(vals, bins=bins)
    return vals, (hist, edges)


def tv_norm_histogram(signals: np.ndarray, bins: int = 50
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample temporal TV norms + histogram for choosing the
    foreground/background threshold (reference: dataset_stats.py:42-60).
    signals: (N, T, C)."""
    return norm_histogram(signals, tfm="TV", bins=bins, normalized=True,
                          time_axis=1)


def count_samples(counts: np.ndarray, bin_edges: np.ndarray,
                  thresh: float) -> Tuple[int, int]:
    """Histogram mass on each side of `thresh`, by upper bin edge
    (reference: dataset_stats.py:96-104)."""
    upper = np.asarray(bin_edges)[1:]
    mask_leq = upper <= thresh
    counts = np.asarray(counts)
    return int(counts[mask_leq].sum()), int(counts[~mask_leq].sum())


def suggest_sigma_max(data: np.ndarray, **kw) -> float:
    """Alias with the paper's naming."""
    return max_pairwise_distance(data, **kw)

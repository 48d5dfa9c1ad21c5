"""Result aggregation and figure generation.

Port of inverseproblemwithdiffusionmodel_tpu/utils/visualizations.py
(reference: helpers/visualizations.py, `create_sample_grid_plot`
:58-190, `metric_vs_hyperparam` :195-316, `metric_vs_one_hyperparam`
:319-396, `grid_of_temporal_samples` :399-422; the image and GIF helpers
of helpers/utils.py, vis_images :74, save_vol_as_gif :362). Host-side
numpy throughout; the figures are the JAX package's, at its sizes and
dpi.

The numeric helpers (`load_run`, `ensemble_stats`, `_ssim_nd`,
`per_sample_metrics`) need neither matplotlib nor Pillow. The drawing
functions import matplotlib (Agg backend) or Pillow when they are called,
not when this module is imported, so the rest of the package runs where
neither is installed.

Artifacts are the .npy files of scripts/_common.save_artifacts
(original.npy / reconstructions.npy / ZF.npy + args.json).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import compute_snr_np, nrmse_np, ssim_np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


# ---------------------------------------------------------------------------
# numpy metric wrappers (host-side aggregation; tensor versions in
# metrics.py)
# ---------------------------------------------------------------------------

def load_run(run_dir: str) -> Dict[str, np.ndarray]:
    """Load a script run directory (original / reconstructions / ZF / args)."""
    out = {}
    for name in ("original", "reconstructions", "ZF", "measurement",
                 "ensemble_mean", "ensemble_std"):
        path = os.path.join(run_dir, f"{name}.npy")
        if os.path.exists(path):
            out[name] = np.load(path)
    args_path = os.path.join(run_dir, "args.json")
    if os.path.exists(args_path):
        with open(args_path) as f:
            out["args"] = json.load(f)
    return out


def ensemble_stats(recons: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Magnitude mean & std over the chain axis
    (reference: visualizations.py:117-120)."""
    mag = np.abs(recons)
    return mag.mean(axis=0), mag.std(axis=0)


def _ssim_nd(a: np.ndarray, b: np.ndarray) -> float:
    """SSIM of same-shape arrays of any layout the run artifacts use:
    (H, W), (H, W, 1), (H, W, C<=4) (per-channel mean, the reference
    SSIM_wrapper channel_axis convention), or with extra leading frame
    dims ((T, H, W, C) 2D+time volumes — frame-wise mean)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"SSIM shape mismatch {a.shape} vs {b.shape}")
    if a.ndim >= 3 and a.shape[-1] == 1:
        a, b = a[..., 0], b[..., 0]
    if a.ndim == 2:
        return float(ssim_np(a, b))
    if a.ndim == 3 and a.shape[-1] <= 4:  # (H, W, C): channel mean
        return float(np.mean([ssim_np(a[..., c], b[..., c])
                              for c in range(a.shape[-1])]))
    return float(np.mean([_ssim_nd(a[j], b[j]) for j in range(a.shape[0])]))


def per_sample_metrics(recons: np.ndarray, original: np.ndarray
                       ) -> Dict[str, List[float]]:
    """SNR / NRMSE / SSIM per ensemble member + for the ensemble mean
    (reference: visualizations.py:96-142). Handles (N, H, W, C) image
    ensembles and (N, T, H, W, C) 2D+time volume ensembles; `original`
    may carry a leading batch dim of 1."""
    truth = np.abs(original)
    # align truth to one ensemble member's shape
    while truth.ndim >= recons.ndim and truth.shape[0] == 1:
        truth = truth[0]
    if truth.shape != recons.shape[1:]:
        raise ValueError(f"original {np.asarray(original).shape} does not "
                         f"match reconstructions {recons.shape}")
    rows: Dict[str, List[float]] = {"snr": [], "nrmse": [], "ssim": []}
    for i in range(recons.shape[0]):
        mag = np.abs(recons[i])
        rows["snr"].append(compute_snr_np(mag))
        rows["nrmse"].append(nrmse_np(mag, truth))
        rows["ssim"].append(_ssim_nd(mag, truth))
    mean_mag, _ = ensemble_stats(recons)
    rows["mean_nrmse"] = [nrmse_np(mean_mag, truth)]
    rows["mean_ssim"] = [_ssim_nd(mean_mag, truth)]
    return rows


def create_sample_grid_plot(run_dir: str, save_path: Optional[str] = None,
                            max_cols: int = 5):
    """Original | ZF | ensemble mean | ensemble std | first members, with
    metrics in the titles (reference: visualizations.py:58-190)."""
    plt = _pyplot()
    run = load_run(run_dir)
    original = run["original"]
    recons = run["reconstructions"]
    truth = np.abs(original[0] if original.ndim == 4 else original)
    mean_mag, std_mag = ensemble_stats(recons)
    metrics = per_sample_metrics(recons, original)

    panels = [("original", truth), ("mean", mean_mag), ("std", std_mag)]
    if "ZF" in run:
        panels.insert(1, ("ZF", np.abs(run["ZF"][0])))
    for i in range(min(recons.shape[0], max_cols - len(panels))):
        panels.append((f"sample {i}", np.abs(recons[i])))

    fig, axes = plt.subplots(1, len(panels), figsize=(3 * len(panels), 3.4))
    if len(panels) == 1:
        axes = [axes]
    for ax, (title, img) in zip(axes, panels):
        ax.imshow(img.squeeze(), cmap="gray")
        ax.set_axis_off()
        ax.set_title(title, fontsize=9)
    fig.suptitle(
        f"mean NRMSE {metrics['mean_nrmse'][0]:.4f} / "
        f"mean SSIM {metrics['mean_ssim'][0]:.4f} "
        f"({recons.shape[0]} chains)", fontsize=10)
    fig.tight_layout()
    save_path = save_path or os.path.join(run_dir, "sample_grid.png")
    fig.savefig(save_path, dpi=120)
    plt.close(fig)

    with open(os.path.join(run_dir, "metrics.txt"), "w") as f:
        f.write(f"NRMSE: {metrics['mean_nrmse'][0]:.5f}, "
                f"SSIM: {metrics['mean_ssim'][0]:.5f}\n")
    return save_path, metrics


def metric_vs_hyperparam(run_dirs: Sequence[str], param_keys: Sequence[str],
                         metric: str = "mean_nrmse",
                         save_path: str = "metric_vs_hyperparam.png"):
    """Sweep plot: metric against one or two hyperparameters read from each
    run's args.json (reference: visualizations.py:195-316)."""
    plt = _pyplot()
    points = []
    for rd in run_dirs:
        run = load_run(rd)
        vals = per_sample_metrics(run["reconstructions"], run["original"])
        coords = tuple(run["args"][k] for k in param_keys)
        points.append((coords, vals[metric][0]))
    points.sort()

    fig, ax = plt.subplots(figsize=(5, 3.5))
    if len(param_keys) == 1:
        xs = [c[0] for c, _ in points]
        ys = [v for _, v in points]
        ax.plot(xs, ys, "o-")
        ax.set_xlabel(param_keys[0])
    else:
        secondary = sorted({c[1] for c, _ in points})
        for sv in secondary:
            xs = [c[0] for c, v in points if c[1] == sv]
            ys = [v for c, v in points if c[1] == sv]
            ax.plot(xs, ys, "o-", label=f"{param_keys[1]}={sv}")
        ax.set_xlabel(param_keys[0])
        ax.legend(fontsize=8)
    ax.set_ylabel(metric)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return points


def metric_vs_one_hyperparam(run_dirs, param_key: str, **kw):
    """Single-parameter convenience (reference: visualizations.py:319-396)."""
    return metric_vs_hyperparam(run_dirs, [param_key], **kw)


def grid_of_temporal_samples(vol: np.ndarray, num_frames: int = 6,
                             save_path: str = "temporal_grid.png"):
    """Frame strip of a (T, H, W, C) volume
    (reference: visualizations.py:399-422)."""
    plt = _pyplot()
    mag = np.abs(vol)
    T = mag.shape[0]
    idx = np.linspace(0, T - 1, num_frames).astype(int)
    fig, axes = plt.subplots(1, num_frames, figsize=(2 * num_frames, 2.2))
    for ax, t in zip(np.atleast_1d(axes), idx):
        ax.imshow(mag[t].squeeze(), cmap="gray")
        ax.set_axis_off()
        ax.set_title(f"t={t}", fontsize=8)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def save_vol_as_gif(vol: np.ndarray, save_path: str, duration: int = 100):
    """(T, H, W[, C]) magnitude volume -> animated GIF
    (reference: helpers/utils.py:362-399)."""
    from PIL import Image
    mag = np.abs(vol).squeeze()
    lo, hi = mag.min(), mag.max()
    mag = ((mag - lo) / max(hi - lo, 1e-12) * 255).astype(np.uint8)
    frames = [Image.fromarray(f) for f in mag]
    frames[0].save(save_path, save_all=True, append_images=frames[1:],
                   duration=duration, loop=0)
    return save_path


def vis_signals(*signals: np.ndarray, titles: Optional[Sequence[str]] = None,
                save_path: str = "signals.png"):
    """Overlayed 1-D signal plots, one panel per argument
    (reference: helpers/utils.py:123-138). Each signal: (T,) or (T, C)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, len(signals), figsize=(4 * len(signals), 3))
    for i, (ax, sig) in enumerate(zip(np.atleast_1d(axes), signals)):
        sig = np.asarray(sig)
        if sig.ndim == 1:
            sig = sig[:, None]
        for c in range(sig.shape[1]):
            ax.plot(sig[:, c], lw=1)
        ax.grid(alpha=0.3)
        if titles:
            ax.set_title(titles[i], fontsize=9)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def vis_multi_channel_signal(signal: np.ndarray, ncols: int = 4,
                             save_path: str = "channels.png"):
    """One subplot per channel of a (T, C) signal
    (reference: helpers/utils.py:141-158)."""
    plt = _pyplot()
    sig = np.asarray(signal)
    C = sig.shape[1]
    nrows = (C + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2 * nrows),
                             squeeze=False)
    for c in range(nrows * ncols):
        ax = axes[c // ncols][c % ncols]
        if c < C:
            ax.plot(sig[:, c], lw=1)
            ax.set_title(f"ch {c}", fontsize=8)
        ax.set_axis_off() if c >= C else ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def vis_tensor(x: np.ndarray, save_path: str = "tensor.png"):
    """Quick magnitude imshow of whatever tensor lands here
    (reference: helpers/utils.py:229-247 debug helper)."""
    plt = _pyplot()
    mag = np.abs(np.asarray(x)).squeeze()
    while mag.ndim > 2:
        mag = mag[0]
    fig, ax = plt.subplots(figsize=(3.2, 3))
    im = ax.imshow(mag, cmap="gray")
    fig.colorbar(im, ax=ax, fraction=0.046)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def vis_images(*imgs: np.ndarray, titles: Optional[Sequence[str]] = None,
               save_path: str = "images.png"):
    """Side-by-side image grid (reference: helpers/utils.py:74-120)."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, len(imgs), figsize=(3 * len(imgs), 3))
    for i, (ax, img) in enumerate(zip(np.atleast_1d(axes), imgs)):
        ax.imshow(np.abs(np.asarray(img)).squeeze(), cmap="gray")
        ax.set_axis_off()
        if titles:
            ax.set_title(titles[i], fontsize=9)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path

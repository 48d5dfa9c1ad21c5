"""Epoch-end and mid-chain hooks that draw PNG files.

Port of inverseproblemwithdiffusionmodel_tpu/training/callbacks.py
(reference: helpers/pl_callbacks.py, `ValVisualizationDiscrete`
:153-178, an ALD sample grid at the end of an epoch, and
`ValVisualization` :124-150, a continuous PC sample; the sampler
snapshots of ALD_optimizers.py:203-213 and `_screenshot` :556-581). The
hooks run on the host, outside the training step, on the EMA weights
(`state.eval_params`) through torch.func.functional_call, so the model's
own parameters stay as they are. The figures are utils/visualizations'
(matplotlib, imported when a hook draws).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from .state import TrainState
from ..models.registry import to_nchw
from ..samplers.ald import ALDConfig, ald_unconditional_sampler


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t)


def _draw_samples(samples: np.ndarray, path: str) -> None:
    from ..utils.visualizations import vis_images
    vis_images(*[samples[i] for i in range(min(len(samples), 8))],
               save_path=path)


def make_ald_visualization_hook(model: torch.nn.Module, sigmas,
                                shape: Tuple[int, ...], out_dir: str,
                                every_n_epochs: int = 1,
                                n_steps_each: int = 3,
                                step_lr: float = 9e-7, seed: int = 0):
    """End-of-epoch unconditional ALD sampling of `shape` (channel-last)
    with the EMA weights of an NCSNv2-family net, drawn as
    `samples_epoch<epoch>.png` in out_dir (reference: pl_callbacks.py:
    153-178). Returns a fit() epoch_end_hook(state, epoch). The sampler
    runs on the model's device; its generator is seeded seed + epoch (the
    JAX form folds the epoch into its key)."""
    os.makedirs(out_dir, exist_ok=True)
    cfg = ALDConfig(n_steps_each=n_steps_each, step_lr=step_lr)

    def hook(state: TrainState, epoch: int) -> None:
        if (epoch + 1) % every_n_epochs:
            return
        device = next(model.parameters()).device
        ladder = torch.as_tensor(sigmas, dtype=torch.float32).to(device)
        params = state.eval_params

        def score_fn(x, labels):
            out = torch.func.functional_call(
                model, params, (to_nchw(x), ladder[labels]))
            return out.movedim(1, -1).float()

        was_training = model.training
        model.eval()
        try:
            samples = ald_unconditional_sampler(
                score_fn, ladder, shape, seed=seed + epoch, config=cfg,
                device=device)
        finally:
            model.train(was_training)
        _draw_samples(_host(samples), os.path.join(
            out_dir, f"samples_epoch{epoch:04d}.png"))

    return hook


def make_snapshot_hook(out_dir: str, prefix: str = "snap",
                       save_png: bool = True, temporal: bool = False):
    """Mid-chain sampler diagnostics (reference: ALD_optimizers.py:203-213
    snapshot saves, :556-581 `_screenshot` temporal profiles).

    Returns snapshot_fn(level, sigma, *parts) for the samplers'
    `snapshot_fn=` parameter (called every ALDConfig.snapshot_every
    levels): saves the magnitude as `{prefix}_level{c}.npy`, appends a
    line to `{prefix}_log.txt`, draws a PNG of the first sample and, when
    `temporal` and the state is (B, T, H, W, C), the frame strip.
    """
    os.makedirs(out_dir, exist_ok=True)

    def snapshot_fn(level, sigma, *parts):
        level = int(level)
        parts = [_host(p) for p in parts]
        mag = (np.abs(parts[0]) if len(parts) == 1
               else np.sqrt(parts[0] ** 2 + parts[1] ** 2))
        np.save(os.path.join(out_dir, f"{prefix}_level{level:05d}.npy"), mag)
        with open(os.path.join(out_dir, f"{prefix}_log.txt"), "a") as f:
            f.write(f"level {level} sigma {float(sigma):.6g} "
                    f"|x| mean {mag.mean():.6g} max {mag.max():.6g}\n")
        if not save_png:
            return
        from ..utils.visualizations import grid_of_temporal_samples, vis_images
        img = mag[0]
        if img.ndim == 4:                       # (T, H, W, C) 2D+time state
            if temporal:
                grid_of_temporal_samples(
                    img, save_path=os.path.join(
                        out_dir, f"{prefix}_level{level:05d}_temporal.png"))
            img = img[0]                        # the PNG shows frame 0
        vis_images(img, save_path=os.path.join(
            out_dir, f"{prefix}_level{level:05d}.png"))

    return snapshot_fn


def make_pc_visualization_hook(model: torch.nn.Module, sde, shape,
                               out_dir: str, sampling_config=None,
                               every_n_epochs: int = 1, seed: int = 0):
    """The continuous stack's counterpart: end-of-epoch PC sampling of a
    channel-last `shape` with the EMA weights, drawn as
    `pc_samples_epoch<epoch>.png` (reference: pl_callbacks.py:124-150).
    `sampling_config` (config.sampling) sets the predictor, corrector,
    snr, steps, probability flow and denoising, as in the JAX form."""
    from ..sde import get_pc_sampler, get_score_fn
    os.makedirs(out_dir, exist_ok=True)
    kw = {}
    if sampling_config is not None:
        kw = dict(predictor=sampling_config.predictor,
                  corrector=sampling_config.corrector,
                  snr=sampling_config.snr,
                  n_steps=sampling_config.n_steps_each,
                  probability_flow=sampling_config.probability_flow,
                  denoise=sampling_config.noise_removal)

    def hook(state: TrainState, epoch: int) -> None:
        if (epoch + 1) % every_n_epochs:
            return
        device = next(model.parameters()).device
        params = state.eval_params
        model_fn = lambda x, cond: torch.func.functional_call(
            model, params, (x, cond))
        sampler = get_pc_sampler(sde, shape, device=device, **kw)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                x, _ = sampler(get_score_fn(sde, model_fn, continuous=True),
                               seed=seed + epoch)
        finally:
            model.train(was_training)
        _draw_samples(_host(x), os.path.join(
            out_dir, f"pc_samples_epoch{epoch:04d}.png"))

    return hook

"""Training loop: epochs over a host data iterator, EMA-weighted
validation, checkpoints at epoch end and at stop, resume.

Port of `MetricsLogger` (:21), `FitConfig` (:60), `fit` (:75),
`make_train_iterator` (:163) and `batch_iterator` (:185) from
inverseproblemwithdiffusionmodel_tpu/training/loop.py (reference:
helpers/pl_helpers.py:355-399). Logging is a JSONL metrics stream, one line
per event, mirrored to TensorBoard on request. `make_train_iterator` feeds
batches from the native C++ prefetch batcher (data/native_loader.py) where
it builds, else from `batch_iterator`.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from .checkpoint import Checkpointer
from .state import TrainState


class MetricsLogger:
    """Append-only JSONL scalar log (timestamp, step, **scalars).

    tensorboard=True additionally mirrors every scalar to a TB event file
    under `<log_dir>/tb` (utils/tb_export.TBMirror), dashboard parity with
    the reference's SummaryWriter logging (helpers/pl_helpers.py:361).
    Existing jsonl runs convert after the fact with
    `scripts/export_tensorboard.py`."""

    def __init__(self, log_dir: str, name: str = "metrics.jsonl",
                 tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            from ..utils.tb_export import TBMirror
            self._tb = TBMirror(os.path.join(log_dir, "tb"))

    def log(self, step: int, **scalars: float) -> None:
        rec = {"ts": time.time(), "step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add(step, walltime=rec["ts"],
                         **{k: v for k, v in rec.items()
                            if k not in ("ts", "step")})

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


@dataclass
class FitConfig:
    n_epochs: int = 1
    max_steps: Optional[int] = None            # debug cap (reference
    # fast_dev_run, helpers/pl_helpers.py:379-384)
    log_every: int = 50
    ckpt_every_epochs: int = 1
    seed: int = 42
    log_dir: str = "runs/default"
    keep_ckpts: int = 3
    resume: bool = True       # restore the latest checkpoint if one exists
    tensorboard: bool = False  # mirror the metrics to <log_dir>/tb


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of a run from `step` on: seeded from (seed, step), so
    a resumed run does not replay the draws the first run consumed (the
    JAX loop folds the restored step into its key, loop.py:107)."""
    hi, lo = np.random.SeedSequence([seed, step]).generate_state(2)
    return torch.Generator(device).manual_seed(int(hi) << 32 | int(lo))


def fit(
    state: TrainState,
    train_step: Callable,
    train_iter_fn: Callable[[], Iterable[Any]],
    cfg: FitConfig,
    eval_step: Optional[Callable] = None,
    val_iter_fn: Optional[Callable[[], Iterable[Any]]] = None,
    epoch_end_hook: Optional[Callable[[TrainState, int], None]] = None,
) -> TrainState:
    """Run the epoch loop.

    train_iter_fn(): a fresh iterable of batches per epoch (numpy is fine).
    train_step(state, batch, generator) -> (state, loss); eval_step(state,
    batch, generator) -> scalar loss, which the caller computes on EMA
    weights (`state.eval_params`). epoch_end_hook(state, epoch) can render
    samples. All draws come from one torch.Generator on the model's
    device, seeded from (cfg.seed, the step the run starts at).
    """
    logger = MetricsLogger(cfg.log_dir, tensorboard=cfg.tensorboard)
    ckpt = Checkpointer(os.path.join(cfg.log_dir, "ckpts"),
                        max_to_keep=cfg.keep_ckpts,
                        track_best=eval_step is not None)
    if cfg.resume and ckpt.latest_step() is not None:
        # elastic restart: resume {params, ema, opt_state, step}
        state = ckpt.restore(state)
        logger.log(state.step, resumed=1.0)
    global_step = resumed_step = state.step
    device = next(state.model.parameters()).device
    gen = step_generator(cfg.seed, resumed_step, device)
    t0 = time.time()
    stop = False

    # Epochs completed across restarts: the checkpoint stores only the step
    # count, so after the first full in-session epoch the counter is
    # re-based to resumed_step // batches_per_epoch, and a resumed run
    # finishes the remaining epochs.
    epoch = 0
    batches_per_epoch = None
    while epoch < cfg.n_epochs and not stop:
        n_batches = 0
        for batch in train_iter_fn():
            state, loss = train_step(state, batch, gen)
            global_step += 1
            n_batches += 1
            if global_step % cfg.log_every == 0:
                logger.log(global_step, train_loss=float(loss),
                           steps_per_sec=cfg.log_every / max(
                               time.time() - t0, 1e-9))
                t0 = time.time()
            if cfg.max_steps and global_step >= cfg.max_steps:
                stop = True
                break
        if batches_per_epoch is None and n_batches > 0 and not stop:
            batches_per_epoch = n_batches
            epoch += resumed_step // batches_per_epoch

        val_loss = None
        if eval_step is not None and val_iter_fn is not None:
            losses = [float(eval_step(state, vbatch, gen))
                      for vbatch in val_iter_fn()]
            if losses:
                val_loss = float(np.mean(losses))
                logger.log(global_step, val_loss=val_loss, epoch=epoch)

        if (epoch + 1) % cfg.ckpt_every_epochs == 0 or stop:
            ckpt.save(global_step, state, val_loss=val_loss)
        if epoch_end_hook is not None:
            epoch_end_hook(state, epoch)
        epoch += 1

    ckpt.close()
    logger.close()
    return state


def batch_iterator(data: np.ndarray, batch_size: int, *, labels=None,
                   shuffle: bool = True, seed: int = 0, drop_last: bool = True):
    """Host-side epoch iterator factory over in-memory arrays."""
    rng = np.random.RandomState(seed)

    def make():
        n = data.shape[0]
        idx = rng.permutation(n) if shuffle else np.arange(n)
        end = n - (n % batch_size) if drop_last else n
        for i in range(0, max(end, batch_size) if not drop_last else end,
                       batch_size):
            sel = idx[i:i + batch_size]
            if len(sel) == 0:
                continue
            if labels is not None:
                yield data[sel], labels[sel]
            else:
                yield data[sel]

    return make


def make_train_iterator(data: np.ndarray, batch_size: int, *,
                        shuffle: bool = True, seed: int = 0,
                        drop_last: bool = True, prefer_native: bool = True):
    """Training feed factory: the C++ prefetch batcher
    (native/batcher.cpp via data/native_loader.py, the reference's
    DataLoader num_workers analog, helpers/pl_helpers.py:115) when it
    builds on this host, else the numpy iterator. Unlabeled float arrays
    only; labeled feeds use `batch_iterator(labels=...)`. The factory's
    `feed` attribute says which was taken: "native" or "numpy"."""
    if prefer_native:
        try:
            from ..data.native_loader import (native_available,
                                              native_batch_iterator)
            if native_available():
                make = native_batch_iterator(
                    np.asarray(data), batch_size, shuffle=shuffle,
                    seed=seed, drop_last=drop_last)
                make.feed = "native"
                return make
        except RuntimeError:
            pass  # the batcher refused these data: the numpy path
    make = batch_iterator(data, batch_size, shuffle=shuffle, seed=seed,
                          drop_last=drop_last)
    make.feed = "numpy"
    return make

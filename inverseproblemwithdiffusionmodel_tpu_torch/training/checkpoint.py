"""Checkpoints of a TrainState: {step, params, ema, opt_state}, one
directory per step.

Port of `Checkpointer` from inverseproblemwithdiffusionmodel_tpu/training/
checkpoint.py, which keeps orbax checkpoints; this one keeps `torch.save`
files. An orbax checkpoint of the JAX package is converted to one of
these first, on a host with orbax: `convert_orbax_checkpoint.py` at the
repository's root (the port imports no orbax).

Layout: `<ckpt_dir>/<step>/state.pt`, plus `metrics.json` where a val_loss
was given. A step is written into a temporary directory and moved into
place with `os.replace`, so a reader never sees half a checkpoint. Files
are loaded with `torch.load(weights_only=True)`: a checkpoint holds only
tensors and plain containers. Retention is orbax's as the JAX package sets
it: with `track_best`, the `max_to_keep` best by val_loss (lowest) and every
checkpoint without a val_loss; else the `max_to_keep` latest.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import torch

from .state import TrainState

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class Checkpointer:
    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = 3,
                 track_best: bool = True):
        self.directory = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.track_best = track_best
        os.makedirs(self.directory, exist_ok=True)

    # -- reading -------------------------------------------------------------

    def all_steps(self):
        """Saved steps, ascending. A step directory without the port's file
        (an orbax checkpoint of the JAX package) raises ValueError."""
        steps = sorted(int(name) for name in os.listdir(self.directory)
                       if name.isdigit())
        for step in steps:
            if not os.path.isfile(self._path(step, STATE_FILE)):
                raise ValueError(
                    f"{self._path(step)} holds no {STATE_FILE}: not a "
                    "checkpoint of the port. Convert a JAX (orbax) "
                    "checkpoint first, on a host with orbax: python "
                    "convert_orbax_checkpoint.py --jax_ckpt_dir "
                    f"{self.directory} --out_dir <dir> ...")
        return steps

    def _metrics(self, step: int) -> Optional[dict]:
        path = self._path(step, METRICS_FILE)
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _by_quality(self):
        """(steps without a val_loss, steps with one from worst to best)."""
        steps = self.all_steps()
        metrics = {s: self._metrics(s) for s in steps}
        without = [s for s in steps if metrics[s] is None]
        ranked = sorted((s for s in steps if metrics[s] is not None),
                        key=lambda s: metrics[s]["val_loss"], reverse=True)
        return without, ranked

    def best_step(self) -> Optional[int]:
        """The lowest val_loss with `track_best`, else the latest step."""
        if not self.track_best:
            return self.latest_step()
        _, ranked = self._by_quality()
        return ranked[-1] if ranked else None

    def _load(self, step: Optional[int]) -> Tuple[dict, int]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        raw = torch.load(self._path(step, STATE_FILE), map_location="cpu",
                         weights_only=True)
        return raw, step

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load the checkpoint (the latest by default) into `state`'s model,
        optimizer and EMA, in place (`TrainState.load_state_dict`: a
        tensor-parallel state cuts it into its slices); returns `state`."""
        raw, _ = self._load(step)
        state.load_state_dict(raw)
        return state

    def restore_params(self, step: Optional[int] = None,
                       use_ema: bool = True
                       ) -> Tuple[Dict[str, torch.Tensor], int]:
        """(params by state-dict name, on the CPU; the saved step): the EMA
        shadow where `use_ema` and the checkpoint has one, else the raw
        parameters."""
        raw, step = self._load(step)
        params = raw["params"]
        if use_ema and raw.get("ema") is not None:
            params = raw["ema"]["params"]
        return params, int(raw.get("step", step))

    # -- writing -------------------------------------------------------------

    def save(self, step: int, state: TrainState,
             val_loss: Optional[float] = None) -> None:
        payload = state.state_dict()
        tmp = os.path.join(self.directory, f".{step}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if val_loss is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump({"val_loss": float(val_loss)}, f)
        final = self._path(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        if self.track_best:
            without, ranked = self._by_quality()
            keep = set(without) | set(ranked[-self.max_to_keep:]
                                      if self.max_to_keep else [])
        else:
            steps = self.all_steps()
            keep = set(steps[-self.max_to_keep:] if self.max_to_keep else [])
        for step in self.all_steps():
            if step not in keep:
                shutil.rmtree(self._path(step))

    def _path(self, step: int, *name: str) -> str:
        return os.path.join(self.directory, str(step), *name)

    def close(self) -> None:
        """Nothing is left open: every save has finished when it returns."""

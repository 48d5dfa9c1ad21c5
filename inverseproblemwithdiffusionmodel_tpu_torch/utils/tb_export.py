"""TensorBoard-compatible scalar export.

Port of inverseproblemwithdiffusionmodel_tpu/utils/tb_export.py. The
reference logs through PyTorch-Lightning's TensorBoard logger and raw
`SummaryWriter` calls (reference: helpers/pl_helpers.py:361,
ncsn/models/MAP_optimizers.py:88-94); the port's native stream is the
append-only `metrics.jsonl` (training/loop.py MetricsLogger: cheap and
greppable, nothing host-heavy in the hot loop). This module bridges the
two so a migrating user keeps their dashboards:

- `jsonl_to_events(jsonl_path, out_dir)`: one-shot converter from a run's
  metrics.jsonl to a TB event file (CLI: scripts/export_tensorboard.py).
- `TBMirror`: an opt-in live mirror MetricsLogger forwards scalars to
  (MetricsLogger(..., tensorboard=True)).

Uses `torch.utils.tensorboard.SummaryWriter`, imported only inside
`_make_writer`, so that no other path needs the tensorboard package.
Where it is not importable the mirror warns once and writes nothing (the
jsonl stream is always written regardless), and `jsonl_to_events` raises.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Optional

_SKIP_KEYS = ("ts", "step")


def _make_writer(out_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception as e:  # tensorboard not importable on this host
        warnings.warn(f"TensorBoard export unavailable ({e!r}); "
                      f"scalars stay in metrics.jsonl only")
        return None
    os.makedirs(out_dir, exist_ok=True)
    return SummaryWriter(log_dir=out_dir)


class TBMirror:
    """Live scalar mirror: `add(step, walltime, **scalars)` forwards each
    scalar to a TB event file under `out_dir`. No-op (with one warning) if
    tensorboard is unavailable."""

    def __init__(self, out_dir: str):
        self._w = _make_writer(out_dir)

    def add(self, step: int, walltime: Optional[float] = None,
            **scalars: float) -> None:
        if self._w is None:
            return
        for k, v in scalars.items():
            self._w.add_scalar(k, float(v), global_step=int(step),
                               walltime=walltime)

    def close(self):
        if self._w is not None:
            self._w.close()


def jsonl_to_events(jsonl_path: str, out_dir: Optional[str] = None) -> str:
    """Convert a metrics.jsonl (one `{"ts":..,"step":..,**scalars}` object
    per line) into a TB event file under `out_dir` (default: `tb/` next to
    the jsonl). Returns the event directory. Original timestamps are
    preserved as event walltimes."""
    if out_dir is None:
        out_dir = os.path.join(os.path.dirname(os.path.abspath(jsonl_path)),
                               "tb")
    writer = _make_writer(out_dir)
    if writer is None:
        raise RuntimeError("tensorboard is not importable on this host")
    n = 0
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            step = int(rec.get("step", n))
            ts = rec.get("ts")
            for k, v in rec.items():
                if k in _SKIP_KEYS or not isinstance(v, (int, float)):
                    continue
                writer.add_scalar(k, float(v), global_step=step,
                                  walltime=ts)
            n += 1
    writer.close()
    return out_dir


def read_scalars(event_dir: str) -> dict:
    """Every scalar of the event files under `event_dir`, read back with
    tensorboard's event reader: {tag: [(step, value, walltime), ...]} in
    the order written. Needs the tensorboard package."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(event_dir, size_guidance={"scalars": 0})
    acc.Reload()
    return {tag: [(e.step, e.value, e.wall_time)
                  for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}

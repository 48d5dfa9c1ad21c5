"""Convert a run's metrics.jsonl into TensorBoard event files.

Bridge for users migrating from the reference's PL-TensorBoard logging
(reference: helpers/pl_helpers.py:361): the port's trainers write a JSONL
scalar stream; this CLI (or `MetricsLogger(..., tensorboard=True)` for live
mirroring) produces the event files their dashboards expect. Host-only:
it touches no device.

Usage:
    python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.export_tensorboard \\
        --run_dir runs/my_run [--out_dir runs/my_run/tb]

Port of inverseproblemwithdiffusionmodel_tpu/scripts/export_tensorboard.py,
with the same flags.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", required=True,
                   help="run directory containing metrics.jsonl "
                        "(or a direct path to a .jsonl file)")
    p.add_argument("--out_dir", default=None,
                   help="event-file directory (default <run_dir>/tb)")
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    from ..utils.tb_export import jsonl_to_events

    path = args.run_dir
    if os.path.isdir(path):
        candidates = sorted(glob.glob(os.path.join(path, "**",
                                                   "*.jsonl"),
                                      recursive=True))
        if not candidates:
            raise SystemExit(f"no .jsonl files under {path!r}")
    else:
        candidates = [path]
    for jsonl in candidates:
        out = jsonl_to_events(jsonl, args.out_dir)
        print(f"[export_tensorboard] {jsonl} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

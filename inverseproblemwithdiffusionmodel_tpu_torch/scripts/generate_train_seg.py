"""Write shell job scripts for segmentation training, one per dataset:
`<save_dir>/train_seg_<ds>.sh`.

Port of inverseproblemwithdiffusionmodel_tpu/scripts/generate_train_seg.py
(reference: scripts/generate_train_seg.py), with the same flags and files.
One deliberate difference: each job runs the port's trainer,
`python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.train_seg`,
where the JAX package's files name its own. The jobs run on the GPU (the
trainer's default device).
"""
from __future__ import annotations

import argparse
import os

from .generate_train_ncsn import PACKAGE, write_job


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ds_names", nargs="+", default=["ACDC"])
    p.add_argument("--set_num", type=int, choices=[1, 2, 3, 4],
                   default=None,
                   help="reference preset (only set 1 = ACDC "
                        "real-valued is populated there, "
                        "generate_train_seg.py:36-48)")
    p.add_argument("--save_dir", default="jobs")
    args = p.parse_args(argv)

    os.makedirs(args.save_dir, exist_ok=True)
    if args.set_num is not None:
        args.ds_names = ["ACDC"] if args.set_num == 1 else []
    for ds in args.ds_names:
        write_job(os.path.join(args.save_dir, f"train_seg_{ds}.sh"),
                  f"python -m {PACKAGE}.scripts.train_seg --ds_name {ds}")


if __name__ == "__main__":
    main()

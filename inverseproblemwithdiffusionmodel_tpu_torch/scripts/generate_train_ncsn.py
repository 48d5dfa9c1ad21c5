"""Write shell job scripts for score-model training sweeps, one per
(dataset, data mode): `<save_dir>/train_ncsn_<ds>_<mode>.sh`.

Port of inverseproblemwithdiffusionmodel_tpu/scripts/generate_train_ncsn.py
(reference: scripts/generate_train_ncsn.py), with the same flags and
files. One deliberate difference: each job runs the port's trainer,
`python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.train_ncsn`,
where the JAX package's files name its own. The jobs run on the GPU (the
trainer's default device).
"""
from __future__ import annotations

import argparse
import os

PACKAGE = "inverseproblemwithdiffusionmodel_tpu_torch"


def write_job(path: str, command: str) -> None:
    """An executable bash script running `command`."""
    with open(path, "w") as f:
        f.write("#!/bin/bash\n")
        f.write(command + "\n")
    os.chmod(path, 0o755)
    print(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ds_names", nargs="+",
                   default=["MNIST", "ACDC", "CINE127"])
    p.add_argument("--set_num", type=int, choices=[1, 2, 3, 4], default=None,
                   help="reference preset: 1=MNIST 2=CINE64 3=CINE127 "
                        "4=ACDC, real-valued + complex modes each "
                        "(generate_train_ncsn.py:36-44)")
    p.add_argument("--task_name", default="Diffusion")
    p.add_argument("--mode", default="real-imag")
    p.add_argument("--save_dir", default="jobs")
    args = p.parse_args(argv)

    os.makedirs(args.save_dir, exist_ok=True)
    if args.set_num is not None:
        ds = ["MNIST", "CINE64", "CINE127", "ACDC"][args.set_num - 1]
        jobs = [(ds, mode) for mode in ("real-valued", "complex")]
    else:
        jobs = [(ds, args.mode) for ds in args.ds_names]
    for ds, mode in jobs:
        write_job(os.path.join(args.save_dir, f"train_ncsn_{ds}_{mode}.sh"),
                  f"python -m {PACKAGE}.scripts.train_ncsn --ds_name {ds} "
                  f"--task_name {args.task_name} --mode {mode}")


if __name__ == "__main__":
    main()

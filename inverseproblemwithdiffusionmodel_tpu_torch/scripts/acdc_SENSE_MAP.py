"""ACDC SENSE MAP baseline, the forward problem of acdc_SENSE_real_img, on
the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.acdc_SENSE_MAP \\
      --ckpt_dir runs/acdc_prior/ckpts --R 8 --num_sens 4 --lamda 0.1

Port of inverseproblemwithdiffusionmodel_tpu/scripts/acdc_SENSE_MAP.py
(reference: scripts/acdc_SENSE_MAP.py, SENSEMAP, MAP_optimizers.py:123);
acdc_MAP.run_map does the work.
"""
from __future__ import annotations

import argparse

from .acdc_MAP import run_map, add_common_args
from ..operators import make_sense


def main(argv=None):
    # MAP is a deterministic optimizer: no chain ensemble
    p = add_common_args(argparse.ArgumentParser(description=__doc__),
                        num_samples=False)
    p.add_argument("--ds_name", default="ACDC")
    p.add_argument("--R", type=int, default=8, choices=[8, 16, 20])
    p.add_argument("--num_sens", type=int, default=4)
    p.add_argument("--sens_type", default="exp", choices=["exp"],
                   help="synthetic coil-map family (reference default exp)")
    p.add_argument("--center_lines_frac", type=float, default=1 / 16)
    p.add_argument("--lamda", type=float, default=0.1)
    p.add_argument("--n_iters", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--sample_idx", "--ds_idx", type=int, default=0,
                   help="test-set slice index (reference name: --ds_idx)")
    p.add_argument("--data_root", default=None)
    args = p.parse_args(argv)

    def factory(s):
        return make_sense(args.sens_type, args.num_sens, args.R,
                          args.center_lines_frac, (s, s, 1), seed=args.seed,
                          num_frames=1)

    return run_map(args, factory)


if __name__ == "__main__":
    main()

"""ACDC volumes -> per-slice .npz files, e.g.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.vol2slices \\
      --root_dir <dir of volume .npz> --save_dir <dir for slices>

Port of inverseproblemwithdiffusionmodel_tpu/scripts/vol2slices.py
(reference: scripts/vol2slices.py): data.vol2slice on the host, no device.
"""
from __future__ import annotations

import argparse

from ..data import vol2slice


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root_dir", required=True)
    p.add_argument("--save_dir", required=True)
    args = p.parse_args(argv)
    written = vol2slice(args.root_dir, args.save_dir)
    print(f"wrote {len(written)} slice files -> {args.save_dir}")
    return written


if __name__ == "__main__":
    main()

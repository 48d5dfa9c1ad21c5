"""Train the ACDC myocardium segmentation UNet that guides the ACDC
reconstructions, on the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.train_seg \\
      --ds_name ACDC

Port of inverseproblemwithdiffusionmodel_tpu/scripts/train_seg.py
(reference: scripts/train_seg.py, TrainSeg with the DiceCE loss): config ->
data.load_data (slices resized to the config's image_size, labels
binarized to the myocardium) -> models.registry.build_seg_unet (the
general config's UNet, weights drawn from --seed) ->
training.make_seg_train_step -> training.fit, with the same flags plus
--device. The batch defaults to the config's training.seg_batch_size
(ACDC: 64; 8 where a config has none), the epochs to 10; --train_mode
debug stops after 2 steps. No EMA is tracked. Checkpoints land under
`<log_dir>/<ds_name>_Seg/ckpts`, which the guided ACDC CLIs and
serve_recon read with --seg_ckpt_dir. The native C++ batcher is not ported, so --num_workers
changes nothing.
"""
from __future__ import annotations

import argparse
import os

from ..config import load_config
from ..data import load_data
from ..models.registry import build_seg_unet
from ..samplers.sigmas import get_sigmas
from ..training import (FitConfig, TrainState, batch_iterator, fit,
                        get_optimizer, make_seg_train_step)
from ..utils.convert import seeded_weights
from ..utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ds_name", default="ACDC")
    p.add_argument("--task_name", default="Seg", choices=["Seg"])
    p.add_argument("--mode", default="real-valued",
                   help="data mode collated before the seg loss "
                        "(reference TrainSeg, pl_helpers.py:290; Re/Im "
                        "modes average the part losses)")
    p.add_argument("--if_centering", action="store_true",
                   help="center inputs to [-1, 1] before the loss "
                        "(reference train_seg.py:26)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--n_epochs", type=int, default=None)
    p.add_argument("--train_mode", default="normal",
                   choices=["normal", "debug"])
    p.add_argument("--log_dir", default="runs")
    p.add_argument("--data_root", default=None)
    p.add_argument("--perturb", action="store_true",
                   help="re-enable input noising (reference disables it, "
                        "seg_loss.py:20)")
    p.add_argument("--num_workers", type=int, default=0,
                   help="accepted for the reference CLI's sake; unused")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    device = resolve_device(args.device)     # no card: raise before work
    config = load_config(args.ds_name, args.mode)
    batch_size = args.batch_size or config.training.get("seg_batch_size", 8)
    n_epochs = args.n_epochs or 10
    max_steps = 2 if args.train_mode == "debug" else None

    kw = {"root_dir": args.data_root} if args.data_root else {}
    kw["image_size"] = config.data.image_size
    train_ds = load_data(args.ds_name, "train", **kw)

    model = seeded_weights(build_seg_unet(), args.seed).to(device)
    state = TrainState.create(model, get_optimizer(config), ema_decay=None)
    step = make_seg_train_step(model, get_sigmas(config),
                               perturb=args.perturb,
                               if_centering=args.if_centering,
                               data_mode=args.mode)

    log_dir = os.path.join(args.log_dir, f"{args.ds_name}_Seg")
    cfg = FitConfig(n_epochs=n_epochs, max_steps=max_steps, log_dir=log_dir,
                    seed=args.seed)
    state = fit(state, step, batch_iterator(
        train_ds.data, batch_size, labels=train_ds.labels, seed=args.seed),
        cfg)
    print(f"done: {state.step} steps; checkpoints under "
          f"{os.path.join(log_dir, 'ckpts')}")
    return state


if __name__ == "__main__":
    main()

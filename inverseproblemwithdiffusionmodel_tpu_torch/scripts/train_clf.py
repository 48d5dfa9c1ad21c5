"""Train the noise-robust classifier that guides the MNIST samplers, on
the GPU unless --device says otherwise, e.g.:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.train_clf \\
      --ds_name MNIST

Port of inverseproblemwithdiffusionmodel_tpu/scripts/train_clf.py
(reference: scripts/train_clf.py, TrainClf with clf_loss_with_perturbation):
config -> data.load_data (images and labels) -> models.registry.build_clf
(ResNetClf, weights drawn from --seed) -> training.make_clf_train_step ->
training.fit, with the same flags plus --device. The batch defaults to the
config's training.clf_batch_size (MNIST: 512), the epochs to 10;
--train_mode debug stops after 2 steps. No EMA is tracked. Checkpoints land
under `<log_dir>/<ds_name>_Clf/ckpts`, which the guided CLIs read with
--clf_ckpt_dir. --num_workers is accepted for the reference CLI's sake
and unused, as in the JAX script: labeled batches come from the numpy
iterator (the C++ batcher feeds unlabeled arrays only).
"""
from __future__ import annotations

import argparse
import os

from ..config import load_config
from ..data import load_data
from ..models.registry import build_clf
from ..samplers.sigmas import get_sigmas
from ..training import (FitConfig, TrainState, batch_iterator, fit,
                        get_optimizer, make_clf_train_step)
from ..utils.convert import seeded_weights
from ..utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ds_name", default="MNIST")
    p.add_argument("--task_name", default="Clf", choices=["Clf"])
    p.add_argument("--mode", default="real-valued",
                   help="data mode collated before the clf loss "
                        "(reference TrainClf, pl_helpers.py:212); "
                        "single-tensor modes (real-valued|mag)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--n_epochs", type=int, default=None)
    p.add_argument("--train_mode", default="normal",
                   choices=["normal", "debug"])
    p.add_argument("--log_dir", default="runs")
    p.add_argument("--data_root", default=None)
    p.add_argument("--num_workers", type=int, default=0,
                   help="accepted for the reference CLI's sake; unused")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    device = resolve_device(args.device)     # no card: raise before work
    config = load_config(args.ds_name, args.mode)
    batch_size = args.batch_size or config.training.get("clf_batch_size", 64)
    n_epochs = args.n_epochs or 10
    max_steps = 2 if args.train_mode == "debug" else None

    kw = {"root_dir": args.data_root} if args.data_root else {}
    train_ds = load_data(args.ds_name, "train", **kw)

    model = seeded_weights(build_clf(in_channels=config.data.channels),
                           args.seed).to(device)
    state = TrainState.create(model, get_optimizer(config), ema_decay=None)
    step = make_clf_train_step(model, get_sigmas(config),
                               data_mode=args.mode)

    log_dir = os.path.join(args.log_dir, f"{args.ds_name}_Clf")
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

"""Train a discrete NCSN score model (2-D, 1-D on pixel tubes, or 3-D on
pixel-window volumes) on the GPU unless --device says otherwise, e.g. the
README quick start's MNIST prior:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.train_ncsn \\
      --ds_name MNIST --task_name Diffusion

the deployed ACDC prior:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.train_ncsn \\
      --ds_name ACDC --task_name Diffusion --mode real-imag

or the cine temporal prior on 8 x 8 pixel tubes of 24 frames:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.train_ncsn \\
      --ds_name CINE127_1D --task_name Diffusion1D --mode real-imag \\
      --flatten_type temporal

or its 3-D form (NCSN3DShallow on the (N, 8, 8, 24, 1) volumes of the same
tubes):

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.train_ncsn \\
      --ds_name CINE127_1D --task_name Diffusion3D --mode real-imag \\
      --flatten_type temporal

Port of inverseproblemwithdiffusionmodel_tpu/scripts/train_ncsn.py: config
-> data.load_data -> models.registry.load_model -> training.
make_score_train_step / make_score_eval_step -> training.fit, with the
same flags plus --device. The run writes `desc.txt`, `metrics.jsonl` and
checkpoints under `<log_dir>/<ds_name>_<task_name>_<mode>/ckpts`, which
`serve_recon --ckpt_dir` (and `--ckpt_dir_T` for a temporal prior) serves
from. The stop is `training.n_iters` (or 2 steps with --train_mode debug).
Batches come from the native C++ prefetch batcher (data/native_loader.py)
where g++ builds it, else from numpy; --no_native_loader takes numpy.
--num_workers is accepted for the reference CLI's sake and unused, as in
the JAX script. Not ported: --use_mesh (ROADMAP: Slice P), which raises.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ._common import apply_overrides
from ..config import load_config
from ..data import load_data
from ..models.registry import load_model
from ..samplers.sigmas import get_sigmas
from ..training import (FitConfig, MultiSteps, TrainState, batch_iterator,
                        fit, get_optimizer, make_score_eval_step,
                        make_score_train_step, make_train_iterator)
from ..utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--ds_name", required=True)
    p.add_argument("--task_name", default="Diffusion",
                   choices=["Diffusion", "Diffusion1D", "Diffusion3D"])
    p.add_argument("--mode", default="real-valued",
                   help="data mode: real-valued|mag|complex|real-imag|"
                        "real-imag-random")
    p.add_argument("--flatten_type", default="spatial",
                   choices=["spatial", "temporal"])
    p.add_argument("--train_mode", default="normal",
                   choices=["normal", "debug"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--n_epochs", type=int, default=None)
    p.add_argument("--log_dir", default="runs")
    p.add_argument("--data_root", default=None)
    p.add_argument("--use_mesh", action="store_true",
                   help="shard the batch over devices (not ported: raises)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the net's forward in the backward "
                        "(torch.utils.checkpoint around the net call)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 network compute on casts of the float32 "
                        "master parameters (Adam state and EMA stay f32)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over N micro-batches "
                        "(training.MultiSteps, optax.MultiSteps' mean). The "
                        "EMA decays every micro-step, so its decay per "
                        "optimizer update is ema_rate**N")
    p.add_argument("--filter_th", type=float, default=None,
                   help="TV foreground threshold for 1D tube batches "
                        "(background tubes get zero loss weight); defaults "
                        "to config data.th where it has one")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--no_native_loader", action="store_true",
                   help="feed batches from the numpy iterator instead "
                        "of the C++ prefetch batcher")
    p.add_argument("--if_centering", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="center inputs to [-1, 1] before collation (the "
                        "reference hardcodes this on for score training)")
    p.add_argument("--notes", default=None,
                   help="free-form run description (written to desc.txt)")
    p.add_argument("--num_workers", type=int, default=0,
                   help="accepted for the reference CLI's sake; unused")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def to3d(tubes: np.ndarray) -> np.ndarray:
    """(N, T, k^2) pixel tubes -> (N, k, k, T, 1) volumes, the 3-D net's
    channel-last layout (the JAX script's `to3d`)."""
    N, T, KK = tubes.shape
    win = int(np.sqrt(KK))
    return tubes.transpose(0, 2, 1).reshape(N, win, win, T)[..., None]


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    if args.use_mesh:
        raise NotImplementedError("--use_mesh: data-parallel training is not "
                                  "ported yet (ROADMAP: Slice P)")
    device = resolve_device(args.device)     # no card: raise before work
    config = apply_overrides(load_config(args.ds_name, args.mode),
                             args.override)
    if args.filter_th is None:
        args.filter_th = config.data.get("th", None)
    batch_size = args.batch_size or config.training.batch_size
    n_epochs = args.n_epochs or config.training.n_epochs
    if args.train_mode == "debug":
        n_epochs, max_steps = 1, 2      # the reference's fast_dev_run=2
    else:
        max_steps = config.training.get("n_iters", None)

    kw = {"flatten_type": args.flatten_type}
    if args.data_root:
        kw["root_dir"] = args.data_root
    if "1D" not in args.ds_name and args.task_name != "Diffusion1D":
        kw.pop("flatten_type")
    if args.ds_name == "SanityCheck1D":
        # synthetic signals shaped to the model config
        kw = {"num_channels": config.data.channels,
              "num_features": config.data.image_size}
    train_data = load_data(args.ds_name, "train", **kw).data
    val_data = load_data(args.ds_name, "val", **kw).data
    if args.task_name == "Diffusion3D":
        train_data, val_data = to3d(train_data), to3d(val_data)

    module, _ = load_model(config, args.task_name)
    module.to(device)
    sigmas = get_sigmas(config)
    tx = get_optimizer(config)
    if args.grad_accum > 1:
        tx = MultiSteps.wrap(tx, args.grad_accum)
    state = TrainState.create(module, tx,
                              ema_decay=config.model.get("ema_rate", 0.999))
    step = make_score_train_step(
        module, sigmas, data_mode=args.mode,
        anneal_power=config.training.anneal_power,
        filter_th=args.filter_th, remat=args.remat,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        if_centering=args.if_centering)
    eval_step = make_score_eval_step(
        module, sigmas, data_mode=args.mode,
        anneal_power=config.training.anneal_power,
        if_centering=args.if_centering)

    log_dir = os.path.join(args.log_dir,
                           f"{args.ds_name}_{args.task_name}_{args.mode}")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "desc.txt"), "w") as wf:
        for k, v in sorted(vars(args).items()):
            wf.write(f"{k}: {v}\n")
    cfg = FitConfig(n_epochs=n_epochs, max_steps=max_steps,
                    log_dir=log_dir, seed=args.seed)
    state = fit(state, step,
                make_train_iterator(train_data, batch_size, seed=args.seed,
                                    prefer_native=not args.no_native_loader),
                cfg, eval_step=eval_step,
                val_iter_fn=batch_iterator(val_data, batch_size,
                                           shuffle=False, seed=0))
    print(f"done: {state.step} steps; checkpoints under "
          f"{os.path.join(log_dir, 'ckpts')}")
    return state


if __name__ == "__main__":
    main()

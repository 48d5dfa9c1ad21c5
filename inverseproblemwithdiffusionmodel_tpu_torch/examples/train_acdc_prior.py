"""Full-budget ACDC 256² prior training on the port: the experiment of
examples/train_acdc_prior.py (the reference recipe: NCSNv2Deepest ngf
128, 80,001 steps at batch 3, Adam lr 1e-4 eps 1e-3, no clipping, random
horizontal flips, EMA 0.999), with its flags and defaults.

The ladder is acdc_sense_ensemble's (sigma_max from the same 400-slice
draw), so its reconstructions reload this prior against the same
ladder. Snapshots every --snap_every steps are Flax msgpack files
(`prior_<step>.msgpack` EMA, `raw_<step>.msgpack` raw: what
acdc_ckpt_sweep probes, in either package), as are the final
`prior.msgpack` and `raw_final.msgpack`. The rolling checkpoint is the
port's own (`train_state.pt`, torch.save of the TrainState and of the
net's image size and width, with a settings fingerprint); a JAX `train_state.ckpt` in --out, or a
`--warm_start` artifact directory (export_prior_artifact), restores the
parameters and EMA with fresh Adam moments.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
train_acdc_prior --out runs/acdc_prior_80k
"""
from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import time

import numpy as np
import torch

from . import _common as C
from ..models.registry import get_network
from ..samplers.sigmas import sigma_ladder
from ..training import TrainState, get_optimizer, make_score_train_step
from ..utils import artifacts
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device


def log(msg):
    print(f"[train80k] {msg}", flush=True)


def save_params(path, model, params=None):
    """Write `model` (with `params`, a name -> tensor dict, in place of its
    own where given) as a Flax msgpack prior."""
    if params is not None:
        model = C.load_params(copy.deepcopy(model), params)
    artifacts.save_prior(model, path)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--ngf", type=int, default=128)
    p.add_argument("--n_train", type=int, default=2000)
    p.add_argument("--ladder_n", type=int, default=400)
    p.add_argument("--levels", type=int, default=2311)
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--steps", type=int, default=80001)
    p.add_argument("--scan_k", type=int, default=8,
                   help="train steps per chunk: the JAX script fuses them "
                        "into one compiled program per dispatch; here they "
                        "run one after another and the chunk is the unit "
                        "of --sync_every, the logging and the snapshot "
                        "checks, as there")
    p.add_argument("--snap_every", type=int, default=10000)
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--sync_every", type=int, default=8,
                   help="read the loss back to the host every N chunks")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--eps", type=float, default=1e-3)
    p.add_argument("--grad_clip", type=float, default=0.0)
    p.add_argument("--no_flip", action="store_true")
    p.add_argument("--finalize", action="store_true",
                   help="resume the rolling checkpoint and write "
                        "prior.msgpack / raw_final.msgpack from it, no "
                        "training (pass the run's --steps/--batch/--n_train)")
    p.add_argument("--warm_start", default=None,
                   help="artifact dir (raw_bf16.msgpack, ema_bf16.msgpack, "
                        "META.json): parameters and EMA restored as float32, "
                        "training from META's step with fresh Adam moments")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/acdc_prior_80k")
    C.add_device_args(p)
    return p.parse_args(argv)


def _load_tree(model, tree):
    """Copy a Flax params tree into `model` (float32)."""
    model.load_state_dict(artifacts.state_dict_from_tree(tree, model))


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    S = args.size

    ladder_data = C.make_dataset(args.ladder_n, S, args.seed)
    sigma_max = max_pairwise_distance(ladder_data, max_samples=256)
    sigmas = sigma_ladder(sigma_max, 0.01, args.levels)
    log(f"ladder: sigma_max {sigma_max:.1f}, {args.levels} levels")
    t0 = time.time()
    data = (ladder_data if args.n_train <= args.ladder_n
            else C.make_dataset(args.n_train, S, args.seed))
    log(f"train set {data.shape} ({time.time() - t0:.0f}s to synthesize)")

    model = get_network(C.ncsn_config(1, S, args.ngf)).to(device)
    log(f"arch: {type(model).__name__}")
    opt_cfg = C.adam_config(args.lr, args.eps, args.grad_clip)
    state = TrainState.create(model, get_optimizer(opt_cfg), ema_decay=0.999)

    shapes = str([tuple(v.shape) for v in model.state_dict().values()])
    fp = hashlib.sha1(
        f"{args.steps}|{args.seed}|{args.batch}|{args.n_train}|{args.lr}|"
        f"{args.no_flip}|{args.ladder_n}|{shapes}".encode()).hexdigest()[:12]
    ckpt_path = os.path.join(args.out, "train_state.pt")
    fp_path = ckpt_path + ".fp"
    start = 0
    if os.path.exists(ckpt_path):
        saved_fp = (open(fp_path).read().strip()
                    if os.path.exists(fp_path) else "<missing>")
        if saved_fp != fp:
            log("ignoring stale checkpoint (settings changed)")
        else:
            try:
                state.load_state_dict(torch.load(
                    ckpt_path, map_location=device, weights_only=True))
                start = state.step
                log(f"resumed at step {start}")
            except Exception as e:
                log(f"ignoring unreadable checkpoint ({e})")
    jax_ckpt = os.path.join(args.out, "train_state.ckpt")
    if start == 0 and os.path.exists(jax_ckpt):
        ts = artifacts.read_train_state(jax_ckpt)
        _load_tree(model, ts["params"])
        if ts["ema"] is not None:
            ema_model = copy.deepcopy(model)
            _load_tree(ema_model, ts["ema"])
            state.ema.load_state_dict({**state.ema.state_dict(), "params": {
                k: v.detach().clone()
                for k, v in ema_model.named_parameters()}})
        start = state.step = ts["step"]
        log(f"recovered params+EMA at step {start} from the JAX "
            f"checkpoint {jax_ckpt} (fresh Adam moments)")

    if start == 0 and args.warm_start and not args.finalize:
        meta = json.load(open(os.path.join(args.warm_start, "META.json")))
        artifacts.load_prior(os.path.join(args.warm_start,
                                          "raw_bf16.msgpack"), model)
        ema_model = artifacts.load_prior(
            os.path.join(args.warm_start, "ema_bf16.msgpack"),
            copy.deepcopy(model))
        state.ema.load_state_dict({**state.ema.state_dict(), "params": {
            k: v.detach().clone() for k, v in ema_model.named_parameters()}})
        start = state.step = int(meta["step"])
        log(f"warm-started from {args.warm_start} at step {start} "
            "(fresh Adam moments)")

    if args.finalize:
        if start == 0:
            raise SystemExit("--finalize: no matching checkpoint to "
                             f"finalize in {args.out}")
        save_params(os.path.join(args.out, "prior.msgpack"), model,
                    state.eval_params)
        save_params(os.path.join(args.out, "raw_final.msgpack"), model)
        log(f"finalized at step {start}: prior.msgpack (EMA) + "
            "raw_final.msgpack written")
        return

    step = make_score_train_step(model, sigmas, data_mode="real-imag",
                                 compute_dtype=C.compute_dtype(device))
    K = args.scan_k
    dset = torch.from_numpy(data).to(device)
    log_every = 1000

    def host_draw(i):
        """The (idx, flip) draw of step i, replayable on resume."""
        rs = np.random.RandomState([args.seed, i])
        idx = rs.choice(len(data), args.batch)
        flip = (rs.rand(args.batch) < 0.5) if not args.no_flip \
            else np.zeros(args.batch, bool)
        return idx, flip

    t0, done0 = time.time(), start
    loss_hist = []
    i = start
    while i < args.steps:
        k_here = min(K, args.steps - i)
        draws = [host_draw(i + j) for j in range(k_here)]
        if k_here < K:       # the ragged tail, tiled as the JAX loop does
            draws = (draws * -(-K // k_here))[:K]
        losses = []
        for j, (idx, flip) in enumerate(draws):
            b = dset[torch.from_numpy(idx).to(device)]
            f = torch.from_numpy(flip).to(device)[:, None, None, None]
            b = torch.where(f, b.flip(2), b)
            state, loss = step(state, b,
                               C.step_generator(args.seed + 1, i + j, device))
            losses.append(loss)
        mean_loss = torch.stack(losses).mean()
        prev_i, i = i, i + K
        if args.sync_every and (i // (K * args.sync_every)) != (
                prev_i // (K * args.sync_every)):
            float(mean_loss)
        if (i // log_every) != (prev_i // log_every) or i >= args.steps:
            ml = float(mean_loss)
            loss_hist.append((i, ml))
            rate = (i - done0) / max(time.time() - t0, 1e-9)
            eta = (args.steps - i) / max(rate, 1e-9) / 3600
            log(f"step {i}: loss {ml:.2f} ({rate:.2f} steps/s, "
                f"eta {eta:.2f}h)")
        if (i // args.snap_every) != (prev_i // args.snap_every):
            snap = (i // args.snap_every) * args.snap_every
            save_params(os.path.join(args.out, f"prior_{snap:06d}.msgpack"),
                        model, state.eval_params)
            save_params(os.path.join(args.out, f"raw_{snap:06d}.msgpack"),
                        model)
            log(f"snapshot {snap} saved")
        if (i // args.ckpt_every) != (prev_i // args.ckpt_every):
            torch.save({**state.state_dict(),
                        "net": {"size": S, "ngf": args.ngf}},
                       ckpt_path + ".tmp")
            os.replace(ckpt_path + ".tmp", ckpt_path)
            with open(fp_path + ".tmp", "w") as f:
                f.write(fp)
            os.replace(fp_path + ".tmp", fp_path)

    save_params(os.path.join(args.out, "prior.msgpack"), model,
                state.eval_params)
    save_params(os.path.join(args.out, "raw_final.msgpack"), model)
    np.savetxt(os.path.join(args.out, "loss_history.txt"),
               np.asarray(loss_hist))
    log(f"done: {args.steps} steps in {(time.time() - t0) / 3600:.2f}h "
        f"(this process)")


if __name__ == "__main__":
    main()

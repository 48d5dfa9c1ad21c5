"""Checkpoint-sweep ALD probes on the port: the experiment of
examples/acdc_ckpt_sweep.py, with its flags, defaults and JSONL rows.

Probes every retained training snapshot (`<run>/prior_<step>.msgpack`,
and `raw_<step>.msgpack` where present: Flax files from either
package's train_acdc_prior) on one slice of acdc_sense_ensemble's 256²
geometry (the same dataset draw, ladder, mask, coil maps and phase) and
appends one JSON row per (snapshot, kind, lr_scaled, schedule) to
`--out`. Probes of one job share one seed, so rows compare across
snapshots. With --n_probes > 1 each probe adds `--chains` chains with
its own seed to one ensemble, whose running magnitude sum persists in
`<out>.resume_<job>.npz` so a later run extends it.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
acdc_ckpt_sweep --run runs/acdc_prior_80k --out runs/ckpt_sweep.jsonl
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from . import _common as C
from ..models.registry import get_network
from ..operators.masks import random_cartesian_mask
from ..operators.pair import PairL2Penalty, PairSENSE
from ..samplers.ald import ALDConfig
from ..samplers.ald_pair import make_stepped_pair_reconstructor
from ..samplers.sigmas import sigma_ladder
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim

N_DATA = 400    # the dataset draw the ladder's sigma_max comes from
                # (acdc_sense_ensemble's --n_train default, as the JAX script)


def log(msg):
    print(f"[sweep] {msg}", flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", default="runs/acdc_prior_80k")
    p.add_argument("--out", default="runs/ckpt_sweep.jsonl")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--ngf", type=int, default=128)
    p.add_argument("--levels", type=int, default=2311)
    p.add_argument("--n_steps_each", type=int, default=1)
    p.add_argument("--step_lr", type=float, default=9e-7)
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--R", type=int, default=8)
    p.add_argument("--center_frac", type=float, default=1 / 16)
    p.add_argument("--num_sens", type=int, default=4)
    p.add_argument("--lr_grid", type=float, nargs="*", default=[3e5, 1.2e6],
                   help="constant-schedule lr_scaled probes (EMA params)")
    p.add_argument("--anneal_lr", type=float, default=1.2e6,
                   help="annealed-schedule probe weight (0 disables)")
    p.add_argument("--anneal_start", type=float, default=0.01)
    p.add_argument("--raw_lr", type=float, nargs="*", default=[3e5],
                   help="raw (non-EMA) params probe weights")
    p.add_argument("--snap_min", type=int, default=0)
    p.add_argument("--cg_iters", type=int, default=6)
    p.add_argument("--eval_slice", default="val", choices=["val", "test"])
    p.add_argument("--n_probes", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    C.add_device_args(p)
    return p.parse_args(argv)


def setup(args):
    """The slice, its measurement, the ladder and the chains' operator."""
    S = args.size
    data = C.make_dataset(N_DATA, S, args.seed)
    sigmas = sigma_ladder(max_pairwise_distance(data, max_samples=256), 0.01,
                          args.levels)
    del data
    test = C.make_dataset(2, S, args.seed + 777)
    mask = random_cartesian_mask(S, args.R, args.center_frac,
                                 seed=args.seed).reshape(1, 1, S, 1)
    maps = C.sens_maps(S, args.num_sens, args.seed)
    phase = C.phase_field(args.seed + 3, 2, S)
    si = 0 if args.eval_slice == "test" else 1
    truth = torch.from_numpy(test[si:si + 1])
    sens_re = torch.as_tensor(maps[..., None], dtype=torch.float32)
    sens_im = torch.zeros((args.num_sens, S, S, 1))
    B = args.chains
    opB = PairSENSE(mask=torch.as_tensor(np.tile(mask, (B, 1, 1, 1)),
                                         dtype=torch.float32),
                    sens_re=sens_re, sens_im=sens_im)
    op1 = PairSENSE(mask=torch.as_tensor(mask, dtype=torch.float32),
                    sens_re=sens_re, sens_im=sens_im)
    yr1, yi1 = op1(truth * torch.cos(phase[si:si + 1]),
                   truth * torch.sin(phase[si:si + 1]))
    return dict(sigmas=sigmas, truth=truth, opB=opB, yr1=yr1, yi1=yi1)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = C.compute_dtype(device)
    st = setup(args)
    B = args.chains
    yrB = st["yr1"].repeat(1, B, 1, 1, 1)
    yiB = st["yi1"].repeat(1, B, 1, 1, 1)
    truth = st["truth"]
    model = get_network(C.ncsn_config(1, args.size, args.ngf))
    cfg = ALDConfig(n_steps_each=args.n_steps_each, step_lr=args.step_lr)

    def probe(lr_scaled, schedule, emit=None, resume_key=None):
        lrs = lr_scaled if schedule.startswith("const") else np.geomspace(
            args.anneal_start * lr_scaled, lr_scaled, args.levels)
        recon = make_stepped_pair_reconstructor(
            model, st["sigmas"], st["opB"],
            PairL2Penalty.with_normal_kernel(st["opB"],
                                             num_iters=args.cg_iters),
            cfg, lr_scaled=lrs, compute_dtype=dtype, device=device)
        t0 = time.time()
        acc, k0, rf = None, 0, None
        if resume_key is not None:
            rf = f"{args.out}.resume_{resume_key}.npz"
            if os.path.exists(rf):
                z = np.load(rf)
                acc, k0 = z["sum"], int(z["k"])
                log(f"resuming {resume_key} at probe {k0} "
                    f"({k0 * B} chains done)")
        for k in range(k0, args.n_probes):
            xr, xi = recon(yrB, yiB, seed=args.seed + 50 + 1000 * k)
            m = np.sqrt(C.to_cpu(xr).double().numpy() ** 2
                        + C.to_cpu(xi).double().numpy() ** 2).sum(axis=0)
            acc = m if acc is None else acc + m
            if rf is not None:
                np.savez(rf + ".tmp.npz", sum=acc, k=k + 1)
                os.replace(rf + ".tmp.npz", rf)
            if emit is not None and k + 1 < args.n_probes:
                pm = torch.from_numpy((acc / ((k + 1) * B)).astype(
                    np.float32))
                emit((k + 1) * B, float(nrmse(pm, truth[0])),
                     float(ssim(pm[..., 0], truth[0][..., 0])),
                     time.time() - t0)
        mag = torch.from_numpy((acc / (args.n_probes * B)).astype(np.float32))
        return (float(nrmse(mag, truth[0])),
                float(ssim(mag[..., 0], truth[0][..., 0])), time.time() - t0)

    done = {}
    if os.path.exists(args.out):
        for line in open(args.out):
            try:
                r = json.loads(line)
                if r.get("partial"):
                    continue
                k = (r["step"], r["kind"], r["lr_scaled"], r["schedule"],
                     r.get("n_steps_each"))
                done[k] = max(done.get(k, 0), r.get("chains", 0))
            except Exception:
                pass

    jobs = []
    for path in sorted(glob.glob(os.path.join(args.run, "prior_*.msgpack"))):
        step = int(os.path.basename(path)[6:-8])
        if step < args.snap_min:
            continue
        for lr in args.lr_grid:
            jobs.append((step, "ema", lr, "const", path))
        if args.anneal_lr:
            sched = ("anneal" if args.anneal_start == 0.01
                     else f"anneal{args.anneal_start:g}")
            jobs.append((step, "ema", args.anneal_lr, sched, path))
        raw = os.path.join(args.run, f"raw_{step:06d}.msgpack")
        if args.raw_lr and os.path.exists(raw):
            for lr in args.raw_lr:
                jobs.append((step, "raw", lr, "const", raw))
    if args.cg_iters != 6:
        jobs = [(s, k, lr, f"{sc}-cg{args.cg_iters}", p2)
                for s, k, lr, sc, p2 in jobs]
    jobs = [j for j in jobs
            if done.get(j[:4] + (args.n_steps_each,), -1) < B * args.n_probes]
    log(f"{len(jobs)} probes queued (chains={B}, "
        f"n_steps_each={args.n_steps_each})")
    run_id = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())

    def row(step, kind, lr, schedule, n, s, wall, chains, partial=False):
        out = {"step": step, "kind": kind, "lr_scaled": lr,
               "schedule": schedule, "nrmse": round(n, 4),
               "ssim": round(s, 4), "wall_s": round(wall, 1),
               "chains": chains, "slice": args.eval_slice,
               "n_steps_each": args.n_steps_each,
               "eff_weight": round(args.step_lr * lr, 3), "R": args.R}
        if partial:
            out["partial"] = True
        out.update(run=run_id,
                   ts=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
        log(json.dumps(out))

    last_path = None
    rows = []
    for step, kind, lr, schedule, path in jobs:
        if path != last_path:
            C.load_prior(model, path, log, f"step {step} {kind}")
            model.to(device)
            last_path = path

        def emit(nch, pn, ps, pwall, _job=(step, kind, lr, schedule)):
            row(*_job, pn, ps, pwall, nch, partial=True)

        rkey = f"{step}_{kind}_{lr:g}_{schedule}_n{args.n_steps_each}"
        n, s, wall = probe(lr, schedule,
                           emit=emit if args.n_probes > 1 else None,
                           resume_key=rkey if args.n_probes > 1 else None)
        row(step, kind, lr, schedule, n, s, wall, B * args.n_probes)
        rows.append((step, kind, lr, schedule, n, s))
    return rows


if __name__ == "__main__":
    main()

"""2D+time serving on the port: the experiment of
examples/cine_serving_demo.py, with its flags, defaults and results.json
keys.

Loads the cine-matrix priors (Flax msgpack files, utils/artifacts),
builds a `serving.CineReconstructionEngine` at 128², T = 24 with a
48-chain ensemble, and serves `--requests` requests, each with its own
per-frame mask, on one engine. Records the warm-up, each request's
latency, chain-steps/s and quality against the synthetic truth, and the
engine's count of distinct input signatures across requests
(`jit_cache_size`, the JAX engine's compile-cache size: per-request
masks are arguments, so it stays constant).

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
cine_serving_demo --priors artifacts/cine_priors_128 --chains 48 \\
      --levels 116 --out runs/cine_serving_demo
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from . import _common as C
from ..data.datasets import synthetic_cine
from ..models.ncsn1d import NCSN1D
from ..models.ncsnv2 import NCSNv2
from ..operators.fourier import MASK_PRESETS
from ..operators.masks import generate_mask
from ..operators.pair import PairSENSE
from ..samplers.sigmas import sigma_ladder
from ..serving.cine import CineEngineSpec, CineReconstructionEngine
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim
from ..utils.reshape import reshape_temporal_dim_np


def log(msg):
    print(f"[serve-demo] {msg}", flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--priors", default="runs/cine_matrix_r5_128/priors",
                   help="dir with spatial.msgpack + temporal.msgpack (the "
                        "cine matrix's; artifacts/cine_priors_128 holds "
                        "the repository's)")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--T", type=int, default=24)
    p.add_argument("--win", type=int, default=8)
    p.add_argument("--ngf_s", type=int, default=64)
    p.add_argument("--ngf_t", type=int, default=128)
    p.add_argument("--n_train", type=int, default=60,
                   help="the matrix run's training set, regenerated for "
                        "its sigma ladders (deterministic seed)")
    p.add_argument("--levels", type=int, default=116)
    p.add_argument("--levels_t", type=int, default=120)
    p.add_argument("--n_steps_each", type=int, default=3)
    p.add_argument("--step_lr", type=float, default=6.2e-6)
    p.add_argument("--lr_scaled", type=float, default=3e5)
    p.add_argument("--lamda_T", type=float, default=10.0)
    p.add_argument("--chains", type=int, default=48)
    p.add_argument("--R", type=int, default=8)
    p.add_argument("--requests", type=int, default=3)
    p.add_argument("--quick", action="store_true",
                   help="tiny spec (random weights where no prior is on "
                        "disk)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/cine_serving_demo")
    C.add_device_args(p)
    args = p.parse_args(argv)
    if args.quick:
        args.size, args.T, args.win = 32, 8, 4
        args.ngf_s, args.ngf_t = 16, 16
        args.n_train, args.levels, args.levels_t = 8, 12, 8
        args.chains, args.requests = 4, 3
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    S, T, win = args.size, args.T, args.win

    vids = synthetic_cine(args.n_train + 2, T, S, S, seed=args.seed)
    train_vids, test_vids = vids[:-2], vids[-2:]
    frames = train_vids.reshape(-1, S, S)[..., None]
    tubes = reshape_temporal_dim_np(train_vids, win, win)
    sigmas_S = sigma_ladder(max_pairwise_distance(frames, max_samples=256),
                            0.01, args.levels)
    sigmas_T = sigma_ladder(max_pairwise_distance(tubes, max_samples=256),
                            0.01, args.levels_t)

    model_S = NCSNv2(C.ncsn_config(1, S, args.ngf_s))
    model_T = NCSN1D(C.ncsn_config(win * win, T, args.ngf_t))

    def load(model, path, tag):
        if os.path.exists(path):
            return C.load_prior(model, path, log, tag)
        if args.quick:
            log(f"quick mode: no {tag} prior on disk, using init params")
            return model
        raise SystemExit(f"missing prior {path}: run the cine matrix "
                         "example first")

    load(model_S, os.path.join(args.priors, "spatial.msgpack"), "spatial")
    load(model_T, os.path.join(args.priors, "temporal.msgpack"), "temporal")

    spec = CineEngineSpec(
        height=S, width=S, frames=T, num_sens=4, chains=args.chains,
        n_steps_each=args.n_steps_each, step_lr=args.step_lr,
        lr_scaled=args.lr_scaled, mode_T="diffusion1d",
        lamda_T=args.lamda_T, win_size=win, if_random_shift=True,
        prox_iters=4, dtype="bf16" if device.type != "cpu" else "f32",
        mode="steps")
    preset = MASK_PRESETS.get(int(args.R))
    mask0 = generate_mask(T, S, seed=args.seed + args.R,
                          **preset).reshape(T, 1, S, 1)
    maps = C.sens_maps(S, 4, args.seed)
    sens_re = maps[..., None].astype(np.float32)
    sens_im = np.zeros((4, S, S, 1), np.float32)

    engine = CineReconstructionEngine(
        model_S, sigmas_S, spec=spec, model_T=model_T, sigmas_T=sigmas_T,
        mask=mask0, sens_re=sens_re, sens_im=sens_im, device=device)
    log(f"spec: {spec}")
    t_warm = engine.warmup()
    log(f"warmup (first run): {t_warm:.1f}s")

    truth = np.asarray(test_vids[0])                       # (T, S, S)
    phase = C.phase_field(args.seed + 3, 2, S)[0].numpy()  # (S, S, 1)
    xr = (truth[..., None] * np.cos(phase)).astype(np.float32)
    xi = (truth[..., None] * np.sin(phase)).astype(np.float32)

    rows = []
    for req in range(args.requests):
        mask = generate_mask(T, S, seed=args.seed + args.R + 17 * req,
                             **preset).reshape(T, 1, S, 1)
        op = PairSENSE(mask=torch.as_tensor(mask, dtype=torch.float32),
                       sens_re=torch.from_numpy(sens_re),
                       sens_im=torch.from_numpy(sens_im))
        yr, yi = op(torch.from_numpy(xr), torch.from_numpy(xi))
        res = engine.reconstruct(yr.numpy(), yi.numpy(), mask=mask,
                                 sens_re=sens_re, sens_im=sens_im,
                                 seed=100 + req)
        mag = torch.from_numpy(res.mean_mag[..., 0])
        t = torch.from_numpy(truth)
        n = float(nrmse(mag, t))
        s = float(np.mean([float(ssim(mag[f], t[f])) for f in range(T)]))
        st = engine.stats()
        row = {"request": req, "latency_s": round(res.latency_s, 1),
               "chain_steps_per_s": round(res.chain_steps_per_s, 1),
               "nrmse": round(n, 4), "ssim": round(s, 4),
               "jit_cache_size": st["input_signatures"]}
        rows.append(row)
        log(json.dumps(row))

    stats = engine.stats()
    caches = [r["jit_cache_size"] for r in rows]
    stable = all(c == caches[0] for c in caches)
    out = {"args": vars(args), "warmup_s": round(t_warm, 1),
           "requests": rows, "jit_cache_stable": stable,
           "stats": {k: v for k, v in stats.items() if k != "spec"}}
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(out, f, indent=2)
    log(f"input signatures stable across {args.requests} requests: "
        f"{stable}")
    log(json.dumps({"warmup_s": out["warmup_s"],
                    "mean_latency_s": stats["mean_latency_s"]}))
    if not stable:
        raise SystemExit("a new input signature across requests")
    return out


if __name__ == "__main__":
    main()

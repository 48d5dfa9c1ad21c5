"""2D+time quality matrix on the port: the cine experiment of
examples/cine_2d_time_quality_matrix.py, with its flags, defaults,
results.json keys and metrics.txt files.

Trains (or loads) a 2-D spatial NCSNv2 prior and a 1-D temporal NCSN1D
prior on synthetic beating-heart phantoms, then reconstructs R = {8, 16}
per-frame variable-density 4-coil SENSE measurements with every method
of the reference table:

  ZF | ALD (full / spatial-only / tv-temporal) |
  MAP (full / spatial-only / tv-temporal) | TV least squares

all in the real-pair pipeline. The priors are Flax msgpack files, read
and written by utils/artifacts: `--prior_dir` (default <out>/priors)
takes the repository's trained priors (artifacts/cine_priors_128) as it
takes the JAX script's. On the card the nets run in bf16 (the JAX
script's BF16Wrap) unless --f32.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
cine_2d_time_quality_matrix --size 128 --ngf_s 64 --ngf_t 128 --chains 8 \\
      --random_shift --tube_shift_aug 3 --filter_t 0.02 --Rs 8 \\
      --ald_lamdas 10 --lr_scaleds 3e5 --map_lamdas 0.03 --tv_regs 0.01 \\
      --prior_dir artifacts/cine_priors_128 --out runs/cine_matrix
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import _common as C
from ..data.datasets import synthetic_cine
from ..models.ncsn1d import NCSN1D, NCSN1DDeeper
from ..models.ncsnv2 import NCSNv2
from ..models.registry import make_score_fn
from ..operators.fourier import MASK_PRESETS
from ..operators.masks import generate_mask
from ..operators.pair import PairL2Penalty, PairSENSE
from ..samplers.ald import ALDConfig
from ..samplers.ald_pair import make_stepped_2d_time_pair_reconstructor
from ..samplers.map_opt import MAPConfig
from ..samplers.map_pair import (map_optimizer_2d_time_pair,
                                 tv_reconstruction_pair)
from ..samplers.sigmas import check_ladder_stability, sigma_ladder
from ..utils import artifacts
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim
from ..utils.reshape import reshape_temporal_dim_np

ORDER = ["ZF", "ALD", "ALD_spatial_only", "ALD_tv_only",
         "MAP", "MAP_spatial_only", "MAP_tv_only", "TV"]


def log(msg):
    print(f"[matrix] {msg}", flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--T", type=int, default=24)
    p.add_argument("--win", type=int, default=8)
    p.add_argument("--ngf_s", type=int, default=48)
    p.add_argument("--ngf_t", type=int, default=32)
    p.add_argument("--arch_t", default="ncsn1d",
                   choices=["ncsn1d", "ncsn1d_deeper"])
    p.add_argument("--n_train", type=int, default=60)
    p.add_argument("--steps_s", type=int, default=6000)
    p.add_argument("--steps_t", type=int, default=3000)
    p.add_argument("--levels", type=int, default=232)
    p.add_argument("--levels_t", type=int, default=120)
    p.add_argument("--n_steps_each", type=int, default=5)
    p.add_argument("--step_lr", type=float, default=6.2e-6)
    p.add_argument("--lr_scaled", type=float, default=30000.0)
    p.add_argument("--lr_scaleds", type=float, nargs="+", default=None,
                   help="data-consistency weight grid of the ALD variants, "
                        "tuned with lamda_T on video 0 (default: "
                        "--lr_scaled alone)")
    p.add_argument("--ald_lamdas", type=float, nargs="+",
                   default=[1.0, 3.0, 10.0])
    p.add_argument("--ald_tv_lamdas", type=float, nargs="+",
                   default=[0.003, 0.01, 0.03])
    p.add_argument("--retrain", action="store_true")
    p.add_argument("--filter_t", type=float, default=0.0)
    p.add_argument("--tube_shift_aug", type=int, default=0)
    p.add_argument("--random_shift", action="store_true")
    p.add_argument("--only", default=None,
                   help="comma-separated variants to run, e.g. "
                        "'ALD,ALD_tv_only'; default all")
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--map_iters", type=int, default=400)
    p.add_argument("--map_lr", type=float, default=5e-3)
    p.add_argument("--map_label", type=int, default=1)
    p.add_argument("--map_lamdas", type=float, nargs="+",
                   default=[0.03, 0.3, 3.0])
    p.add_argument("--tv_regs", type=float, nargs="+",
                   default=[0.01, 0.03, 0.1])
    p.add_argument("--Rs", type=int, nargs="+", default=[8, 16])
    p.add_argument("--tune_metric", default="nrmse",
                   choices=["nrmse", "ssim"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f32", action="store_true",
                   help="run the score nets in float32 on the card too")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", default="runs/cine_matrix")
    p.add_argument("--prior_dir", default=None,
                   help="directory of spatial.msgpack / temporal.msgpack "
                        "(default <out>/priors; trained there if absent)")
    C.add_device_args(p)
    args = p.parse_args(argv)
    if args.quick:
        args.size, args.T, args.win = 32, 8, 4
        args.ngf_s, args.ngf_t = 16, 16
        args.n_train, args.steps_s, args.steps_t = 8, 60, 40
        args.levels, args.levels_t = 16, 8
        args.chains, args.map_iters = 2, 30
        args.map_lamdas, args.tv_regs = [0.3], [0.03]
        args.Rs = [8]
    return args


def make_data(args):
    """Training frames and tubes and the two test videos, as the JAX
    script draws them."""
    S, T, win = args.size, args.T, args.win
    vids = synthetic_cine(args.n_train + 2, T, S, S, seed=args.seed)
    train_vids, test_vids = vids[:-2], vids[-2:]
    frames = train_vids.reshape(-1, S, S)[..., None]
    tubes = reshape_temporal_dim_np(train_vids, win, win)
    if args.tube_shift_aug > 0:
        rng_aug = np.random.RandomState(args.seed + 11)
        parts = [tubes]
        for _ in range(args.tube_shift_aug):
            sh, sw = rng_aug.randint(0, win, 2)
            rolled = np.roll(train_vids, (sh, sw), axis=(-2, -1))
            parts.append(reshape_temporal_dim_np(rolled, win, win))
        tubes = np.concatenate(parts, axis=0)
    if args.filter_t > 0:
        tv = np.abs(np.roll(tubes, -1, axis=1) - tubes).sum(axis=(1, 2)) \
            / (tubes.shape[1] * tubes.shape[2])
        keep = tv > args.filter_t
        log(f"foreground tube filter (th={args.filter_t}): "
            f"{int(keep.sum())}/{len(keep)} tubes kept")
        tubes = tubes[keep]
    return frames, tubes, test_vids


def ladders(args, frames, tubes):
    sigma_max_s = max_pairwise_distance(frames, max_samples=256)
    sigma_max_t = max_pairwise_distance(tubes, max_samples=256)
    sigmas_S = sigma_ladder(sigma_max_s, 0.01, args.levels)
    sigmas_T = sigma_ladder(sigma_max_t, 0.01, args.levels_t)
    log(f"sigma_max spatial {sigma_max_s:.1f}, temporal {sigma_max_t:.1f}")
    return sigmas_S, sigmas_T


def build_nets(args):
    model_S = NCSNv2(C.ncsn_config(1, args.size, args.ngf_s))
    cfg_t = C.ncsn_config(args.win * args.win, args.T, args.ngf_t)
    model_T = (NCSN1DDeeper(cfg_t) if args.arch_t == "ncsn1d_deeper"
               else NCSN1D(cfg_t))
    return model_S, model_T


def truth_pair(args, test_vids):
    """The test videos (2, T, S, S) and their complex pair (2, T, S, S, 1)
    with the smooth synthetic phase."""
    truth = torch.from_numpy(np.asarray(test_vids))
    phase = C.phase_field(args.seed + 3, 2, args.size)    # (2, S, S, 1)
    xr = truth[..., None] * torch.cos(phase[:, None])
    xi = truth[..., None] * torch.sin(phase[:, None])
    return truth, xr, xi


def r_mask(args, R):
    preset = MASK_PRESETS.get(int(R))
    if preset is None:
        raise SystemExit(f"no mask preset for R={R}")
    mask = generate_mask(args.T, args.size, seed=args.seed + R, **preset)
    return torch.as_tensor(mask.reshape(args.T, 1, args.size, 1),
                           dtype=torch.float32)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = C.compute_dtype(device, args.f32)
    os.makedirs(args.out, exist_ok=True)
    S, T, win = args.size, args.T, args.win

    frames, tubes, test_vids = make_data(args)
    log(f"train frames {frames.shape}, tubes {tubes.shape}")
    sigmas_S, sigmas_T = ladders(args, frames, tubes)
    ratio = check_ladder_stability(sigmas_S, args.n_steps_each, args.step_lr)
    log(f"ladder stability ratio {ratio:.1f} (must be >= 1)")

    model_S, model_T = build_nets(args)
    prior_dir = args.prior_dir or os.path.join(args.out, "priors")
    os.makedirs(prior_dir, exist_ok=True)

    def get_prior(model, data, sigmas_net, batch, steps, seed, tag, path):
        if not args.retrain and os.path.exists(path):
            return C.load_prior(model, path, log, tag).to(device).eval()
        C.train_score_net(model, data, sigmas_net, batch, steps, seed, tag,
                          ckpt_path=path + ".ckpt", retrain=args.retrain,
                          device=device, dtype=dtype, log=log)
        artifacts.save_prior(model, path)
        C.remove(path + ".ckpt", path + ".ckpt.fp")
        return model

    model_S = get_prior(model_S, frames, sigmas_S, 32, args.steps_s,
                        args.seed, "spatial",
                        os.path.join(prior_dir, "spatial.msgpack"))
    model_T = get_prior(model_T, tubes, sigmas_T, 128, args.steps_t,
                        args.seed + 5, "temporal",
                        os.path.join(prior_dir, "temporal.msgpack"))

    truth, xr_true, xi_true = truth_pair(args, test_vids)
    maps = C.sens_maps(S, 4, args.seed)
    sens_re = torch.as_tensor(maps[..., None], dtype=torch.float32)
    sens_im = torch.zeros((4, S, S, 1), dtype=torch.float32)

    def eval_recon(xr, xi, vid_idx):
        """xr: (B, T, S, S, 1) ensemble -> mean magnitude metrics: NRMSE,
        SSIM, the magnitude, and the SSIM with bf16 windows (the value
        the JAX script's TPU runs report; utils/metrics.ssim)."""
        m = C.mag(C.to_cpu(xr), C.to_cpu(xi)).mean(dim=0)[..., 0]
        t = truth[vid_idx]
        n = float(nrmse(m, t))
        s = float(np.mean([float(ssim(m[f], t[f])) for f in range(T)]))
        st = float(np.mean([float(ssim(m[f], t[f], bf16_window=True))
                            for f in range(T)]))
        return n, s, m.numpy(), st

    def tune_key(n, s):
        return n if args.tune_metric == "nrmse" else -s

    score_S = make_score_fn(model_S, sigmas_S, dtype)
    score_T_raw = make_score_fn(model_T, sigmas_T, dtype)

    def score_T(x, labels):
        return score_T_raw(x, torch.clamp(labels, max=args.levels_t - 1))

    only = (None if args.only is None
            else {v.strip() for v in args.only.split(",")})
    lr_grid = args.lr_scaleds or [args.lr_scaled]
    results, tuned = {}, {}
    for R in args.Rs:
        mask = r_mask(args, R)
        out_R, mags_R = {}, {}
        for vid in range(2):
            def make_op(B):
                return PairSENSE(mask=mask.repeat(B, 1, 1, 1),
                                 sens_re=sens_re, sens_im=sens_im)

            op1 = make_op(1)
            fr = xr_true[vid].reshape(T, S, S, 1)
            fi = xi_true[vid].reshape(T, S, S, 1)
            yr1, yi1 = op1(fr, fi)                    # (4, T, S, S, 1)
            zr, zi = op1.conj_op(yr1, yi1)
            n, s, m, st = eval_recon(zr.reshape(1, T, S, S, 1),
                                     zi.reshape(1, T, S, S, 1), vid)
            out_R.setdefault("ZF", []).append((n, s, st))
            log(f"R={R} vid{vid} ZF: NRMSE {n:.4f} SSIM {s:.4f}")
            if vid == 0:
                mags_R["ZF"] = m
                mags_R["original"] = truth[0].numpy()

            B = args.chains
            opB = make_op(B)
            yrB = yr1.repeat(1, B, 1, 1, 1).to(device)
            yiB = yi1.repeat(1, B, 1, 1, 1).to(device)
            proxB = PairL2Penalty.with_normal_kernel(opB, num_iters=4)
            ald_cfg = ALDConfig(n_steps_each=args.n_steps_each,
                                step_lr=args.step_lr)

            def run_ald(mode_T, lamda_T, lr_scaled, key_off):
                recon = make_stepped_2d_time_pair_reconstructor(
                    model_S, model_T, sigmas_S, sigmas_T, opB, proxB,
                    ald_cfg, lr_scaled=lr_scaled, mode_T=mode_T,
                    lamda_T=lamda_T, if_random_shift=args.random_shift,
                    win_size=win, num_frames=T, compute_dtype=dtype,
                    device=device)
                xr, xi = recon(yrB, yiB, seed=args.seed + key_off)
                return eval_recon(xr, xi, vid)

            for name, mode_T, grid in (
                    ("ALD", "diffusion1d", args.ald_lamdas),
                    ("ALD_spatial_only", "none", [1.0]),
                    ("ALD_tv_only", "tv", args.ald_tv_lamdas)):
                if only is not None and name not in only:
                    continue
                t0 = time.time()
                if vid == 0:
                    best = None
                    for lam in grid:
                        for lrs in lr_grid:
                            n, s, m, st = run_ald(mode_T, lam, lrs,
                                                  11 + vid)
                            if len(grid) > 1 or len(lr_grid) > 1:
                                log(f"R={R} vid0 {name} lamda_T={lam} "
                                    f"lr_scaled={lrs:g}: "
                                    f"NRMSE {n:.4f} SSIM {s:.4f}")
                            if best is None or tune_key(n, s) < best[0]:
                                best = (tune_key(n, s), n, s, (lam, lrs), m,
                                        st)
                    _, n, s, (lam, lrs), mags_R[name], row_tpu = best
                    tuned.setdefault(f"R_{R}", {})[name] = (lam, lrs)
                else:
                    lam, lrs = tuned[f"R_{R}"][name]
                    n, s, _, row_tpu = run_ald(mode_T, lam, lrs, 11 + vid)
                log(f"R={R} vid{vid} {name} (lamda_T={lam}, "
                    f"lr_scaled={lrs:g}): NRMSE {n:.4f} "
                    f"SSIM {s:.4f} ({time.time() - t0:.0f}s)")
                out_R.setdefault(name, []).append((n, s, row_tpu))

            map_cfg = MAPConfig(n_iters=args.map_iters, lr=args.map_lr)

            def run_map(mode_T, lamda):
                return map_optimizer_2d_time_pair(
                    score_S, score_T, (yr1, yi1), op1, config=map_cfg,
                    prior_weight=lamda, mode_T=mode_T, win_size=win,
                    num_frames=T, prior_label=args.map_label, device=device)

            for name, mode_T in (("MAP", "diffusion1d"),
                                 ("MAP_spatial_only", "none"),
                                 ("MAP_tv_only", "tv")):
                if only is not None and name not in only:
                    continue
                t0 = time.time()
                if vid == 0:
                    best = None
                    for lam in args.map_lamdas:
                        xr, xi = run_map(mode_T, lam)
                        n, s, m, st = eval_recon(xr, xi, vid)
                        log(f"R={R} vid0 {name} lamda={lam}: "
                            f"NRMSE {n:.4f} SSIM {s:.4f}")
                        if best is None or tune_key(n, s) < best[0]:
                            best = (tune_key(n, s), n, s, lam, m, st)
                    _, n, s, lam, mags_R[name], row_tpu = best
                    tuned.setdefault(f"R_{R}", {})[name] = lam
                else:
                    lam = tuned[f"R_{R}"][name]
                    xr, xi = run_map(mode_T, lam)
                    n, s, _, row_tpu = eval_recon(xr, xi, vid)
                log(f"R={R} vid{vid} {name} (lamda={lam}): NRMSE {n:.4f} "
                    f"SSIM {s:.4f} ({time.time() - t0:.0f}s)")
                out_R.setdefault(name, []).append((n, s, row_tpu))

            if only is None or "TV" in only:
                t0 = time.time()

                def run_tv(reg):
                    xr, xi = tv_reconstruction_pair(
                        (yr1, yi1), op1, reg_weight=reg,
                        config=MAPConfig(n_iters=args.map_iters,
                                         lr=args.map_lr), device=device)
                    return eval_recon(xr.reshape(1, T, S, S, 1),
                                      xi.reshape(1, T, S, S, 1), vid)

                if vid == 0:
                    best = None
                    for reg in args.tv_regs:
                        n, s, m, st = run_tv(reg)
                        log(f"R={R} vid0 TV reg={reg}: NRMSE {n:.4f} "
                            f"SSIM {s:.4f}")
                        if best is None or tune_key(n, s) < best[0]:
                            best = (tune_key(n, s), n, s, reg, m, st)
                    _, n, s, reg, mags_R["TV"], row_tpu = best
                    tuned.setdefault(f"R_{R}", {})["TV"] = reg
                else:
                    reg = tuned[f"R_{R}"]["TV"]
                    n, s, _, row_tpu = run_tv(reg)
                log(f"R={R} vid{vid} TV (reg={reg}): NRMSE {n:.4f} "
                    f"SSIM {s:.4f} ({time.time() - t0:.0f}s)")
                out_R.setdefault("TV", []).append((n, s, row_tpu))

        results[f"R_{R}"] = {
            name: {"nrmse": round(float(np.mean([v[0] for v in vals])), 4),
                   "ssim": round(float(np.mean([v[1] for v in vals])), 4),
                   "ssim_bf16_window": round(
                       float(np.mean([v[2] for v in vals])), 4)}
            for name, vals in out_R.items()}
        for name, m in results[f"R_{R}"].items():
            d = os.path.join(args.out, f"R_{R}", name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "metrics.txt"), "w") as f:
                f.write(f"NRMSE: {m['nrmse']}, SSIM: {m['ssim']}\n")
        write_figures(args.out, R, mags_R)

    summary = summary_table(args, results)
    tag = "" if args.only is None else "_partial"
    with open(os.path.join(args.out, f"RESULTS{tag}.md"), "w") as f:
        f.write(summary)
    with open(os.path.join(args.out, f"results{tag}.json"), "w") as f:
        json.dump({"args": vars(args), "results": results,
                   "tuned_hyperparams": tuned}, f, indent=2)
    print(summary)
    return results


def write_figures(out, R, mags_R):
    """Frame strip and GIF of video 0's tuned-best reconstruction per
    variant (matplotlib and Pillow; skipped where they are missing)."""
    from ..utils.visualizations import (grid_of_temporal_samples,
                                        save_vol_as_gif)
    for name, mag in mags_R.items():
        d = os.path.join(out, f"R_{R}", name)
        os.makedirs(d, exist_ok=True)
        try:
            grid_of_temporal_samples(np.asarray(mag), num_frames=6,
                                     save_path=os.path.join(d, "frames.png"))
            save_vol_as_gif(np.asarray(mag), os.path.join(d, "recon.gif"))
        except ImportError as e:
            log(f"figures skipped: {e}")
            return


def summary_table(args, results) -> str:
    S = args.size
    lines = ["# 2D+time quality matrix (synthetic cine, 4-coil SENSE)", "",
             f"size {S}^2, T={args.T}, {args.chains}-chain ALD ensembles, "
             f"spatial NCSNv2 ngf{args.ngf_s} ({args.steps_s} steps), "
             f"temporal NCSN1D ngf{args.ngf_t} ({args.steps_t} steps)", "",
             "| method | " + " | ".join(
                 f"R={R} NRMSE / SSIM" for R in args.Rs) + " |",
             "|---|" + "---|" * len(args.Rs)]
    for name in ORDER:
        row = [name]
        for R in args.Rs:
            m = results.get(f"R_{R}", {}).get(name)
            row.append(f"{m['nrmse']:.4f} / {m['ssim']:.4f}" if m else "-")
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    main()

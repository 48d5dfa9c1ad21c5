"""ACDC SENSE ensemble on the port: the experiment of
examples/acdc_sense_ensemble.py (the reference README's "mean of 105
ALD reconstructions outperforms MAP and TV"), with its flags, defaults,
metrics.txt and results.json keys.

Trains (or loads) an NCSNv2-family score prior on synthetic short-axis
slices, then reconstructs an R = 40 4-coil SENSE measurement (uniform
Cartesian lines and a centre band) with ZF, the ALD ensemble mean, MAP
and TV; MAP's and TV's weights (and ALD's data-consistency weight, given
a grid) are tuned on a validation slice, every method reports on the
test slice. The prior is a Flax msgpack file (`--prior_path`, default
<out>/prior.msgpack: a JAX run's prior loads here, and this run's in
JAX). On the card the net runs in bf16 unless --f32.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
acdc_sense_ensemble [--quick] [--steps 12000] [--chains 105] --out runs/acdc
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import _common as C
from ..models.registry import get_network, make_score_fn
from ..operators.masks import random_cartesian_mask
from ..operators.pair import PairL2Penalty, PairSENSE
from ..samplers.ald import ALDConfig
from ..samplers.ald_pair import make_stepped_pair_reconstructor
from ..samplers.map_opt import MAPConfig
from ..samplers.map_pair import map_optimizer_pair, tv_reconstruction_pair
from ..samplers.sigmas import check_ladder_stability, sigma_ladder
from ..utils import artifacts
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim

make_dataset = C.make_dataset


def log(msg):
    print(f"[acdc] {msg}", flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--ngf", type=int, default=48)
    p.add_argument("--n_train", type=int, default=400)
    p.add_argument("--steps", type=int, default=12000)
    p.add_argument("--train_batch", type=int, default=32)
    p.add_argument("--levels", type=int, default=232)
    p.add_argument("--n_steps_each", type=int, default=5)
    p.add_argument("--step_lr", type=float, default=6.2e-6)
    p.add_argument("--lr_scaled", type=float, default=30000.0)
    p.add_argument("--ald_lr_scaled_grid", type=float, nargs="+",
                   default=[3000.0, 10000.0, 30000.0, 100000.0],
                   help="data-consistency weights tried on the val slice; "
                        "one value skips tuning")
    p.add_argument("--chains", type=int, default=105)
    p.add_argument("--chain_chunk", type=int, default=35)
    p.add_argument("--R", type=int, default=40)
    p.add_argument("--center_frac", type=float, default=1 / 16)
    p.add_argument("--num_sens", type=int, default=4)
    p.add_argument("--map_iters", type=int, default=400)
    p.add_argument("--map_lr", type=float, default=5e-3)
    p.add_argument("--map_lamdas", type=float, nargs="+",
                   default=[0.01, 0.03, 0.1, 0.3])
    p.add_argument("--tv_regs", type=float, nargs="+",
                   default=[0.0003, 0.001, 0.003, 0.01])
    p.add_argument("--retrain", action="store_true")
    p.add_argument("--prior_path", default=None,
                   help="score-net msgpack to load (default "
                        "<out>/prior.msgpack)")
    p.add_argument("--ald_anneal_start", type=float, default=1.0,
                   help="multiplier on lr_scaled at the top of the ladder, "
                        "geometric to 1x at the bottom (1 = constant)")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--only", default=None,
                   help="comma subset of {ZF,ALD,MAP,TV}; default all")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/acdc_sense")
    C.add_device_args(p)
    args = p.parse_args(argv)
    if args.quick:
        args.size, args.ngf, args.n_train = 32, 16, 32
        args.steps, args.levels = 60, 16
        args.chains, args.chain_chunk = 4, 2
        args.map_iters = 30
        args.map_lamdas, args.tv_regs = [0.3], [0.03]
        args.ald_lr_scaled_grid = [args.lr_scaled]
    return args


def setup(args):
    """Ladder, mask, coil maps, phase and the test / val measurements:
    the inputs the JAX script draws. Returns a dict."""
    S = args.size
    data = make_dataset(args.n_train, S, args.seed)
    sigma_max = max_pairwise_distance(data, max_samples=256)
    sigmas = sigma_ladder(sigma_max, 0.01, args.levels)
    test = make_dataset(2, S, args.seed + 777)
    mask = random_cartesian_mask(S, args.R, args.center_frac,
                                 seed=args.seed).reshape(1, 1, S, 1)
    maps = C.sens_maps(S, args.num_sens, args.seed)
    phase = C.phase_field(args.seed + 3, 2, S)
    sens_re = torch.as_tensor(maps[..., None], dtype=torch.float32)
    sens_im = torch.zeros((args.num_sens, S, S, 1))

    def make_op(B):
        return PairSENSE(mask=torch.as_tensor(np.tile(mask, (B, 1, 1, 1)),
                                              dtype=torch.float32),
                         sens_re=sens_re, sens_im=sens_im)

    op1 = make_op(1)
    slices = {}
    for role, idx in (("test", 0), ("val", 1)):
        truth = torch.from_numpy(test[idx:idx + 1])
        yr, yi = op1(truth * torch.cos(phase[idx:idx + 1]),
                     truth * torch.sin(phase[idx:idx + 1]))
        slices[role] = dict(truth=truth, yr=yr, yi=yi)
    return dict(data=data, sigma_max=sigma_max, sigmas=sigmas, mask=mask,
                maps=maps, make_op=make_op, op1=op1, slices=slices)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = C.compute_dtype(device, args.f32)
    os.makedirs(args.out, exist_ok=True)
    S = args.size
    st = setup(args)
    sigmas, data = st["sigmas"], st["data"]
    ratio = check_ladder_stability(sigmas, args.n_steps_each, args.step_lr)
    log(f"{data.shape} slices; sigma_max {st['sigma_max']:.1f}; "
        f"ladder stability {ratio:.1f}")

    model = get_network(C.ncsn_config(1, S, args.ngf))
    log(f"arch: {type(model).__name__} (size {S})")
    prior_path = args.prior_path or os.path.join(args.out, "prior.msgpack")
    if args.prior_path and not os.path.exists(args.prior_path):
        raise SystemExit(f"--prior_path {args.prior_path} does not exist")
    if not args.retrain and os.path.exists(prior_path):
        try:
            C.load_prior(model, prior_path, log)
        except (KeyError, ValueError) as e:
            raise SystemExit(
                f"failed to load {prior_path} into the size-dispatched arch "
                f"{type(model).__name__} (size {S}): {e}\nIf this prior "
                "was trained with another architecture, pass --retrain.")
        model.to(device).eval()
    else:
        C.train_score_net(model, data, sigmas, args.train_batch,
                          args.steps, args.seed, "prior",
                          ckpt_path=prior_path + ".ckpt",
                          retrain=args.retrain, device=device, dtype=dtype,
                          log=log)
        artifacts.save_prior(model, prior_path)
        C.remove(prior_path + ".ckpt", prior_path + ".ckpt.fp")

    slices, op1 = st["slices"], st["op1"]
    only = (None if args.only is None
            else {v.strip() for v in args.only.split(",")})

    def want(name):
        return only is None or name in only

    def eval_mag(mag, role):
        t = slices[role]["truth"][0]
        mag = C.to_cpu(mag)
        return (float(nrmse(mag, t)), float(ssim(mag[..., 0], t[..., 0])))

    out_rows, mags = {}, {}
    r = slices["test"]
    zr, zi = op1.conj_op(r["yr"], r["yi"])
    zf_mag = C.mag(zr, zi)[0]
    out_rows["ZF"] = eval_mag(zf_mag, "test")
    mags["ZF"] = zf_mag.numpy()
    mags["original"] = r["truth"][0].numpy()
    log(f"ZF: NRMSE {out_rows['ZF'][0]:.4f} SSIM {out_rows['ZF'][1]:.4f}")

    if want("ALD"):
        cfg = ALDConfig(n_steps_each=args.n_steps_each, step_lr=args.step_lr)
        B = args.chain_chunk
        opB = st["make_op"](B)

        def make_recon(lr_scaled):
            if args.ald_anneal_start != 1.0:
                lr_scaled = np.geomspace(args.ald_anneal_start * lr_scaled,
                                         lr_scaled, args.levels)
            return make_stepped_pair_reconstructor(
                model, sigmas, opB,
                PairL2Penalty.with_normal_kernel(opB, num_iters=6), cfg,
                lr_scaled=lr_scaled, compute_dtype=dtype, device=device)

        if len(args.ald_lr_scaled_grid) > 1:
            v = slices["val"]
            yrV = v["yr"].repeat(1, B, 1, 1, 1)
            yiV = v["yi"].repeat(1, B, 1, 1, 1)
            best = None
            for lrs in args.ald_lr_scaled_grid:
                xrv, xiv = make_recon(lrs)(yrV, yiV, seed=args.seed + 50)
                n, s = eval_mag(C.mag(xrv, xiv).mean(dim=0), "val")
                log(f"val ALD lr_scaled={lrs:g}: NRMSE {n:.4f} "
                    f"SSIM {s:.4f}")
                if best is None or n < best[0]:
                    best = (n, lrs)
            args.lr_scaled = best[1]
            log(f"ALD lr_scaled tuned to {args.lr_scaled:g}")

        recon = make_recon(args.lr_scaled)
        n_chunks = (args.chains + B - 1) // B
        yrB = r["yr"].repeat(1, B, 1, 1, 1)
        yiB = r["yi"].repeat(1, B, 1, 1, 1)
        t0 = time.time()
        acc_re, acc_im = [], []
        for c in range(n_chunks):
            xr, xi = recon(yrB, yiB, seed=args.seed + 100 + c)
            acc_re.append(C.to_cpu(xr).numpy())
            acc_im.append(C.to_cpu(xi).numpy())
        xr = np.concatenate(acc_re)[: args.chains]
        xi = np.concatenate(acc_im)[: args.chains]
        wall = time.time() - t0
        ens_mag = torch.from_numpy(np.sqrt(xr ** 2 + xi ** 2).mean(axis=0))
        out_rows["ALD"] = eval_mag(ens_mag, "test")
        mags["ALD"] = ens_mag.numpy()
        mags["ALD_std"] = np.sqrt(xr ** 2 + xi ** 2).std(axis=0)
        log(f"ALD x{args.chains}: NRMSE {out_rows['ALD'][0]:.4f} "
            f"SSIM {out_rows['ALD'][1]:.4f} ({wall:.0f}s)")

    map_cfg = MAPConfig(n_iters=args.map_iters, lr=args.map_lr)
    score_fn = make_score_fn(model, sigmas, dtype)

    def f_map(yr, yi, lamda):
        return map_optimizer_pair(score_fn, (yr, yi), op1, lamda,
                                  config=map_cfg, device=device)

    best = None
    for lam in (args.map_lamdas if want("MAP") else []):
        v = slices["val"]
        xr1, xi1 = f_map(v["yr"], v["yi"], lam)
        n, s = eval_mag(C.mag(xr1, xi1)[0], "val")
        log(f"val MAP lamda={lam}: NRMSE {n:.4f} SSIM {s:.4f}")
        if best is None or n < best[0]:
            best = (n, lam)
    if want("MAP"):
        lam = best[1]
        xr1, xi1 = f_map(r["yr"], r["yi"], lam)
        map_mag = C.to_cpu(C.mag(xr1, xi1)[0])
        out_rows["MAP"] = eval_mag(map_mag, "test")
        mags["MAP"] = map_mag.numpy()
        log(f"MAP (lamda={lam}): NRMSE {out_rows['MAP'][0]:.4f} "
            f"SSIM {out_rows['MAP'][1]:.4f}")

    def f_tv(yr, yi, reg):
        return tv_reconstruction_pair((yr, yi), op1, reg_weight=reg,
                                      config=map_cfg, device=device)

    best = None
    for reg in (args.tv_regs if want("TV") else []):
        v = slices["val"]
        xr1, xi1 = f_tv(v["yr"], v["yi"], reg)
        n, s = eval_mag(C.mag(xr1, xi1)[0], "val")
        log(f"val TV reg={reg}: NRMSE {n:.4f} SSIM {s:.4f}")
        if best is None or n < best[0]:
            best = (n, reg)
    if want("TV"):
        reg = best[1]
        xr1, xi1 = f_tv(r["yr"], r["yi"], reg)
        tv_mag = C.to_cpu(C.mag(xr1, xi1)[0])
        out_rows["TV"] = eval_mag(tv_mag, "test")
        mags["TV"] = tv_mag.numpy()
        log(f"TV (reg={reg}): NRMSE {out_rows['TV'][0]:.4f} "
            f"SSIM {out_rows['TV'][1]:.4f}")

    comparison_figure(args, mags, out_rows)
    rows = {k: {"nrmse": round(v[0], 4), "ssim": round(v[1], 4)}
            for k, v in out_rows.items()}
    with open(os.path.join(args.out, "metrics.txt"), "w") as f:
        for k, v in rows.items():
            f.write(f"{k}: NRMSE {v['nrmse']}, SSIM {v['ssim']}\n")
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump({"args": vars(args), "results": rows}, f, indent=2)
    log(json.dumps(rows))
    return rows


def comparison_figure(args, mags, out_rows):
    """comparison.png (matplotlib; skipped where it is missing)."""
    try:
        import matplotlib
    except ImportError:
        log("matplotlib missing: comparison.png not drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    names = [n for n in ("original", "ZF", "ALD", "MAP", "TV") if n in mags]
    extra = 1 if "ALD_std" in mags else 0
    fig, axes = plt.subplots(1, len(names) + extra, figsize=(3 * 6, 3.2),
                             squeeze=False)
    axes = axes[0]
    for ax, name in zip(axes, names):
        ax.imshow(np.squeeze(mags[name]), cmap="gray")
        title = name if name == "original" else (
            f"{name}\nNRMSE {out_rows[name][0]:.3f} / "
            f"SSIM {out_rows[name][1]:.3f}")
        ax.set_title(title, fontsize=9)
        ax.set_axis_off()
    if extra:
        axes[-1].imshow(np.squeeze(mags["ALD_std"]), cmap="viridis")
        axes[-1].set_title(f"ALD std ({args.chains} chains)", fontsize=9)
        axes[-1].set_axis_off()
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "comparison.png"), dpi=130)
    plt.close(fig)


if __name__ == "__main__":
    main()

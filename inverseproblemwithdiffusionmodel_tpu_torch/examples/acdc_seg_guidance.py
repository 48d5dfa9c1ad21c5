"""Segmentation-guided ALD ablation on the port: the experiment of
examples/acdc_seg_guidance.py, with its flags, defaults, metrics.txt and
results.json keys.

Trains (or loads) an NCSNv2 prior and a small seg UNet on synthetic
short-axis phantoms (myocardium masks), then reconstructs an R-fold
single-coil variable-density measurement with the pair-form ALD
reconstructor: ZF | ALD | ALD + seg guidance. The data-consistency
weight is tuned on a validation slice with the guidance off, then the
guidance weight with it on; the test slices' NRMSE / SSIM / Dice of
seg(recon) are averaged, each slice's two conditions on one seed. The
prior and the seg net are Flax msgpack files (<out>/prior.msgpack,
<out>/seg.msgpack), so either package's load in the other.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
acdc_seg_guidance [--quick] [--out runs/acdc_seg]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import _common as C
from ..data import transforms as dT
from ..data.datasets import synthetic_acdc_slice
from ..models.ncsnv2 import NCSNv2
from ..models.registry import to_nchw
from ..models.unet import UNet
from ..operators.fourier import RandomUndersamplingFourier
from ..operators.pair import PairL2Penalty, PairRandomUndersamplingFourier
from ..samplers.ald import ALDConfig
from ..samplers.ald_pair import make_stepped_pair_reconstructor
from ..samplers.sigmas import check_ladder_stability, sigma_ladder
from ..training import TrainState, get_optimizer, make_seg_train_step
from ..utils import artifacts
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device
from ..utils.metrics import nrmse, ssim


def log(msg):
    print(f"[seg] {msg}", flush=True)


def make_dataset(n: int, size: int, seed: int):
    """Synthetic slices (n, size, size, 1) and myocardium masks."""
    rng = np.random.RandomState(seed)
    imgs = np.empty((n, size, size, 1), np.float32)
    masks = np.empty((n, size, size), np.int32)
    for i in range(n):
        img, label = synthetic_acdc_slice(rng)
        img = dT.scale_intensity(img)
        imgs[i, ..., 0] = dT.resize(img, (size, size))[0]
        masks[i] = dT.resize((label == 3).astype(np.float32), (size, size),
                             mode="nearest")[0].astype(np.int32)
    return imgs, masks


def dice(pred: np.ndarray, ref: np.ndarray) -> float:
    inter = float((pred * ref).sum())
    return 2.0 * inter / max(float(pred.sum() + ref.sum()), 1.0)


def train_seg_net(model, imgs, masks, batch, steps, seed, ckpt_path=None,
                  perturb_sigmas=None, device="cuda"):
    """DiceCE training (Adam 3e-4, clip 1; batches from RandomState(seed
    * 100003 + s)), or the saved net at ckpt_path. Returns the model with
    its trained (EMA) weights."""
    model = model.to(device)
    if ckpt_path and os.path.exists(ckpt_path):
        log("loading saved seg net")
        return C.load_prior(model, ckpt_path, log, "seg").eval()
    state = TrainState.create(model, get_optimizer(C.adam_config(3e-4)),
                              ema_decay=0.999)
    if perturb_sigmas is not None:
        step_fn = make_seg_train_step(model, perturb_sigmas, perturb=True)
    else:
        step_fn = make_seg_train_step(model, [1.0])
    n = imgs.shape[0]
    t0 = time.time()
    for s in range(steps):
        idx = np.random.RandomState(seed * 100003 + s).randint(0, n,
                                                               size=batch)
        state, loss = step_fn(state, (imgs[idx], masks[idx]),
                              C.step_generator(seed + 7, s, device))
        if s % max(steps // 10, 1) == 0 or s == steps - 1:
            log(f"seg step {s}: loss {float(loss):.4f} "
                f"({time.time() - t0:.0f}s)")
    C.load_params(model, state.eval_params)
    if ckpt_path:
        artifacts.save_prior(model, ckpt_path)
    return model.eval()


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--ngf", type=int, default=48)
    p.add_argument("--n_train", type=int, default=400)
    p.add_argument("--steps", type=int, default=12000)
    p.add_argument("--seg_steps", type=int, default=1500)
    p.add_argument("--levels", type=int, default=232)
    p.add_argument("--n_steps_each", type=int, default=5)
    p.add_argument("--step_lr", type=float, default=6.2e-6)
    p.add_argument("--lr_scaled_grid", type=float, nargs="+",
                   default=[1e5, 3e5, 1e6, 3e6])
    p.add_argument("--seg_lamda_grid", type=float, nargs="+",
                   default=[3.0, 10.0, 30.0, 100.0])
    p.add_argument("--seg_start_time", type=float, default=0.0)
    p.add_argument("--seg_mode", default="full", choices=["full", "FG"])
    p.add_argument("--seg_perturb", action="store_true")
    p.add_argument("--seg_perturb_max_sigma", type=float, default=1.0)
    p.add_argument("--n_test", type=int, default=3)
    p.add_argument("--chains", type=int, default=35)
    p.add_argument("--R", type=int, default=8)
    p.add_argument("--center_frac", type=float, default=1 / 16)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/acdc_seg")
    C.add_device_args(p)
    args = p.parse_args(argv)
    if args.quick:
        args.size, args.ngf, args.n_train = 32, 16, 32
        args.steps, args.seg_steps, args.levels = 60, 40, 16
        args.chains = 4
        args.n_test = 1
        args.lr_scaled_grid = [3e4]
        args.seg_lamda_grid = [10.0]
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = C.compute_dtype(device, args.f32)
    os.makedirs(args.out, exist_ok=True)
    S = args.size

    imgs, masks = make_dataset(args.n_train, S, args.seed)
    sigma_max = max_pairwise_distance(imgs, max_samples=256)
    sigmas = sigma_ladder(sigma_max, 0.01, args.levels)
    ratio = check_ladder_stability(sigmas, args.n_steps_each, args.step_lr)
    log(f"{imgs.shape} slices; sigma_max {sigma_max:.1f}; "
        f"ladder stability {ratio:.1f}")

    model = NCSNv2(C.ncsn_config(1, S, args.ngf))
    prior_path = os.path.join(args.out, "prior.msgpack")
    alt = os.path.join(os.path.dirname(args.out), "acdc_sense",
                       "prior.msgpack")
    if not os.path.exists(prior_path) and os.path.exists(alt) \
            and not args.quick:
        prior_path = alt
    if os.path.exists(prior_path):
        log(f"loading saved prior ({prior_path})")
        try:
            C.load_prior(model, prior_path, log)
            model.to(device).eval()
        except (KeyError, ValueError):
            log(f"saved prior at {prior_path} has mismatched shapes "
                "(different size/ngf); retraining")
            C.train_score_net(model, imgs, sigmas, 32, args.steps,
                              args.seed, "prior", device=device, dtype=dtype,
                              log=log)
    else:
        C.train_score_net(model, imgs, sigmas, 32, args.steps, args.seed,
                          "prior", ckpt_path=prior_path + ".ckpt",
                          device=device, dtype=dtype, log=log)
        artifacts.save_prior(model, prior_path)
        C.remove(prior_path + ".ckpt", prior_path + ".ckpt.fp")

    seg_model = UNet(out_channels=2, features=(32, 64, 128), strides=(2, 2),
                     ndim=2)
    pert = None
    seg_ckpt = os.path.join(args.out, "seg.msgpack")
    if args.seg_perturb:
        sig_np = np.asarray(sigmas)
        pert = sig_np[sig_np <= args.seg_perturb_max_sigma]
        seg_ckpt = os.path.join(args.out, "seg_perturbed.msgpack")
    seg_model = train_seg_net(seg_model, imgs, masks, 16, args.seg_steps,
                              args.seed, ckpt_path=seg_ckpt,
                              perturb_sigmas=pert, device=device)

    def seg_predict(x):
        with torch.no_grad():
            x = torch.as_tensor(x).to(device)
            return seg_model(to_nchw(x)).argmax(dim=1).cpu().numpy()

    n_held = args.n_test + 1
    test_imgs, test_masks = make_dataset(n_held, S, args.seed + 777)
    clean_dice = dice(seg_predict(test_imgs), test_masks)
    log(f"seg net Dice on clean held-out slices: {clean_dice:.4f}")

    op_c = RandomUndersamplingFourier.create(
        args.R, args.center_frac, (S, S, 1), seed=args.seed, num_frames=1)
    pair_op = PairRandomUndersamplingFourier(mask=op_c.mask)
    log(f"mask keeps {int(op_c.mask.sum())}/{S} lines (R={args.R})")
    phase = C.phase_field(args.seed + 3, n_held, S)
    slices = []
    for idx in range(n_held):
        truth = torch.from_numpy(test_imgs[idx:idx + 1])
        yr, yi = pair_op(truth * torch.cos(phase[idx:idx + 1]),
                         truth * torch.sin(phase[idx:idx + 1]))
        slices.append(dict(truth=truth, yr=yr, yi=yi,
                           label=torch.from_numpy(test_masks[idx:idx + 1])))
    val_idx = args.n_test

    def eval_mag(mag, idx):
        t = slices[idx]["truth"][0]
        mag = C.to_cpu(mag)
        d = dice(seg_predict(mag[None])[0], slices[idx]["label"][0].numpy())
        return (float(nrmse(mag, t)), float(ssim(mag[..., 0], t[..., 0])), d)

    out_rows, mags, zf_rows = {}, {}, []
    for idx in range(args.n_test):
        r = slices[idx]
        zr, zi = pair_op.conj_op(r["yr"], r["yi"])
        zf_mag = C.mag(zr, zi)[0]
        zf_rows.append(eval_mag(zf_mag, idx))
        if idx == 0:
            mags["ZF"], mags["original"] = zf_mag.numpy(), test_imgs[0]
    out_rows["ZF"] = tuple(np.mean(zf_rows, axis=0))
    log(f"ZF (mean of {args.n_test} test slices): "
        f"NRMSE {out_rows['ZF'][0]:.4f} SSIM {out_rows['ZF'][1]:.4f} "
        f"Dice {out_rows['ZF'][2]:.4f}")

    cfg = ALDConfig(n_steps_each=args.n_steps_each, step_lr=args.step_lr)
    B = args.chains
    prox = PairL2Penalty.with_normal_kernel(pair_op, num_iters=6)

    def run(idx, lr_scaled, seg_lamda=None, key_off=0):
        kw = {}
        if seg_lamda is not None:
            kw = dict(seg_fn=seg_model,
                      seg_label=slices[idx]["label"].repeat(B, 1, 1),
                      seg_lamda=seg_lamda,
                      seg_start_time=args.seg_start_time,
                      seg_mode=args.seg_mode)
        recon = make_stepped_pair_reconstructor(
            model, sigmas, pair_op, prox, cfg, lr_scaled=lr_scaled,
            compute_dtype=dtype, device=device, **kw)
        xr, xi = recon(slices[idx]["yr"].repeat(B, 1, 1, 1),
                       slices[idx]["yi"].repeat(B, 1, 1, 1),
                       seed=args.seed + 100 + key_off)
        mag = C.mag(xr, xi).mean(dim=0)
        return mag, eval_mag(mag, idx)

    tuning = {"lr_scaled": [], "seg_lamda": []}
    best = None
    for i, lrs in enumerate(args.lr_scaled_grid):
        t0 = time.time()
        _, (n, s, d) = run(val_idx, lrs, key_off=i)
        log(f"val ALD lr_scaled={lrs:g}: NRMSE {n:.4f} SSIM {s:.4f} "
            f"Dice {d:.4f} ({time.time() - t0:.0f}s)")
        tuning["lr_scaled"].append(
            {"lr_scaled": lrs, "nrmse": round(n, 4), "ssim": round(s, 4),
             "dice": round(d, 4)})
        if best is None or n < best[0]:
            best = (n, lrs)
    lr_scaled = best[1]
    log(f"lr_scaled tuned to {lr_scaled:g}")

    best = None
    for i, lam in enumerate(args.seg_lamda_grid):
        t0 = time.time()
        _, (n, s, d) = run(val_idx, lr_scaled, seg_lamda=lam, key_off=50 + i)
        log(f"val ALD+seg lamda={lam:g}: NRMSE {n:.4f} SSIM {s:.4f} "
            f"Dice {d:.4f} ({time.time() - t0:.0f}s)")
        tuning["seg_lamda"].append(
            {"seg_lamda": lam, "nrmse": round(n, 4), "ssim": round(s, 4),
             "dice": round(d, 4)})
        if best is None or n < best[0]:
            best = (n, lam)
    seg_lamda = best[1]
    log(f"seg_lamda tuned to {seg_lamda:g}")

    per_slice = {"ALD": [], "ALD+seg": []}
    for idx in range(args.n_test):
        for name, lam in (("ALD", None), ("ALD+seg", seg_lamda)):
            mag, row = run(idx, lr_scaled, seg_lamda=lam,
                           key_off=1000 + idx)
            per_slice[name].append(row)
            if idx == 0:
                mags[name] = C.to_cpu(mag).numpy()
            log(f"test[{idx}] {name}: NRMSE {row[0]:.4f} SSIM {row[1]:.4f} "
                f"Dice {row[2]:.4f}")
    for name in ("ALD", "ALD+seg"):
        out_rows[name] = tuple(np.mean(per_slice[name], axis=0))
        log(f"test mean {name}: NRMSE {out_rows[name][0]:.4f} "
            f"SSIM {out_rows[name][1]:.4f} Dice {out_rows[name][2]:.4f}")

    figure(args, mags, out_rows, zf_rows, per_slice)
    rows = {k: {"nrmse": round(float(v[0]), 4),
                "ssim": round(float(v[1]), 4),
                "dice": round(float(v[2]), 4)} for k, v in out_rows.items()}
    payload = {"args": dict(vars(args)),
               "tuned": {"lr_scaled": lr_scaled, "seg_lamda": seg_lamda,
                         "clean_seg_dice": round(clean_dice, 4)},
               "tuning": tuning,
               "per_test_slice": {
                   k: [[round(float(x), 4) for x in row] for row in v]
                   for k, v in per_slice.items()},
               "results": rows}
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(payload, f, indent=2)
    with open(os.path.join(args.out, "metrics.txt"), "w") as f:
        for k, v in rows.items():
            f.write(f"{k}: NRMSE {v['nrmse']}, SSIM {v['ssim']}, "
                    f"Dice {v['dice']}\n")
    log(json.dumps(rows))
    return rows


def figure(args, mags, out_rows, zf_rows, per_slice):
    """comparison.png of slice 0 (matplotlib; skipped where missing)."""
    try:
        import matplotlib
    except ImportError:
        log("matplotlib missing: comparison.png not drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    names = ["original", "ZF", "ALD", "ALD+seg"]
    fig, axes = plt.subplots(1, len(names), figsize=(3 * len(names), 3.2))
    fig_rows = dict(out_rows)
    fig_rows["ZF"] = zf_rows[0]
    for name in ("ALD", "ALD+seg"):
        fig_rows[name] = per_slice[name][0]
    for ax, name in zip(axes, names):
        ax.imshow(np.squeeze(mags[name]), cmap="gray")
        title = name if name == "original" else (
            f"{name}\nNRMSE {fig_rows[name][0]:.3f} / "
            f"SSIM {fig_rows[name][1]:.3f} / Dice {fig_rows[name][2]:.3f}")
        ax.set_title(title, fontsize=9)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(os.path.join(args.out, "comparison.png"), dpi=130)
    plt.close(fig)


if __name__ == "__main__":
    main()

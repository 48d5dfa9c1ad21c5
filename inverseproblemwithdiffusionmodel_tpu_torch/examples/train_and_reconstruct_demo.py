"""Train a score prior, then reconstruct with it, on the port: the demo of
examples/train_and_reconstruct_demo.py, with its flags, defaults and
args.json keys.

Trains an NCSNv2 prior on synthetic cardiac phantoms (batches from the
native C++ batcher where it builds), then solves an R = 8 single-coil
undersampled-MRI problem with the pair-form ALD reconstructor: ZF
against the ensemble mean. On the card it reconstructs again with the
same weights in bf16 and in the int8 serving mode
(`make_score_fn(..., "int8")`: K5-K7). Writes original / ZF /
reconstructions .npy, args.json and the sample-grid figure.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
train_and_reconstruct_demo [--steps 1500] [--size 64] [--out runs/demo]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import _common as C
from ..models.ncsnv2 import NCSNv2
from ..operators.masks import random_cartesian_mask
from ..operators.pair import PairL2Penalty, PairRandomUndersamplingFourier
from ..samplers.ald import ALDConfig
from ..samplers.ald_pair import make_stepped_pair_reconstructor
from ..samplers.sigmas import sigma_ladder
from ..training import TrainState, get_optimizer, make_score_train_step
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device, synchronize
from ..utils.metrics import nrmse, ssim

make_dataset = C.make_dataset


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--levels", type=int, default=232)
    p.add_argument("--chains", type=int, default=8)
    p.add_argument("--R", type=int, default=8)
    p.add_argument("--n_train", type=int, default=400)
    p.add_argument("--lr_scaled", type=float, default=30000.0)
    p.add_argument("--out", default="runs/demo")
    p.add_argument("--seed", type=int, default=0)
    C.add_device_args(p)
    return p.parse_args(argv)


def batches(data, batch, seed):
    """The training batches: the native batcher where it builds, else a
    seeded numpy draw."""
    try:
        from ..data.native_loader import NativeBatchIterator, native_available
        if native_available():
            return NativeBatchIterator(data, batch, seed=seed).next
    except Exception:
        pass
    rng = np.random.RandomState(seed)
    return lambda: data[rng.choice(len(data), batch)]


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    data = make_dataset(args.n_train, args.size, args.seed)
    sigma_max = max_pairwise_distance(data, max_samples=256)
    sigmas = sigma_ladder(sigma_max, 0.01, args.levels)
    print(f"[demo] {data.shape} phantoms; sigma_max={sigma_max:.1f}",
          flush=True)

    config = C.ncsn_config(1, args.size, args.ngf)
    model = NCSNv2(config).to(device)
    state = TrainState.create(model, get_optimizer(C.adam_config(1e-4)),
                              ema_decay=0.999)
    step = make_score_train_step(model, sigmas, data_mode="real-imag")
    next_batch = batches(data, args.batch, args.seed)
    gen = torch.Generator(device).manual_seed(args.seed + 1)
    t0 = time.time()
    for i in range(args.steps):
        state, loss = step(state, next_batch(), gen)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(f"[demo] step {i}: loss {float(loss):.1f} "
                  f"({(time.time() - t0):.0f}s)", flush=True)
    C.load_params(model, state.eval_params)
    model.eval()

    test = make_dataset(4, args.size, args.seed + 777)
    truth = torch.from_numpy(test[:1])                    # (1, S, S, 1)
    mask = random_cartesian_mask(args.size, args.R, 1 / 16,
                                 seed=args.seed).reshape(1, 1, -1, 1)
    op = PairRandomUndersamplingFourier(
        mask=torch.as_tensor(mask, dtype=torch.float32))
    phase = C.phase_field(3, 1, args.size)
    xr_true = truth * torch.cos(phase)
    xi_true = truth * torch.sin(phase)
    yr, yi = op(xr_true, xi_true)
    zr, zi = op.conj_op(yr, yi)
    zf_mag = C.mag(zr, zi)

    yr_b = yr.repeat(args.chains, 1, 1, 1)
    yi_b = yi.repeat(args.chains, 1, 1, 1)
    cfg = ALDConfig(n_steps_each=5, step_lr=6.2e-6)

    def reconstruct(dtype):
        recon = make_stepped_pair_reconstructor(
            model, sigmas, op, PairL2Penalty.with_normal_kernel(
                op, num_iters=6), cfg, lr_scaled=args.lr_scaled,
            compute_dtype=dtype, device=device)
        t0 = time.time()
        xr, xi = recon(yr_b, yi_b, seed=9)
        mean_mag = C.mag(xr, xi).mean(dim=0)
        synchronize(device)
        return xr, xi, C.to_cpu(mean_mag), time.time() - t0

    xr, xi, mean_mag, wall = reconstruct(None)
    t_mag = truth[0].abs()
    extra = {}
    if device.type != "cpu":
        for tag, dtype in (("bf16", torch.bfloat16), ("int8", "int8")):
            _, _, mag_q, wall_q = reconstruct(dtype)
            extra.update({
                f"{tag}_nrmse": float(nrmse(mag_q, t_mag)),
                f"{tag}_ssim": float(ssim(mag_q[..., 0], t_mag[..., 0])),
                f"{tag}_wall_s": round(wall_q, 1)})
            print(f"[demo] {tag} recon: NRMSE {extra[f'{tag}_nrmse']:.4f} "
                  f"/ SSIM {extra[f'{tag}_ssim']:.4f} "
                  f"({extra[f'{tag}_wall_s']}s)", flush=True)

    m = {
        "zf_nrmse": float(nrmse(zf_mag[0], t_mag)),
        "zf_ssim": float(ssim(zf_mag[0, ..., 0], t_mag[..., 0])),
        "nrmse": float(nrmse(mean_mag, t_mag)),
        "ssim": float(ssim(mean_mag[..., 0], t_mag[..., 0])),
        "recon_wall_s": round(wall, 1),
        "ald_steps": args.levels * 5,
        "chains": args.chains,
        **extra,
    }
    print(f"[demo] R={args.R}: ZF NRMSE {m['zf_nrmse']:.4f} / "
          f"SSIM {m['zf_ssim']:.4f}  ->  recon NRMSE {m['nrmse']:.4f} / "
          f"SSIM {m['ssim']:.4f}  ({wall:.1f}s, {args.chains} chains)",
          flush=True)

    def host(a):
        return C.to_cpu(a).numpy()

    np.save(os.path.join(args.out, "original.npy"),
            host(xr_true) + 1j * host(xi_true))
    np.save(os.path.join(args.out, "reconstructions.npy"),
            host(xr) + 1j * host(xi))
    np.save(os.path.join(args.out, "ZF.npy"), host(zr) + 1j * host(zi))
    with open(os.path.join(args.out, "args.json"), "w") as f:
        json.dump({**vars(args), **m}, f, indent=2)
    try:
        from ..utils.visualizations import create_sample_grid_plot
        create_sample_grid_plot(args.out)
    except Exception as e:
        print(f"[demo] figure skipped: {e}")
    return m


if __name__ == "__main__":
    main()

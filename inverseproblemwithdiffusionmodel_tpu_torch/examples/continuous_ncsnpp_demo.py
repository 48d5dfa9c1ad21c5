"""The continuous stack end to end on the port: the experiment of
examples/continuous_ncsnpp_demo.py, with its flags, defaults and
results.json keys.

Trains a small NCSN++ under the VE SDE (a scaled-down
`ve/cifar10_ncsnpp_continuous` leaf, sigma_max from the data), or loads
the trained one (`--prior_path`, default <out>/ncsnpp.msgpack; the
repository's is artifacts/continuous_demo/ncsnpp.msgpack), then samples
it with the PC sampler (reverse diffusion + Langevin) and the
probability-flow ODE. NCSN++'s FIR resamplers run K1 / K2
(ops/fir_kernels.py) on the card.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
continuous_ncsnpp_demo --prior_path artifacts/continuous_demo/ncsnpp.msgpack \\
      --out runs/continuous_demo
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import _common as C
from ..configs_continuous import get_continuous_config, make_sde
from ..data.datasets import synthetic_digits
from ..models.ncsnpp import NCSNpp
from ..sde.sampling import get_ode_sampler, get_pc_sampler, get_score_fn
from ..training import (TrainState, get_optimizer,
                        make_continuous_score_train_step)
from ..utils import artifacts
from ..utils.dataset_stats import max_pairwise_distance
from ..utils.device import resolve_device, synchronize


def log(msg):
    print(f"[cont] {msg}", flush=True)


def make_data(kind: str, n: int, size: int, seed: int) -> np.ndarray:
    if kind == "digits":
        xs, _ = synthetic_digits(n, size, seed)
        return xs[..., None].astype(np.float32)
    return C.make_dataset(n, size, seed)


def save_grid(path: str, imgs: np.ndarray, title: str):
    """A grid of the samples (matplotlib; skipped where it is missing)."""
    try:
        import matplotlib
    except ImportError:
        log(f"matplotlib missing: {os.path.basename(path)} not drawn")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    n = imgs.shape[0]
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(1.6 * cols, 1.6 * rows),
                             squeeze=False)
    for i, ax in enumerate(axes.flat):
        if i < n:
            ax.imshow(np.squeeze(imgs[i]), cmap="gray")
        ax.set_axis_off()
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--leaf", default="ve/cifar10_ncsnpp_continuous")
    p.add_argument("--data", default="acdc", choices=["acdc", "digits"])
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--nf", type=int, default=32)
    p.add_argument("--num_res_blocks", type=int, default=2)
    p.add_argument("--n_train", type=int, default=400)
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--num_scales", type=int, default=500,
                   help="SDE discretization N for PC sampling")
    p.add_argument("--samples", type=int, default=16)
    p.add_argument("--scan_k", type=int, default=4,
                   help="train steps per chunk: the JAX script fuses them "
                        "into one compiled scan; here they run one after "
                        "another, and the chunk sets the logging and "
                        "averaging unit as there")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--retrain", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/continuous_demo")
    p.add_argument("--prior_path", default=None,
                   help="trained NCSN++ file (default <out>/ncsnpp.msgpack; "
                        "written there after training)")
    C.add_device_args(p)
    args = p.parse_args(argv)
    if args.quick:
        args.size, args.nf, args.n_train = 16, 16, 32
        args.steps, args.num_scales, args.samples = 30, 20, 4
        args.batch = 4
    return args


def build(args, data):
    """The scaled-down config, the SDE and the net (`sigma_max` from the
    data, Song & Ermon's technique 1)."""
    S = args.size
    sigma_max = float(max_pairwise_distance(data, max_samples=256))
    cfg = get_continuous_config(args.leaf).replace(**{
        "data.image_size": S, "data.num_channels": 1,
        "model.nf": args.nf, "model.num_res_blocks": args.num_res_blocks,
        "model.ch_mult": (1, 2, 2), "model.attn_resolutions": (16,),
        "model.num_scales": args.num_scales, "model.sigma_max": sigma_max,
        "training.batch_size": args.batch})
    return cfg, make_sde(cfg), NCSNpp(cfg), sigma_max


def train(args, model, sde, data, device, dtype):
    torch.manual_seed(args.seed)
    state = TrainState.create(model, get_optimizer(C.adam_config(2e-4)),
                              ema_decay=0.999)
    step = make_continuous_score_train_step(model, sde, compute_dtype=dtype)
    K = args.scan_k
    t0 = time.time()
    i = 0
    while i < args.steps:
        losses = []
        for j in range(K):
            batch = data[np.random.RandomState([args.seed, i + j]).choice(
                len(data), args.batch)]
            state, loss = step(state, batch,
                               C.step_generator(args.seed + 1, i + j, device))
            losses.append(loss)
        i += K
        if i % max(args.steps // 8, K) < K:
            mean_loss = float(torch.stack(losses).mean())
            log(f"step {i}: loss {mean_loss:.4f} ({time.time() - t0:.0f}s)")
    C.load_params(model, state.eval_params)
    log(f"trained {args.steps} steps in {time.time() - t0:.0f}s")
    return model


def sample(args, cfg, sde, model, device):
    """PC then ODE sampling, each timed on its second call (the first
    builds what it needs). Returns (results, x_pc, x_ode)."""
    S = args.size
    shape = (args.samples, S, S, 1)
    model.eval()
    score_fn = get_score_fn(sde, lambda x, c: model(x, c), continuous=True)
    pc = get_pc_sampler(sde, shape,
                        predictor=cfg.sampling.predictor.lower(),
                        corrector=cfg.sampling.corrector.lower(),
                        snr=cfg.sampling.snr,
                        n_steps=cfg.sampling.n_steps_each, device=device)
    results = {}
    with torch.no_grad():
        t0 = time.time()
        x_pc, _ = pc(score_fn, seed=args.seed + 7)
        synchronize(device)
        compile_and_run = time.time() - t0
        t0 = time.time()
        x_pc, _ = pc(score_fn, seed=args.seed + 8)
        synchronize(device)
        pc_wall = time.time() - t0
    nfe = args.num_scales * (cfg.sampling.n_steps_each + 1)
    results["pc"] = {
        "nfe": nfe, "wall_s": round(pc_wall, 2),
        "net_evals_per_sec": round(nfe * args.samples / pc_wall, 1),
        "compile_plus_first_run_s": round(compile_and_run, 1)}
    log(f"PC: {nfe} NFE x {args.samples} samples in {pc_wall:.1f}s "
        f"({results['pc']['net_evals_per_sec']} evals/s)")

    ode = get_ode_sampler(sde, shape, denoise=True, device=device)
    stats = {}
    with torch.no_grad():
        x_ode, _ = ode(score_fn, seed=args.seed + 9)
        synchronize(device)
        t0 = time.time()
        x_ode, _ = ode(score_fn, seed=args.seed + 10, stats=stats)
        synchronize(device)
        ode_wall = time.time() - t0
    results["ode"] = {"wall_s": round(ode_wall, 2)}
    log(f"ODE: {args.samples} samples in {ode_wall:.1f}s "
        f"({stats.get('nfe')} evaluations)")
    return results, x_pc, x_ode


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    data = make_data(args.data, args.n_train, args.size, args.seed)
    cfg, sde, model, sigma_max = build(args, data)
    log(f"{cfg.model.name} nf{args.nf} at {args.size}^2, {cfg.training.sde} "
        f"sigma_max {sigma_max:.1f}, N={args.num_scales}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{n_params / 1e6:.2f} M params")

    ckpt = args.prior_path or os.path.join(args.out, "ncsnpp.msgpack")
    if not args.retrain and os.path.exists(ckpt):
        log("loading trained NCSN++")
        C.load_prior(model, ckpt, log, "NCSN++")
        model.to(device)
    else:
        model.to(device)
        train(args, model, sde, data, device,
              C.compute_dtype(device))
        artifacts.save_prior(model, ckpt)

    results, x_pc, x_ode = sample(args, cfg, sde, model, device)
    save_grid(os.path.join(args.out, "pc_samples.png"), C.to_cpu(x_pc).numpy(),
              f"PC ({cfg.sampling.predictor}+{cfg.sampling.corrector}), "
              f"N={args.num_scales}, trained {args.steps} steps")
    save_grid(os.path.join(args.out, "ode_samples.png"),
              C.to_cpu(x_ode).numpy(),
              f"probability-flow ODE, trained {args.steps} steps")
    results["config"] = {"leaf": args.leaf, "size": args.size, "nf": args.nf,
                         "steps": args.steps, "sigma_max": sigma_max,
                         "data": args.data, "backend": device.type,
                         "n_params_M": round(n_params / 1e6, 2)}
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    log(json.dumps(results))
    return results


if __name__ == "__main__":
    main()

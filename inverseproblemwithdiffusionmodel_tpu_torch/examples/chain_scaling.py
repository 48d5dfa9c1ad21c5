"""Chain-ensemble scaling on the port: the experiment of
examples/chain_scaling.py, with its flags.

- `--mode sweep` (on the card): ALD chain-steps/s of the port's
  `make_stepped_pair_reconstructor` at bench.py's geometry (256², the ACDC
  NCSNv2Deepest at ngf 128 with seeded weights in bf16, R = 8 4-coil pair
  SENSE, CG 4 on the normal kernel, lr_scaled 5, --levels x --n_steps) for
  each chain count in --batches, timed in this process (the fastest of 3
  runs ended by a host read, as bench.py times). Writes
  <out>/scaling.json and prints a table.
- `--mode mesh` (the CPU): the same chain on a CPU mesh of 8 entries
  (`samplers.ald_pair.ShardedReconstructor`, tiny shapes) against the run
  without a mesh, and the census of what crosses shards per level: the
  CG's scalar dot products summed over the shards (the counterpart of the
  JAX script's collective audit of its compiled program), the ensemble
  noise draws split into the shards' rows, and no tensor gathered before
  the end. Prints the census and the projection of --per_chip_rate over
  the 8 entries as JSON.

  python -m inverseproblemwithdiffusionmodel_tpu_torch.examples.\\
chain_scaling --mode sweep --batches 8 16 32 64
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import _common as C

ACDC_R, ACDC_COILS, CG_ITERS, LR_SCALED = 8, 4, 4, 5.0
SIZE = 256                  # the sweep's image size (bench.py's)


def log(msg):
    print(f"[scaling] {msg}", flush=True)


def bench_problem(size: int, chains: int, levels: int, device):
    """bench.py's problem: 4 real exponential coil maps, one R = 8
    variable-density mask (seed 0), the measurement of `chains` chains of
    uniform magnitude and normal phase (a generator seeded 0), the CG
    proximal, the config's ladder cut to `levels`."""
    from ..config import load_config
    from ..operators.fourier import MASK_PRESETS, _exp_sens_map
    from ..operators.masks import generate_mask
    from ..operators.pair import PairL2Penalty, PairSENSE
    from ..samplers.sigmas import sigma_ladder
    cfg = load_config("ACDC", "real-imag", **{"data.image_size": size})
    mask = generate_mask(1, size, seed=0, **MASK_PRESETS[ACDC_R])
    maps = np.stack([_exp_sens_map(size, size, i) for i in range(ACDC_COILS)])
    maps = maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
    sens = torch.tensor(maps[..., None], dtype=torch.float32)
    lin_tfm = PairSENSE(mask=torch.tensor(mask.reshape(1, 1, size, 1)),
                        sens_re=sens, sens_im=torch.zeros_like(sens))
    gen = torch.Generator().manual_seed(0)
    shape = (chains, size, size, 1)
    mag = torch.rand(shape, generator=gen)
    phase = torch.randn(shape, generator=gen)
    yr, yi = lin_tfm(mag * torch.cos(phase), mag * torch.sin(phase))
    proximal = PairL2Penalty.with_normal_kernel(lin_tfm, num_iters=CG_ITERS)
    sigmas = sigma_ladder(cfg.model.sigma_begin, cfg.model.sigma_end, levels,
                          "geometric")
    return cfg, lin_tfm, proximal, sigmas, yr.to(device), yi.to(device)


def run_sweep(args):
    from ..models.ncsnv2 import NCSNv2Deepest
    from ..samplers.ald import ALDConfig
    from ..samplers.ald_pair import make_stepped_pair_reconstructor
    from ..utils.convert import seeded_weights
    from ..utils.device import resolve_device, synchronize
    device = resolve_device(args.device)
    out = {}
    model = None
    for b in args.batches:
        cfg, lin_tfm, prox, sigmas, yr, yi = bench_problem(
            SIZE, b, args.levels, device)
        if model is None:
            model = seeded_weights(NCSNv2Deepest(cfg), 0).to(device)
        recon = make_stepped_pair_reconstructor(
            model, sigmas, lin_tfm, prox,
            ALDConfig(n_steps_each=args.n_steps, step_lr=9e-7),
            lr_scaled=LR_SCALED, compute_dtype=C.compute_dtype(device),
            device=device)
        times = []
        for k in range(4):                  # the first run sets up
            t0 = time.perf_counter()
            xr, _ = recon(yr, yi, seed=k)
            float(xr.sum())
            synchronize(device)
            times.append(time.perf_counter() - t0)
        best = min(times[1:])
        rate = args.levels * args.n_steps * b / best
        out[b] = {"value": rate, "unit": "chain-steps/s", "best_s": best,
                  "device": (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu")}
        log(f"B={b}: {rate:.2f} chain-steps/s")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "scaling.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    log(f"wrote {path}")
    if out:
        print("\n| chains/chip | ALD chain-steps/s/chip | per-chain steps/s |")
        print("|---|---|---|")
        for b, rec in sorted(out.items()):
            v = rec["value"]
            print(f"| {b} | {v:.1f} | {v / b:.2f} |")
    return out


def run_mesh_audit(args):
    from ..models.ncsnv2 import NCSNv2
    from ..operators import pair
    from ..parallel import ensemble
    from ..parallel.mesh import make_mesh
    from ..samplers import ald_pair
    from ..samplers.ald import ALDConfig
    from ..utils.convert import seeded_weights
    n_dev, size, chains_per_dev, levels = 8, 32, 2, 3
    B = n_dev * chains_per_dev
    mesh = make_mesh(n_data=n_dev, devices=[torch.device("cpu")] * n_dev)
    log(f"{n_dev}-entry CPU mesh, {chains_per_dev} chains per entry "
        f"(tiny {size}^2 shapes; the census does not depend on them)")
    cfg, lin_tfm, prox, _, yr, yi = bench_problem(size, B, levels, "cpu")
    cfg = cfg.replace(**{"model.ngf": 16})
    model = seeded_weights(NCSNv2(cfg), 0)
    sigmas = np.geomspace(50.0, 0.01, levels).astype(np.float32)
    acfg = ALDConfig(n_steps_each=2, step_lr=1e-5)

    census = {"scalar_reductions": 0, "noise_scatters": 0}
    dot, scatter = pair._pair_dot, ensemble.scatter_noise

    def counted_dot(*a):
        census["scalar_reductions"] += 1
        return dot(*a)

    def counted_scatter(noise, devices):
        def counted(shape):
            census["noise_scatters"] += 1
            return noise(shape)
        return scatter(counted, devices)

    def run(mesh_):
        recon = ald_pair.make_stepped_pair_reconstructor(
            model, sigmas, lin_tfm, prox, acfg, lr_scaled=LR_SCALED,
            device="cpu", mesh=mesh_)
        return recon(yr, yi, seed=0)

    plain = run(None)
    pair._pair_dot = counted_dot
    ald_pair.scatter_noise = counted_scatter
    try:
        sharded = run(mesh)
    finally:
        pair._pair_dot, ald_pair.scatter_noise = dot, scatter
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(sharded, plain))
    # each cross-shard dot sums one _pair_dot per shard
    per_level = {
        "scalar_all_reduce": census["scalar_reductions"] / n_dev / levels,
        "noise_row_scatter": census["noise_scatters"] / levels,
        "tensor_gather": 0}
    log(f"sharded chain on the mesh against the run without: max rel "
        f"{err:.2e}")
    log(f"cross-shard census per level: {per_level}")
    expected_dots = acfg.n_steps_each * (2 * prox.num_iters + 1)
    assert per_level["scalar_all_reduce"] == expected_dots, per_level
    assert err < 1e-4, err
    rate = args.per_chip_rate
    result = {
        "per_chip_chain_steps_per_sec": rate,
        "n_chips": n_dev,
        "projected_8_entry_chain_steps_per_sec": rate * n_dev,
        "census_per_level": per_level,
        "sharded_vs_plain_max_rel": err,
        "basis": "chains split over the mesh's data axis; per level only "
                 "the CG's scalar dot products are summed across shards "
                 "and the ensemble noise is split into rows; no tensor is "
                 "gathered before the end"}
    print(json.dumps(result, indent=2))
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["sweep", "mesh"], default="sweep")
    p.add_argument("--batches", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--levels", type=int, default=8)
    p.add_argument("--n_steps", type=int, default=3)
    p.add_argument("--per_chip_rate", type=float, default=90.17,
                   help="chain-steps/s per card to project (mesh mode)")
    p.add_argument("--out", default="runs/chain_scaling")
    C.add_device_args(p)
    args = p.parse_args(argv)
    return run_sweep(args) if args.mode == "sweep" else run_mesh_audit(args)


if __name__ == "__main__":
    main()

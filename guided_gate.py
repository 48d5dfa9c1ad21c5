#!/usr/bin/env python3
"""Repeat the smoke's `guided` one-level check of `inverse_clf_proximal`
(chip_smoke.guided_level_run: MNIST's NCSNv2Deepest and ResNetClf at full
width, weights from seed 0, 2 chains, level 8 of the 20-level ladder, the
same injected noise, the float32 mode) on one NVIDIA GPU, and measure the
run-to-run spread of its parts:

  python3 guided_gate.py [--procs 5] [--reps 4] [--out file.json]

The CPU reference is computed once. Then `--procs` fresh processes each run
the check `--reps` times on the card in each cuDNN setting (so that each
process picks its own cuDNN algorithms, as each smoke does):

- `benchmark`: `utils/precision.float32_exact` as the smoke used it (TF32
  off, cuDNN benchmark on, any algorithm);
- `deterministic`: the same with `torch.backends.cudnn.deterministic` on,
  which restricts cuDNN (benchmark included) to deterministic algorithms.

Beside each run's rel L2 to the CPU it reads, on fixed inputs (the
sampler's first inner step: A^H y of the check's measurement), the
classifier's input gradient (`compute_clf_grad`, through cuDNN's
backward), the score net's output, and `L2Penalty`'s CG solve stopped
after each of its 8 iterations: each against the CPU, and each against
the process's first run in that setting (the run-to-run spread). Prints
one line per setting and, with --out, writes every number as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (its helpers; main() runs only as a script)

NAME = "inverse_clf_proximal"
SETTINGS = ("benchmark", "deterministic")


def problem(device):
    """The check's nets, ladder, start and the probes' fixed inputs."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        get_sigmas)
    cfg = load_config("MNIST")
    model, _ = registry.load_model(cfg, "Diffusion", seed=0)
    clf, _ = registry.load_model(cfg, "Clf", seed=0)
    model.eval()
    clf.eval().requires_grad_(False)
    sigmas = get_sigmas(cfg.replace(
        **{"model.num_classes": chip_smoke.GUIDED_LEVELS}))
    config = ALDConfig(n_steps_each=cfg.sampling.n_steps_each,
                       step_lr=cfg.sampling.step_lr)
    check = chip_smoke.guided_check(sigmas, config)
    gen = torch.Generator().manual_seed(15)
    x0 = torch.rand(chip_smoke.GUIDED_CHECK_CHAINS, 32, 32, 1, generator=gen)
    return dict(model=model, clf=clf, check=check, x0=x0,
                alpha=config.step_lr * 5.0)


def probes(p: dict, dev) -> dict:
    """The check's parts on fixed inputs on `dev`, float32 mode: the
    classifier gradient and the score at the sampler's first inner step
    (x = A^H y), and the proximal's CG after 0..8 iterations on z = A^H y
    plus a fixed perturbation."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models import registry
    from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
        L2Penalty)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        compute_clf_grad)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
        stack_parts)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    model, clf = p["model"].to(dev), p["clf"].to(dev)
    prob = chip_smoke.guided_problem(p["x0"].shape[0], dev)
    op, y = prob["op"], prob["y"]
    x = op.conj_op(y)
    stacked = stack_parts(x.real, x.imag)
    cls2 = stack_parts(prob["cls"], prob["cls"])
    gen = torch.Generator().manual_seed(17)
    z = x + torch.complex(*(0.1 * torch.randn(2, *x.shape, generator=gen))
                          ).to(dev)
    out = {}
    with float32_exact(), torch.no_grad():
        out["clf_grad"] = compute_clf_grad(registry.make_clf_fn(clf),
                                           stacked, cls2).cpu()
        labels = torch.zeros(stacked.shape[0], dtype=torch.long, device=dev)
        out["score"] = registry.make_score_fn(
            model, p["check"]["level"])(stacked, labels).cpu()
        for k in range(9):
            sol = L2Penalty(lin_tfm=op, num_iters=k)(z, y, p["alpha"], 1.0)
            out[f"cg{k}"] = torch.view_as_real(sol).cpu()
    return out


def setting(name: str):
    if name == "deterministic":
        return chip_smoke.cudnn_deterministic()
    return contextlib.nullcontext()


def child(ref_path: str, reps: int) -> dict:
    ref = torch.load(ref_path, weights_only=True)
    p = problem("cuda")
    out = {}
    for name in SETTINGS:
        rows, first = [], None
        for _ in range(reps):
            with setting(name):
                t0 = time.perf_counter()
                run = chip_smoke.guided_level_run(
                    NAME, p["model"], p["clf"], p["check"], p["x0"], "cuda",
                    deterministic=name == "deterministic")
                seconds = time.perf_counter() - t0
                parts = probes(p, "cuda")
            parts["check"] = run
            first = first or parts
            rows.append(dict(seconds=seconds, **{
                f"{key}_vs_cpu": chip_smoke.rel_l2(value, ref[key])
                for key, value in parts.items()}, **{
                f"{key}_vs_first": chip_smoke.rel_l2(value, first[key])
                for key, value in parts.items()}))
        out[name] = rows
    return out


def summary(rows: list, gate: float) -> dict:
    keys = rows[0].keys()
    s = {key: [min(r[key] for r in rows), max(r[key] for r in rows)]
         for key in keys if key != "seconds"}
    s["runs"] = len(rows)
    s["check_under_gate"] = sum(r["check_vs_cpu"] <= gate for r in rows)
    return s


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=5)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.reps)), flush=True)
        return
    if not torch.cuda.is_available():
        sys.exit("guided_gate.py: no CUDA device")
    smi = chip_smoke.nvidia_smi()
    t0 = time.perf_counter()
    p = problem("cpu")
    ref = probes(p, "cpu")
    ref["check"] = chip_smoke.guided_level_run(NAME, p["model"], p["clf"],
                                               p["check"], p["x0"], "cpu")
    again = chip_smoke.guided_level_run(NAME, p["model"], p["clf"],
                                        p["check"], p["x0"], "cpu")
    cpu_repeat = chip_smoke.rel_l2(again, ref["check"])
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save(ref, ref_path)
        for _ in range(args.procs):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 ref_path, "--reps", str(args.reps)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                sys.exit(f"child failed:\n{proc.stdout}\n{proc.stderr}")
            results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    gate = chip_smoke.MODEL_REL_L2
    out = dict(nvidia_smi=smi, sampler=NAME, gate=gate,
               cpu_repeat_rel_l2=cpu_repeat,
               sigma=float(p["check"]["level"][0]),
               step=p["check"]["config"].step_lr, alpha=p["alpha"],
               seconds=time.perf_counter() - t0, runs=results)
    for name in SETTINGS:
        rows = [r for proc in results for r in proc[name]]
        out[name] = summary(rows, gate)
        s = out[name]
        print(f"[guided_gate] {name}: {s['check_under_gate']} of "
              f"{s['runs']} runs <= {gate}; check vs CPU "
              f"{s['check_vs_cpu']}, vs the process's first run "
              f"{s['check_vs_first']}; classifier gradient vs CPU "
              f"{s['clf_grad_vs_cpu']}, run to run "
              f"{s['clf_grad_vs_first']}; score vs CPU {s['score_vs_cpu']}, "
              f"run to run {s['score_vs_first']}; CG after 1, 2, 8 "
              f"iterations vs CPU {s['cg1_vs_cpu']} {s['cg2_vs_cpu']} "
              f"{s['cg8_vs_cpu']}, run to run {s['cg8_vs_first']} ({smi})",
              flush=True)
    print(f"[guided_gate] CPU run twice: rel L2 {cpu_repeat}; "
          f"{out['seconds']:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time two builds of the FIR kernels (K1 `fir_up2x_<dtype>`, K2
`fir_down2x_<dtype>`) against each other on one NVIDIA GPU:

  python3 fir_ab.py --baseline path/to/other/fir2x.cu [--dtype bf16] \
      [--baseline_py path/to/other/fir_kernels.py] [--out file.json]

--dtype picks the kernels' form, float32 (`f32`, the default) or bf16
(`bf16`; the baseline source must have the bf16 launchers too).

Builds the given fir2x.cu, with the checkout's other ops/csrc sources, into
a second library beside the checkout's own (ops/_build.py, one nvcc per
source, then a link). Then, at every FIR call of one FFHQ-256 NCSN++
forward at batch 2 and at batch 8 and at every K3 backward call of one
training step at batch 8 (chip_smoke.py's shape lists), it holds both
libraries' outputs against the plain PyTorch version (1e-5 of the largest
value in float32, one bf16 ulp of it in bf16) and times each launch
device-only (chip_smoke.graph_ms: 20 launches captured in a CUDA graph, the
replay timed by CUDA events), in turns baseline, checkout, checkout,
baseline, so that both see the same card, clocks and neighbours. Prints
each shape, the sums per group with their byte bound, and the card's name
and power limit; with --out, writes every row there as JSON.

With --baseline_py, another version of ops/fir_kernels.py (loaded as a
module of the checkout's package, so it launches the checkout's library)
is held against the checkout's for the host's µs per launch at the
smallest shape of each kernel: through the wrapper that launches it and
through the public op, 2,000 calls per timing, in the same turns.
"""
from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (its helpers; main() runs only as a script)


def launcher(lib, name: str, dtype: str = "f32"):
    """A call of one library's C launcher on torch's current stream."""
    fn = getattr(lib, f"fir_{name}_{dtype}")

    def run(x: torch.Tensor, out: torch.Tensor, taps) -> torch.Tensor:
        N, H, W, C = x.shape
        t = [float(v) for v in taps]
        rc = fn(x.data_ptr(), out.data_ptr(), N, H, W, C, *t, *t,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")
        return out
    return run


def cases(cfg):
    """(group, kernel, C, R of the input, batch, taps) for every call."""
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import fir_kernels
    k = tuple(cfg.model.fir_kernel)
    up_taps = fir_kernels._sep_kernel_1d(k, 2.0)
    dn_taps = fir_kernels._sep_kernel_1d(k, 1.0)
    for batch in (chip_smoke.BATCH, chip_smoke.TRAIN_BATCH):
        for name, C, R in chip_smoke.fir_shapes(cfg):
            yield (f"{name} fwd b{batch}", name, C, R, batch,
                   up_taps if name == "up2x" else dn_taps)
    batch = chip_smoke.TRAIN_BATCH
    for tag, C, R in chip_smoke.bwd_shapes(cfg):
        if tag == "down2x.bwd":     # K2 on the gradient of an up pass
            yield (f"{tag} b{batch}", "down2x", C, 2 * R, batch,
                   up_taps[::-1].copy())
        else:                       # K1 on the gradient of a down pass
            yield (f"{tag} b{batch}", "up2x", C, R // 2, batch,
                   dn_taps[::-1].copy())


def host_ab(baseline_py: str, cfg) -> dict:
    """Host µs per launch, baseline fir_kernels.py against the checkout's,
    at each kernel's smallest shape of a forward (batch 2)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import fir_kernels
    spec = importlib.util.spec_from_file_location(
        "inverseproblemwithdiffusionmodel_tpu_torch.ops._baseline_fir",
        baseline_py)
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    k = tuple(cfg.model.fir_kernel)
    shapes = chip_smoke.fir_shapes(cfg)
    out = {}
    for name in ("up2x", "down2x"):
        fns = {}
        for label, mod in (("baseline", base), ("checkout", fir_kernels)):
            C, R, fns[label] = chip_smoke.launch_paths(mod, k, shapes, name)
        row = dict(C=C, R=R)
        for path in ("wrapper", "public"):
            runs = {"baseline": [], "checkout": []}
            for _ in range(3):
                for label in ("baseline", "checkout", "checkout",
                              "baseline"):
                    runs[label].append(chip_smoke.host_us(fns[label][path],
                                                          reps=2000))
            row[path] = {label: statistics.median(v)
                         for label, v in runs.items()}
            row[path]["runs"] = runs
        out[name] = row
        print(f"[host] {name} (C={C}, R={R}, batch {chip_smoke.BATCH}): "
              f"host us per launch, median of 6: wrapper baseline "
              f"{row['wrapper']['baseline']:.2f} checkout "
              f"{row['wrapper']['checkout']:.2f}; public op baseline "
              f"{row['public']['baseline']:.2f} checkout "
              f"{row['public']['checkout']:.2f}", flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--baseline", required=True,
                   help="the fir2x.cu to hold the checkout's against")
    p.add_argument("--baseline_py", default=None,
                   help="a fir_kernels.py to hold the checkout's launch "
                        "path against, on the host")
    p.add_argument("--out", default=None,
                   help="where to write every row as JSON")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="the kernels' form: float32 or bf16")
    args = p.parse_args(argv)
    torch_dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    elem_bytes = torch_dtype.itemsize
    if not torch.cuda.is_available():
        raise SystemExit("fir_ab: torch sees no CUDA device")
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        get_continuous_config)
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import (
        _build, fir_kernels)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)

    others = [s for s in glob.glob(os.path.join(_build._CSRC, "*.cu"))
              if os.path.basename(s) != "fir2x.cu"]
    # an older baseline may lack the other dtype's launchers
    base_build = _build.build(
        tuple(sorted([os.path.abspath(args.baseline)] + others)),
        launchers=(f"fir_up2x_{args.dtype}", f"fir_down2x_{args.dtype}"))
    new_build = _build.build()
    for label, b in (("baseline", base_build), ("checkout", new_build)):
        print(f"[build] {label}: nvcc {b.seconds:.2f} s -> {b.path}")
        for line in b.log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"    {line.strip()}")
    libs = {label: b.lib for label, b in (("baseline", base_build),
                                          ("checkout", new_build))}
    cfg = get_continuous_config(chip_smoke.CONFIG)
    gen = torch.Generator().manual_seed(0)
    rows = []
    with float32_exact():
        for group, name, C, R, batch, taps in cases(cfg):
            x = torch.randn(batch, R, R, C, generator=gen).cuda().to(
                torch_dtype)
            up = name == "up2x"
            R_out = 2 * R if up else R // 2
            ref = (fir_kernels.upsample2x_plain if up else
                   fir_kernels.downsample2x_plain)(x, taps)
            tol = (chip_smoke.bf16_ulp(ref) if args.dtype == "bf16" else
                   chip_smoke.KERNEL_RTOL * ref.abs().max().item())
            fns, errs = {}, {}
            for label, lib in libs.items():
                out = torch.empty(batch, R_out, R_out, C, device="cuda",
                                  dtype=torch_dtype)
                run = launcher(lib, name, args.dtype)
                run(x, out, taps)
                torch.cuda.synchronize()
                errs[label] = (out.float() - ref.float()).abs().max().item()
                if not errs[label] <= tol:
                    raise AssertionError(f"{label} {group} C={C} R={R}: "
                                         f"max_abs_err {errs[label]}")
                fns[label] = (lambda run=run, out=out: run(x, out, taps))
            times = {label: [] for label in libs}
            for label in ("baseline", "checkout", "checkout", "baseline"):
                times[label].append(chip_smoke.graph_ms(fns[label]))
            b = chip_smoke.bound(elem_bytes * (x.numel() + ref.numel()),
                                 ref.numel() * (12 if up else 40))
            row = dict(group=group, C=C, R=R, B=batch, bound_ms=b["bound_ms"],
                       baseline_ms=sum(times["baseline"]) / 2,
                       checkout_ms=sum(times["checkout"]) / 2, runs=times,
                       err=errs)
            rows.append(row)
            print(f"    {group} C={C} R={R}: baseline "
                  f"{1e3 * row['baseline_ms']:.2f} us "
                  f"({', '.join(f'{1e3 * v:.2f}' for v in times['baseline'])})"
                  f", checkout {1e3 * row['checkout_ms']:.2f} us "
                  f"({', '.join(f'{1e3 * v:.2f}' for v in times['checkout'])})"
                  f", bound {1e3 * b['bound_ms']:.2f} us", flush=True)
            del x, ref
    groups = {}
    for r in rows:
        g = groups.setdefault(r["group"], dict(n=0, baseline_ms=0.0,
                                               checkout_ms=0.0, bound_ms=0.0,
                                               slower=0))
        g["n"] += 1
        for key in ("baseline_ms", "checkout_ms", "bound_ms"):
            g[key] += r[key]
        g["slower"] += r["checkout_ms"] > r["baseline_ms"]
    for name, g in groups.items():
        print(f"[sum] {name}, {g['n']} calls: baseline {g['baseline_ms']:.4f}"
              f" ms, checkout {g['checkout_ms']:.4f} ms, bound "
              f"{g['bound_ms']:.4f} ms; checkout slower at {g['slower']} of "
              f"{g['n']} shapes", flush=True)
    host = host_ab(args.baseline_py, cfg) if args.baseline_py else None
    smi = chip_smoke.nvidia_smi()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, dtype=args.dtype, groups=groups,
                           rows=rows, host=host), f, indent=1)
    print(smi)
    print(json.dumps(dict(groups=groups)))


if __name__ == "__main__":
    main()

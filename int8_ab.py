#!/usr/bin/env python3
"""Time two builds of the int8 kernels K5 (`absmax`), K6 (`quantize_s8`)
and K7 (`conv_s8s8s32`) against each other on one NVIDIA GPU:

  mkdir -p _chip_tmp/base
  git archive <commit> | tar -x -C _chip_tmp/base
  python3 int8_ab.py --baseline _chip_tmp/base [--rounds 2] [--retime 6] \\
      [--engines] [--out file.json]

The baseline is another checkout of this repository. Its own
ops/int8_kernels.py (with the ops/_build.py it imports) is loaded beside
the checkout's, as a package of its own, and builds its own ops/csrc
sources into its own _build directory. Each build is called through its
own Python wrappers (absmax(x), quantize_s8(x, amax, Cp),
conv_s8s8s32(codes, scale, kernel, sw, geometry, dtype, with_sums)), so
any two builds whose wrappers take those arguments compare, whatever their
C launchers take.

At every convolution geometry of one int8 NCSNv2Deepest forward at batch
32 (ACDC, 256 px, ngf 128, seeded weights in bf16) and of one int8 NCSN1D
forward at 2,048 tubes (CINE127_1D, ngf 128), found by
chip_smoke.int8_sites on the real inputs, both builds' amax, scale, codes,
int32 sums and dequantized output are held against the plain versions bit
for bit. Each K5, K6 and K7 call is then timed device-only
(chip_smoke.graph_ms: calls captured in a CUDA graph, the replay timed by
CUDA events) in turns baseline, checkout, checkout, baseline, `--rounds`
times over, so that both see the same card, clocks and neighbours;
torch.linalg.vector_norm(x, inf) beside K5 as the library call. A kernel
and geometry where the checkout reads more than 3 % slower is timed again,
`--retime` rounds of the turns with 20 calls replayed 10 times, and every
run is printed.

Prints each geometry, the sums per forward (each geometry times its
calls) beside the bound (K5: one read of x; K6: x read and its codes over
the true channels written; K7: 2 M O K operations at the int8 tensor
cores' dense rate, or its bytes if more), K5 alone at the smallest, the
median and a tiny (4,096-element) input, where the fixed cost per call
shows, and the int8 forward at batch 32 with each build's kernels, in
turns. It also times the checkout's library built in ops/_build.py's form
(one nvcc -c per source, all started together, then a link) against one
nvcc call over the same sources. With --engines, also the int8 ACDC and
cine serving engines (chip_smoke's serve and cine geometry) with each
build's kernels, one in-process request a turn, chain-steps/s. The card's
name and power limit close the output; --out writes every row as JSON.
"""
from __future__ import annotations

import argparse
import copy
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (its helpers; main() runs only as a script)

TURNS = ("baseline", "checkout", "checkout", "baseline")
LABELS = TURNS[:2]
SLOWER = 1.03       # checkout / baseline above this is timed again
TINY = 4096
KERNELS = ("k5", "k6", "k7")
BASELINE_PACKAGE = "int8_ab_baseline_ops"


def load_baseline(root: str):
    """The baseline checkout's ops/int8_kernels.py, imported as
    BASELINE_PACKAGE.int8_kernels: its `from . import _build` takes the
    baseline's _build.py, which builds the baseline's csrc."""
    ops = os.path.join(os.path.abspath(root),
                       "inverseproblemwithdiffusionmodel_tpu_torch", "ops")
    if not os.path.isfile(os.path.join(ops, "int8_kernels.py")):
        raise SystemExit(f"int8_ab: no ops/int8_kernels.py under {root}")
    package = types.ModuleType(BASELINE_PACKAGE)
    package.__path__ = [ops]
    sys.modules[BASELINE_PACKAGE] = package
    return importlib.import_module(f"{BASELINE_PACKAGE}.int8_kernels")


def one_call_build_seconds() -> float:
    """Wall seconds of one nvcc call over the checkout's sources into a
    shared library, with ops/_build.py's flags: the form of the build
    before it started one nvcc -c per source together."""
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import _build
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
               os.path.join(tmp, "lib.so"), *_build._sources()]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"int8_ab: one-call nvcc failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    return seconds


class use_build:
    """Within the block, the checkout's ops.int8_kernels calls `other`'s
    K5, K6 and K7 wrappers (the int8 layers look them up at each call)."""
    NAMES = ("absmax", "quantize_s8", "conv_s8s8s32")

    def __init__(self, ik, other):
        self.ik, self.other = ik, other

    def __enter__(self):
        self.saved = [getattr(self.ik, n) for n in self.NAMES]
        for n in self.NAMES:
            setattr(self.ik, n, getattr(self.other, n))

    def __exit__(self, *exc):
        for n, fn in zip(self.NAMES, self.saved):
            setattr(self.ik, n, fn)


def in_turns(fn, rounds: int) -> dict:
    """fn(label) in TURNS, `rounds` times over: every run, each label's
    mean, and checkout / baseline."""
    runs = {label: [] for label in LABELS}
    for _ in range(rounds):
        for label in TURNS:
            runs[label].append(fn(label))
    out = dict(runs=runs, **{f"{label}_ms": statistics.mean(r)
                             for label, r in runs.items()})
    out["ratio"] = out["checkout_ms"] / out["baseline_ms"]
    return out


def geometry_row(builds, ik, quant, site, rounds) -> dict:
    m, x = site["conv"], site["x"]
    qw = m.quant
    g = quant.geometry(x, qw, m.padding, m.dilation, m.ndim, m.pre_pad)
    amax_p = ik.absmax_plain(x)
    codes_p, sx_p = ik.quantize_s8_plain(x, amax_p, g.Cp)
    codes_p = codes_p.reshape(g.N, g.H, g.W, g.Cp)
    out_p, sums_p = ik.conv_s8s8s32_plain(codes_p, sx_p, qw.kernel, qw.scale,
                                          g, x.dtype, with_sums=True)
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    differ = {}
    for label, b in builds.items():
        amax = b.absmax(x)
        codes, sx = b.quantize_s8(x, amax, g.Cp)
        out, sums = b.conv_s8s8s32(codes.reshape(codes_p.shape), sx,
                                   qw.kernel, qw.scale, g, x.dtype,
                                   with_sums=True)
        torch.cuda.synchronize()
        differ[label] = dict(
            amax=int((amax != amax_p).sum()), scale=int((sx != sx_p).sum()),
            codes=int((codes.reshape(codes_p.shape) != codes_p).sum()),
            sums=int((sums != sums_p).sum()),
            out=int((out.view(bits) != out_p.view(bits)).sum()))
    if any(v for d in differ.values() for v in d.values()):
        raise AssertionError(f"int8_ab: {g}: elements that differ from the "
                             f"plain versions {differ}")
    fns = {label: dict(
        k5=lambda b=b: b.absmax(x),
        k6=lambda b=b: b.quantize_s8(x, amax_p, g.Cp),
        k7=lambda b=b: b.conv_s8s8s32(codes_p, sx_p, qw.kernel, qw.scale, g,
                                      x.dtype)) for label, b in builds.items()}
    dev_ms = lambda fn: chip_smoke.graph_ms(fn, reps=10, replays=3)
    size = x.element_size()
    # the bounds count the true channels C: the codes' padding to Cp is
    # not work the function must do
    k7_bytes = (g.N * g.H * g.W * g.C + g.O * g.KH * g.KW * g.C
                + g.N * g.O * g.Ho * g.Wo * size)
    bounds = dict(k5=chip_smoke.bound(x.numel() * size, 0),
                  k6=chip_smoke.bound(x.numel() * (size + 1), 0),
                  k7=chip_smoke.bound_int8(k7_bytes, g.ops()))
    row = dict(N=g.N, C=g.C, H=g.H, W=g.W, O=g.O, k=g.KW, dil=g.dil,
               ndim=m.ndim, numel=x.numel(), count=site["count"],
               differ=differ, fns=fns)
    for k in KERNELS:
        row[k] = dict(**in_turns(lambda label: dev_ms(fns[label][k]),
                                 rounds), **bounds[k])
    row["k5"]["library_ms"] = dev_ms(lambda: torch.linalg.vector_norm(
        x, float("inf")))
    print(f"    {describe(row)}: " + "; ".join(
        f"{k.upper()} baseline {row[k]['baseline_ms']:.4f} ms, checkout "
        f"{row[k]['checkout_ms']:.4f} ({row[k]['ratio']:.3f}x, bound "
        f"{row[k]['bound_ms']:.4f})" for k in KERNELS)
        + f"; vector_norm {row['k5']['library_ms']:.4f}", flush=True)
    return row


def describe(row) -> str:
    return (f"C={row['C']} {row['H']}x{row['W']} O={row['O']} k={row['k']} "
            f"dil={row['dil']} x{row['count']} ({row['numel']} elements)")


def retime(rows, rounds) -> list:
    """Every kernel and geometry where the checkout read more than SLOWER
    times the baseline, timed again in `rounds` rounds of the turns, 20
    calls replayed 10 times a run; every run printed."""
    again = []
    for row in rows:
        for k in KERNELS:
            if row[k]["ratio"] <= SLOWER:
                continue
            fns = row["fns"]
            r = in_turns(lambda label: chip_smoke.graph_ms(
                fns[label][k], reps=20, replays=10), rounds)
            row[k]["retime"] = r
            again.append(dict(kernel=k, geometry=describe(row),
                              first_ratio=row[k]["ratio"], **r))
            print(f"[retime] {k.upper()} {describe(row)}: first "
                  f"{row[k]['ratio']:.3f}x; again {r['ratio']:.3f}x, runs "
                  f"(ms) baseline {r['runs']['baseline']}, checkout "
                  f"{r['runs']['checkout']}", flush=True)
    return again


def per_forward(rows) -> dict:
    out = {}
    for k in KERNELS:
        keys = ("baseline_ms", "checkout_ms", "bound_ms") + (
            ("library_ms",) if k == "k5" else ())
        tot = {key: sum(r["count"] * r[k][key] for r in rows)
               for key in keys}
        for label in LABELS:
            tot[f"{label}_share"] = tot["bound_ms"] / tot[f"{label}_ms"]
        ratios = [r[k].get("retime", r[k])["ratio"] for r in rows]
        tot["slower_at"] = sum(q > 1.0 for q in ratios)
        tot["worst_ratio"] = max(ratios)
        out[k] = tot
    return out


def engine_turns(ik, base) -> dict:
    """The int8 ACDC engine (chip_smoke.serve_argv, acdc_problem's request)
    and the int8 cine engine (cine_argv, cine_problem), each built once,
    warmed up, then one in-process request a turn with each build's
    kernels: chain-steps/s."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        serve_recon)
    cfg, _ = chip_smoke.acdc_model()
    _, _, _, yr, yi = chip_smoke.acdc_problem(cfg, "cuda",
                                              chip_smoke.SERVE_LEVELS)
    y_acdc = tuple(v[:, 0].cpu().numpy() for v in (yr, yi))
    cine_cfg = load_config("CINE127", "real-imag")
    _, _, yc_re, yc_im = chip_smoke.cine_problem(cine_cfg.data.image_size,
                                                 chip_smoke.CINE_FRAMES)
    builds = dict(baseline=base, checkout=ik)
    out = {}
    for name, argv, y in (("acdc_int8", chip_smoke.serve_argv("int8"),
                           y_acdc),
                          ("cine_int8", chip_smoke.cine_argv("int8"),
                           (yc_re, yc_im))):
        eng = serve_recon.build_engine(serve_recon.parse_args(argv))
        eng.warmup()

        def request(label):
            with use_build(ik, builds[label]):
                res = eng.reconstruct(*y, seed=3)
            if not np.isfinite(res.x_re).all():
                raise AssertionError(f"int8_ab {name} ({label}): not finite")
            return res.chain_steps_per_s

        out[name] = r = in_turns(request, 1)
        print(f"[engines] {name}: chain-steps/s baseline "
              f"{r['runs']['baseline']}, checkout {r['runs']['checkout']}",
              flush=True)
        del eng
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--baseline", required=True,
                   help="the root of the checkout to hold this one against")
    p.add_argument("--rounds", type=int, default=2,
                   help="rounds of the turns at every geometry")
    p.add_argument("--retime", type=int, default=6,
                   help="rounds of the turns where the checkout read slower")
    p.add_argument("--out", default=None,
                   help="where to write every row as JSON")
    p.add_argument("--engines", action="store_true",
                   help="also time the int8 serving engines on each build")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_ab: torch sees no CUDA device")
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import NCSN1D
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        to_nchw)
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import (
        _build, int8_kernels as ik, quant)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)

    base = load_baseline(args.baseline)
    builds = dict(baseline=base, checkout=ik)
    for label, b in builds.items():
        built = b._build.build()
        print(f"[build] {label}: nvcc {built.seconds:.2f} s -> {built.path}")
        lines = built.log.splitlines()
        for i, line in enumerate(lines):    # ptxas -v on K5 and K6
            if "Compiling entry" in line and ("absmax" in line
                                              or "quantize" in line):
                for shown in lines[i:i + 4]:
                    print(f"    {shown.strip()}")
    one_call = one_call_build_seconds()
    parallel = _build.build().seconds
    print(f"[build] the checkout's sources in one nvcc call: {one_call:.2f} "
          f"s; one nvcc -c per source together, then a link: "
          f"{parallel:.2f} s (0.00: a build was reused)", flush=True)
    results = dict(build=dict(parallel_s=parallel, one_call_s=one_call),
                   rounds=args.rounds, retime_rounds=args.retime)
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    cfg, model = chip_smoke.acdc_model()
    net = quant.enable_int8(copy.deepcopy(model).to("cuda", bf))
    nb = 2 * chip_smoke.ACDC_CHAINS
    size = cfg.data.image_size
    xb = torch.rand(nb, size, size, 1, generator=gen).to("cuda")
    sig = torch.linspace(1.0, 0.1, nb).to("cuda", bf)
    xin = to_nchw(xb).to(bf)
    forward = lambda: net(xin, sig)
    cfg_t = load_config("CINE127_1D", "real-imag")
    net_t = quant.enable_int8(
        seeded_weights(NCSN1D(cfg_t), seed=0).to("cuda", bf))
    tubes = 2 * chip_smoke.CINE_CHAINS * (128 // chip_smoke.CINE_WIN) ** 2
    xt = torch.randn(tubes, cfg_t.data.channels, cfg_t.data.image_size,
                     generator=gen).to("cuda", bf)
    st = torch.full((tubes,), 0.5, device="cuda", dtype=bf)
    all_x = []
    with torch.inference_mode():
        for name, n, run in (("ncsnv2 b32", net, forward),
                             (f"ncsn1d b{tubes}", net_t,
                              lambda: net_t(xt, st))):
            print(f"[{name}]", flush=True)
            sites, calls = chip_smoke.int8_sites(n, run)
            rows = [geometry_row(builds, ik, quant, s, args.rounds)
                    for s in sites.values()]
            again = retime(rows, args.retime)
            all_x += [s["x"] for s in sites.values()]
            tot = per_forward(rows)
            for r in rows:
                del r["fns"]
            results[name] = dict(convs_per_forward=calls,
                                 geometries=len(rows), rows=rows,
                                 retimed=again, per_forward=tot)
            for k, label in (("k5", "K5 absmax"), ("k6", "K6 quantize_s8"),
                             ("k7", "K7 conv_s8s8s32")):
                t = tot[k]
                lib = (f", vector_norm {t['library_ms']:.4f}"
                       if k == "k5" else "")
                print(f"[sum] {name} {label} per forward ({calls} "
                      f"convolutions, {len(rows)} geometries): baseline "
                      f"{t['baseline_ms']:.4f} ms ({t['baseline_share']:.3f} "
                      f"of the bound), checkout {t['checkout_ms']:.4f} ms "
                      f"({t['checkout_share']:.3f}), bound "
                      f"{t['bound_ms']:.4f}{lib}; checkout slower at "
                      f"{t['slower_at']} of {len(rows)}, worst "
                      f"{t['worst_ratio']:.3f}x (after any retime)",
                      flush=True)
        # the fixed cost per call: the smallest and the median input alone,
        # and a tiny one
        by_size = sorted(all_x, key=lambda x: x.numel())
        alone = {"smallest": by_size[0], "median": by_size[len(by_size) // 2],
                 "tiny": torch.randn(TINY, generator=gen).to("cuda", bf)}
        results["alone"] = {}
        for label, x in alone.items():
            r = in_turns(lambda b: chip_smoke.graph_ms(
                lambda: builds[b].absmax(x), reps=20, replays=5), 1)
            r.update(numel=x.numel(), **chip_smoke.bound(
                x.numel() * x.element_size(), 0))
            results["alone"][label] = r
            print(f"[alone] K5 {label} input ({x.numel()} elements): "
                  f"baseline {r['baseline_ms'] * 1e3:.2f} us, checkout "
                  f"{r['checkout_ms'] * 1e3:.2f} us, bound "
                  f"{r['bound_ms'] * 1e3:.2f} us", flush=True)
        del all_x, alone, by_size

        # one whole int8 forward at batch 32 on each build, device ms
        def fwd(label):
            with use_build(ik, builds[label]):
                return chip_smoke.cuda_ms(forward, reps=5)

        results["forward_b32"] = r = in_turns(fwd, 1)
        print(f"[forward] int8 NCSNv2Deepest at batch 32: baseline "
              f"{r['runs']['baseline']} ms, checkout {r['runs']['checkout']} "
              f"ms on the card", flush=True)
    del net, net_t, model
    torch.cuda.empty_cache()
    if args.engines:
        results["engines"] = engine_turns(ik, base)
    smi = chip_smoke.nvidia_smi()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, **results), f, indent=1, default=str)
    print(smi)
    print(json.dumps({name: r["per_forward"] for name, r in results.items()
                      if isinstance(r, dict) and "per_forward" in r}))


if __name__ == "__main__":
    main()

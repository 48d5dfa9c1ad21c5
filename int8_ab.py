#!/usr/bin/env python3
"""Time two builds of the int8 kernels K6 (`int8_quantize_<dtype>`) and K7
(`int8_conv_<dtype>`) against each other on one NVIDIA GPU:

  git show <commit>:inverseproblemwithdiffusionmodel_tpu_torch/ops/csrc/int8conv.cu \\
      > old_int8conv.cu
  python3 int8_ab.py --baseline old_int8conv.cu [--out file.json]

The baseline source is an int8conv.cu from before K6 became a tiled
transpose and K7 a wgmma kernel, whose K7 launcher takes (codes, weight
codes, scale, weight scales, out, sums, N, H, W, Cp, O, KH, KW, pad_h,
pad_w, dilation, Ho, Wo, stream). It is built with the checkout's other
ops/csrc sources into a second library beside the checkout's own
(ops/_build.py).

At every convolution geometry of one int8 NCSNv2Deepest forward at batch 32
(ACDC, 256 px, ngf 128, seeded weights in bf16) and of one int8 NCSN1D
forward at 2,048 tubes (CINE127_1D, ngf 128), found by chip_smoke.int8_sites
on the real inputs, both libraries' K6 codes and scale and K7 int32 sums and
dequantized output are held against the plain versions bit for bit, and
each launch is timed device-only (chip_smoke.graph_ms: launches captured in
a CUDA graph, the replay timed by CUDA events) in turns baseline, checkout,
checkout, baseline, so that both see the same card, clocks and neighbours.
Prints each geometry, the sums per forward (each geometry times its calls)
beside the bound (K6: x read and its (N, P, C) codes written once at the
card's memory rate; K7: 2 M O K operations at the int8 tensor cores' dense
rate, or its bytes if more, K over the true channels C, not the codes'
padding to Cp), the host's enqueue and the device's time of one
whole int8 forward at batch 32, and the card's name and power limit; with
--out, writes every row there as JSON. It also times the checkout's
library built in ops/_build.py's form (one nvcc -c per source, all started
together, then a link) against one nvcc call over the same sources.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import glob
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

_P, _I = ctypes.c_void_p, ctypes.c_longlong
# the baseline's C launchers (K6's signature is unchanged)
BASELINE_ARGTYPES = {
    "int8_quantize_f32": [_P] * 4 + [_I] * 4 + [_P],
    "int8_quantize_bf16": [_P] * 4 + [_I] * 4 + [_P],
    "int8_conv_f32": [_P] * 6 + [_I] * 12 + [_P],
    "int8_conv_bf16": [_P] * 6 + [_I] * 12 + [_P],
}
TURNS = ("baseline", "checkout", "checkout", "baseline")


def baseline_library(path: str):
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import _build
    others = [s for s in glob.glob(os.path.join(_build._CSRC, "*.cu"))
              if os.path.basename(s) != "int8conv.cu"]
    b = _build.build(tuple(sorted([os.path.abspath(path)] + others)),
                     launchers=())
    for name, argtypes in BASELINE_ARGTYPES.items():
        fn = getattr(b.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return b


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


def baseline_calls(lib, x, amax, qw, g, dtype):
    """K6 and K7 of the baseline library at geometry g, each writing into
    buffers made here, so that the calls can be captured in a graph."""
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    stream = lambda: torch.cuda.current_stream().cuda_stream
    codes = torch.empty((g.N, g.H, g.W, g.Cp), dtype=torch.int8,
                        device="cuda")
    scale = torch.empty(1, dtype=torch.float32, device="cuda")
    out = torch.empty((g.N, g.O, g.Ho, g.Wo), dtype=dtype, device="cuda")
    sums = torch.empty(out.shape, dtype=torch.int32, device="cuda")
    P = g.H * g.W

    def check(rc, name):
        if rc != 0:
            raise RuntimeError(f"baseline {name}: CUDA error {rc}")

    def k6():
        check(getattr(lib, f"int8_quantize_{suffix}")(
            x.data_ptr(), amax.data_ptr(), codes.data_ptr(),
            scale.data_ptr(), g.N, g.C, P, g.Cp, stream()), "K6")

    def k7(with_sums=False):
        check(getattr(lib, f"int8_conv_{suffix}")(
            codes.data_ptr(), qw.kernel.data_ptr(), scale.data_ptr(),
            qw.scale.data_ptr(), out.data_ptr(),
            sums.data_ptr() if with_sums else None, g.N, g.H, g.W, g.Cp, g.O,
            g.KH, g.KW, g.pad_h, g.pad_w, g.dil, g.Ho, g.Wo, stream()), "K7")

    return k6, k7, codes, scale, out, sums


def geometry_row(base_lib, ik, quant, site) -> dict:
    m, x = site["conv"], site["x"]
    qw = m.quant
    g = quant.geometry(x, qw, m.padding, m.dilation, m.ndim, m.pre_pad)
    plan = ik.conv_plan(g)
    dtype = x.dtype
    amax = ik.absmax(x)
    codes_p, sx_p = ik.quantize_s8_plain(x, amax, g.Cp)
    codes_p = codes_p.reshape(g.N, g.H, g.W, g.Cp)
    out_p, sums_p = ik.conv_s8s8s32_plain(codes_p, sx_p, qw.kernel, qw.scale,
                                          g, dtype, with_sums=True)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    differ = {}
    # checkout
    codes, sx = ik.quantize_s8(x, amax, g.Cp)
    codes = codes.reshape(codes_p.shape)
    out, sums = ik.conv_s8s8s32(codes, sx, qw.kernel, qw.scale, g, dtype,
                                with_sums=True)
    differ["checkout"] = dict(
        codes=int((codes != codes_p).sum()), scale=int((sx != sx_p).sum()),
        sums=int((sums != sums_p).sum()),
        out=int((out.view(bits) != out_p.view(bits)).sum()))
    # baseline
    k6, k7, b_codes, b_scale, b_out, b_sums = baseline_calls(
        base_lib, x, amax, qw, g, dtype)
    k6()
    k7(with_sums=True)
    torch.cuda.synchronize()
    differ["baseline"] = dict(
        codes=int((b_codes != codes_p).sum()),
        scale=int((b_scale != sx_p).sum()),
        sums=int((b_sums != sums_p).sum()),
        out=int((b_out.view(bits) != out_p.view(bits)).sum()))
    if any(v for d in differ.values() for v in d.values()):
        raise AssertionError(f"int8_ab: {g}: elements that differ from the "
                             f"plain versions {differ}")
    fns = {"baseline": {"k6": k6, "k7": k7},
           "checkout": {"k6": lambda: ik.quantize_s8(x, amax, g.Cp),
                        "k7": lambda: ik.conv_s8s8s32(
                            codes, sx, qw.kernel, qw.scale, g, dtype)}}
    runs = {k: {label: [] for label in fns} for k in ("k6", "k7")}
    for label in TURNS:
        for k in ("k6", "k7"):
            runs[k][label].append(chip_smoke.graph_ms(fns[label][k], reps=10,
                                                      replays=3))
    # the bounds count the true channels C: the codes' padding to Cp is
    # not work the function must do
    k6_bytes = x.numel() * (x.element_size() + 1)
    k7_bytes = (g.N * g.H * g.W * g.C + g.O * g.KH * g.KW * g.C
                + g.N * g.O * g.Ho * g.Wo * x.element_size())
    row = dict(
        N=g.N, C=g.C, H=g.H, W=g.W, O=g.O, k=g.KW, dil=g.dil, ndim=m.ndim,
        count=site["count"], differ=differ,
        plan=dict(bn=plan.bn, cb=plan.cb, stages=plan.stages, run=plan.run,
                  k_iters=plan.k_iters, m_tiles=plan.m_tiles,
                  o_tiles=plan.o_tiles),
        k6=dict(runs=runs["k6"], **chip_smoke.bound_int8(k6_bytes, 0)),
        k7=dict(runs=runs["k7"], ops=g.ops(),
                **chip_smoke.bound_int8(k7_bytes, g.ops())))
    for k in ("k6", "k7"):
        for label in fns:
            row[k][f"{label}_ms"] = sum(runs[k][label]) / 2
    print(f"    C={g.C} {g.H}x{g.W} O={g.O} k={g.KW} dil={g.dil} "
          f"x{site['count']} (bn {plan.bn} cb {plan.cb}): K7 "
          f"baseline {row['k7']['baseline_ms']:.4f} ms, checkout "
          f"{row['k7']['checkout_ms']:.4f} (bound "
          f"{row['k7']['bound_ms']:.4f}, {row['k7']['bound_by']}); K6 "
          f"baseline {row['k6']['baseline_ms']:.4f}, checkout "
          f"{row['k6']['checkout_ms']:.4f} (bound "
          f"{row['k6']['bound_ms']:.4f})", flush=True)
    return row


def per_forward(rows) -> dict:
    out = {}
    for k in ("k6", "k7"):
        tot = {key: sum(r["count"] * r[k][key] for r in rows)
               for key in ("baseline_ms", "checkout_ms", "bound_ms",
                           "bytes_ms", "ops_ms")}
        tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                           else "operations")
        for label in ("baseline", "checkout"):
            tot[f"{label}_share"] = tot["bound_ms"] / tot[f"{label}_ms"]
        tot["slower_at"] = sum(r[k]["checkout_ms"] > r[k]["baseline_ms"]
                               for r in rows)
        out[k] = tot
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--baseline", required=True,
                   help="the int8conv.cu to hold the checkout's against")
    p.add_argument("--out", default=None,
                   help="where to write every row as JSON")
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

    base_build = baseline_library(args.baseline)
    new_build = _build.build()
    for label, b in (("baseline", base_build), ("checkout", new_build)):
        print(f"[build] {label}: nvcc {b.seconds:.2f} s -> {b.path}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    one_call = one_call_build_seconds()
    print(f"[build] the checkout's sources in one nvcc call: {one_call:.2f} "
          f"s; one nvcc -c per source together, then a link: "
          f"{new_build.seconds:.2f} s (0.00: a build was reused)", flush=True)
    base_lib = base_build.lib
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
    results = dict(build=dict(parallel_s=new_build.seconds,
                              one_call_s=one_call))
    with torch.inference_mode():
        for name, n, run in (("ncsnv2 b32", net, forward),
                             (f"ncsn1d b{tubes}", net_t,
                              lambda: net_t(xt, st))):
            print(f"[{name}]", flush=True)
            sites, calls = chip_smoke.int8_sites(n, run)
            rows = [geometry_row(base_lib, ik, quant, s)
                    for s in sites.values()]
            tot = per_forward(rows)
            results[name] = dict(convs_per_forward=calls,
                                 geometries=len(rows), rows=rows,
                                 per_forward=tot)
            for k, label in (("k6", "K6 quantize_s8"),
                             ("k7", "K7 conv_s8s8s32")):
                t = tot[k]
                print(f"[sum] {name} {label} per forward ({calls} "
                      f"convolutions, {len(rows)} geometries): baseline "
                      f"{t['baseline_ms']:.4f} ms ({t['baseline_share']:.3f} "
                      f"of the bound), checkout {t['checkout_ms']:.4f} ms "
                      f"({t['checkout_share']:.3f}), bound "
                      f"{t['bound_ms']:.4f} ({t['bound_by']}); checkout "
                      f"slower at {t['slower_at']} of {len(rows)}",
                      flush=True)
        # one whole int8 forward at batch 32: device ms and the host's
        # enqueue ms, the checkout's kernels
        dev, host = chip_smoke.cuda_ms(forward, reps=5, host=True)
        results["forward_b32"] = dict(device_ms=dev, enqueue_ms=host)
        print(f"[forward] int8 NCSNv2Deepest at batch 32 (checkout): "
              f"{dev:.2f} ms on the card, {host:.2f} ms to enqueue",
              flush=True)
    smi = chip_smoke.nvidia_smi()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=smi, **results), f, indent=1)
    print(smi)
    print(json.dumps({name: r["per_forward"] for name, r in results.items()
                      if "per_forward" in r}))


if __name__ == "__main__":
    main()

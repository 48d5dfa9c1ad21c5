#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Drives the port only (inverseproblemwithdiffusionmodel_tpu_torch; no JAX) in
phases, each printing one line with its own seconds:

1. device: the card, torch and CUDA versions, nvidia-smi's name and power
   limit. Exits non-zero, printing no result, where torch sees no card.
2. build: one nvcc over every ops/csrc/*.cu into one library with a plain
   C interface, loaded with ctypes; prints ptxas' register and
   shared-memory lines for every kernel.
3. kernels: K1 (FIR 2x up) and K2 (FIR 2x down) against their plain PyTorch
   versions at the 36 shapes one FFHQ-256 NCSN++ forward gives them, at
   batch 2 (sampling) and batch 8 (training); each kernel, its plain
   version and one library call computing the same function (a depthwise
   conv, the yardstick) timed device-only (graph_ms: 20 calls captured in
   a CUDA graph, its replay timed by CUDA events), the kernel also with
   the host's gaps (CUDA events around 20 launches from the host), beside
   the least time the card could take; per shape and summed per forward
   at each batch. Then the host's µs per launch at the smallest shape,
   through the launching wrapper and through the public op.
   kernels_bwd: the K3 backward (K2 as the backward of an up pass, K1 as
   the backward of a down pass) at the 30 shapes one training step gives
   it, batch 8: the gradients of the autograd Functions against the plain
   transposes, then timed like the forward.
   flr: K4 (fused bias + leaky ReLU, forward and backward) at three shapes,
   forward, dx and db against the plain versions, timed; no single PyTorch
   call computes it, so it has no library yardstick.
4. model: the full-width FFHQ-256 NCSN++ (65.6 M parameters, weights drawn
   from seed 0) forward on the card against the same model on the CPU, at
   batch 1 and, in the float32 mode, at batch 2, and the kernels' launch
   counts over that forward (18 each).
5. sample: scripts.pc_sampling.main with that config at num_scales 100
   (reduced from 2000), 2 samples: finite samples, 200 network evaluations
   (the nfe it prints), 18 launches of each kernel per evaluation; and a
   tiny PC run on the card against the same run on the CPU, fed the same
   noise.
6. train: training.fit with make_continuous_score_train_step on the
   full-width FFHQ-256 NCSN++ (seeded weights), seeded synthetic images,
   batch 8 (reduced from 64, the leaf's), Adam at the leaf's lr and
   grad_clip, torch defaults (TF32 on), 6 steps into a temporary log_dir:
   finite losses, step 6, parameters moved, the EMA equals its formula over
   the run, a checkpoint, and per step 18 launches of K1 and of K2 forward,
   18 of K2 and 12 of K1 as the backward (the 6 input-pyramid downs act on
   data and need no gradient). Seconds per step, images/s, peak memory.
7. train_parity: one step of the full-width net at batch 1 on the card and
   on the CPU, same weights, batch and injected t and z, TF32 off: loss
   difference and relative L2 of the gradients over all parameters.
8. sample_ckpt: scripts.pc_sampling.main --ckpt_dir on the trained run's
   checkpoint, num_scales 10: the restored step, finite samples, 20
   network evaluations and 18 launches of each kernel per evaluation.

Every comparison with a plain or CPU version runs in the port's float32
mode (utils/precision.float32_exact: TF32 off for cuDNN and matmul, cuDNN
benchmark mode on, since its heuristics would pick an FFT convolution at
batch >= 2; PERF.md), so the card computes in float32 like the reference.
The sampling and training runs themselves use torch's defaults, as a
user's run does: cuDNN convolutions in TF32. Launch counts are cleared just
before each path (sample, train, sample_ckpt, the K4 op) and read just
after it. Any failure raises and exits non-zero. The last lines are
nvidia-smi's name and power limit, a JSON line of per-kernel numbers, and
`{"ok": true, "device": {...}}`. In the JSON line `ms`, `plain_ms` and
`library_ms` are device-only; `ms_with_host` is the kernel with the host's
gaps; K1's and K2's entries add their batch-8 forward sums and the host's
µs per launch.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

CONFIG = "ve/ffhq_256_ncsnpp_continuous"
NUM_SCALES = 100           # the config's 2000, reduced to keep the run short
BATCH = 2
KERNEL_RTOL = 1e-5         # of the largest |value|: float32 sums reordered
MODEL_REL_L2 = 1e-4        # card vs CPU forward, float32 with TF32 off
TRAIN_BATCH = 8            # the leaf's 64, reduced
TRAIN_STEPS = 6
CKPT_NUM_SCALES = 10
FLR_SHAPES = [(8 * 256 * 256, 128), (8 * 16 * 16, 256), (7 * 5 * 5, 3)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM data sheet, float32 outside tensor cores
PALLAS = "inverseproblemwithdiffusionmodel_tpu/ops/pallas_kernels.py"
REPLACES = {
    "up2x": f"{PALLAS}:179",
    "down2x": f"{PALLAS}:199",
    "up2x.bwd": f"{PALLAS}:291",     # fir_downsample_2x's linear_transpose
    "down2x.bwd": f"{PALLAS}:266",   # fir_upsample_2x's linear_transpose
    "flr_fwd": f"{PALLAS}:61",
    "flr_bwd": f"{PALLAS}:84",
}
CSRC = "inverseproblemwithdiffusionmodel_tpu_torch/ops/csrc"
SOURCES = {"up2x": f"{CSRC}/fir2x.cu", "down2x": f"{CSRC}/fir2x.cu",
           "up2x.bwd": f"{CSRC}/fir2x.cu", "down2x.bwd": f"{CSRC}/fir2x.cu",
           "flr_fwd": f"{CSRC}/flr.cu", "flr_bwd": f"{CSRC}/flr.cu"}


def say(phase: str, t0: float, text: str) -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f} s | {text}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def fir_shapes(cfg):
    """(kernel, C, R) of every FIR call in one NCSN++ forward, in order."""
    m = cfg.model
    nf, mult, ch = m.nf, tuple(m.ch_mult), cfg.data.num_channels
    res = [cfg.data.image_size // 2 ** i for i in range(len(mult))]
    levels = range(len(mult) - 1)
    down = [("down2x", nf * mult[i], res[i]) for i in levels for _ in "hx"]
    down += [("down2x", ch, res[i]) for i in levels]
    up = [("up2x", nf * mult[i], res[i]) for i in range(1, len(mult))
          for _ in "hx"]
    up += [("up2x", ch, res[i]) for i in range(1, len(mult))]
    return down + up


def bwd_shapes(cfg):
    """(kernel launched as the backward, C, R of the forward call) for every
    FIR call of one training step that needs a gradient: K2 for each up
    pass, K1 for each BigGAN down pass. The input pyramid's down passes act
    on the perturbed data, which needs no gradient."""
    m = cfg.model
    nf, mult = m.nf, tuple(m.ch_mult)
    res = [cfg.data.image_size // 2 ** i for i in range(len(mult))]
    down = [("up2x.bwd", nf * mult[i], res[i]) for i in range(len(mult) - 1)
            for _ in "hx"]
    up = [("down2x.bwd", C, R) for name, C, R in fir_shapes(cfg)
          if name == "up2x"]
    return down + up


def cuda_ms(fn, reps: int = 20, host: bool = False):
    """Device ms per call by CUDA events, after 3 warm-up calls; with
    host=True also the host's ms per call to enqueue the work."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / reps
    return (device_ms, host_ms) if host else device_ms


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms per call with the host's gaps taken out: after a warm-up
    call, `reps` calls captured into one CUDA graph (the kernels' ctypes
    launch takes torch's current stream, so it is captured too), the graph
    replayed `replays` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def library_fn(up: bool, x: torch.Tensor, taps: np.ndarray):
    """One depthwise PyTorch conv computing the up (K1) or down (K2) pass
    with these 4 taps per axis: conv_transpose2d with the outer product of
    the taps (up), conv2d with that of the reversed taps (down). The weight
    is made here, so the call it returns can be captured in a CUDA graph."""
    C = x.shape[-1]
    t = np.asarray(taps, np.float32)
    if not up:
        t = t[::-1]
    w = torch.tensor(np.outer(t, t), device=x.device).expand(C, 1, 4, 4)
    w = w.contiguous()
    conv = F.conv_transpose2d if up else F.conv2d
    return lambda: conv(x.permute(0, 3, 1, 2), w, stride=2, padding=1,
                        groups=C).permute(0, 2, 3, 1)


def bound(bytes_moved: float, flop: float) -> dict:
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    ops_ms = 1e3 * flop / FP32_FLOP_PER_S
    return dict(bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def kernel_numbers(tag, C, R, k, fk, gen, batch):
    """Check one FIR kernel launch site against its plain version, then
    time kernel, plain version and library call. `tag` "up2x" /
    "down2x" is the forward pass of a call at (batch, R, R, C);
    "down2x.bwd" / "up2x.bwd" is K2 / K1 as the backward of an up / down
    call at that shape, checked through the autograd Functions."""
    x = torch.randn(batch, R, R, C, generator=gen).cuda()
    up_taps, dn_taps = fk._sep_kernel_1d(k, 2.0), fk._sep_kernel_1d(k, 1.0)
    if tag == "up2x":
        inp, taps = x, up_taps
        check = lambda: fk.upsample2x(x, k)
    elif tag == "down2x":
        inp, taps = x, dn_taps
        check = lambda: fk.downsample2x(x, k)
    else:
        fwd = fk.upsample2x if tag == "down2x.bwd" else fk.downsample2x
        R_out = 2 * R if tag == "down2x.bwd" else R // 2
        inp = torch.randn(batch, R_out, R_out, C, generator=gen).cuda()
        taps = (up_taps if tag == "down2x.bwd" else dn_taps)[::-1].copy()
        x.requires_grad_()
        check = lambda: torch.autograd.grad(fwd(x, k), x, inp)[0]
    up = tag.startswith("up")
    launch = fk._up if up else fk._down
    plain_fn = fk.upsample2x_plain if up else fk.downsample2x_plain
    kern = lambda: launch(inp, taps, tag)
    plain = lambda: plain_fn(inp, taps)
    lib = library_fn(up, inp, taps)
    out, ref, lib_out = check(), plain(), lib()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    lib_err = (lib_out - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not err <= KERNEL_RTOL * scale:
        raise AssertionError(f"{tag} C={C} R={R}: max_abs_err {err} > "
                             f"{KERNEL_RTOL} * {scale}")
    if not lib_err <= KERNEL_RTOL * scale:
        raise AssertionError(f"{tag} C={C} R={R}: the library yardstick "
                             f"computes another function ({lib_err})")
    n_out = ref.numel()
    flop_per_out = 12 if up else 40   # 2x2 (up) or 4x4 (down) taps, H then W
    return dict(C=C, R=R, B=batch, err=err, ms=graph_ms(kern),
                ms_with_host=cuda_ms(kern), plain_ms=graph_ms(plain),
                library_ms=graph_ms(lib),
                **bound(4 * (inp.numel() + n_out), n_out * flop_per_out))


def host_us(fn, reps: int = 500) -> float:
    """Host µs per call of a launch the card finishes before the host has
    the next one ready."""
    return 1e3 * cuda_ms(fn, reps=reps, host=True)[1]


def launch_paths(fk, k, shapes, name):
    """(C, R) of kernel `name`'s smallest call in `shapes` and, on a batch-2
    input of that shape, the call of the wrapper that launches the kernel
    (`_up` / `_down`) and of the public op the model calls (taps, checks
    and the autograd Function on top)."""
    C, R = min(((C, R) for n, C, R in shapes if n == name),
               key=lambda cr: cr[0] * cr[1] ** 2)
    x = torch.randn(BATCH, R, R, C, device="cuda")
    up = name == "up2x"
    taps = fk._sep_kernel_1d(k, 2.0 if up else 1.0)
    wrapper, public = ((fk._up, fk.upsample2x) if up
                       else (fk._down, fk.downsample2x))
    return C, R, dict(wrapper=lambda: wrapper(x, taps, name),
                      public=lambda: public(x, k))


def host_us_per_launch(fk, k, shapes):
    """Host µs per launch of K1 and K2 at their smallest shape of a
    forward, through the wrapper and through the public op."""
    out = {}
    for name in ("up2x", "down2x"):
        C, R, fns = launch_paths(fk, k, shapes, name)
        out[name] = dict(C=C, R=R, wrapper_us=host_us(fns["wrapper"]),
                         public_us=host_us(fns["public"]))
    return out


def summarize(rows, what: str):
    """Sums over one kernel's rows; prints the three largest and the sum.
    `ms`, `plain_ms` and `library_ms` are device-only (graph replay);
    `ms_with_host` is the kernel timed by CUDA events around a loop of
    launches from the host."""
    summary = {}
    for name, rs in rows.items():
        tot = {key: sum(r[key] for r in rs) for key in
               ("ms", "ms_with_host", "plain_ms", "library_ms", "bound_ms",
                "bytes_ms", "ops_ms")}
        summary[name] = dict(tot, err=max(r["err"] for r in rs),
                             bound_by="bytes" if tot["bytes_ms"]
                             >= tot["ops_ms"] else "operations")
        for r in sorted(rs, key=lambda r: -r["bound_ms"])[:3]:
            print(f"    {name} (C={r['C']}, R={r['R']}, B={r['B']}): "
                  f"kernel_ms device {r['ms']:.4f} with host "
                  f"{r['ms_with_host']:.4f}, plain_ms {r['plain_ms']:.4f} "
                  f"library_ms {r['library_ms']:.4f} bound_us "
                  f"{1e3 * r['bound_ms']:.2f} ({r['bound_by']}) "
                  f"max_abs_err {r['err']:.3g}", flush=True)
        print(f"    {name}, sum over its {len(rs)} calls of {what}: "
              f"kernel_ms device {tot['ms']:.4f} with host "
              f"{tot['ms_with_host']:.4f}, plain_ms {tot['plain_ms']:.4f} "
              f"library_ms {tot['library_ms']:.4f} bound_us "
              f"{1e3 * tot['bound_ms']:.2f}", flush=True)
        print(f"    {name} per call, device us: " + " ".join(
            f"C{r['C']}/R{r['R']}:{1e3 * r['ms']:.2f}" for r in rs),
            flush=True)
    return summary


def flr_numbers(shape, y, dx, db, x, b, g, fl, fused_leaky_relu):
    """Hold K4's outputs from the op's run against the plain versions, then
    time each kernel and its plain version."""
    slope, scale = 0.2, 2 ** 0.5
    C, n = shape[-1], x.numel()
    y_ref = fused_leaky_relu(x, b, slope, scale)
    dx_ref = fl.fused_leaky_relu_bwd_plain(x, b, g, slope, scale)
    db_ref = dx_ref.reshape(-1, C).sum(0)
    errs = {}
    for name, out, ref in (("y", y, y_ref), ("dx", dx, dx_ref),
                           ("db", db, db_ref)):
        errs[name] = (out - ref).abs().max().item()
        top = ref.abs().max().item()
        if not errs[name] <= KERNEL_RTOL * top:
            raise AssertionError(f"flr {shape} {name}: max_abs_err "
                                 f"{errs[name]} > {KERNEL_RTOL} * {top}")
    fwd_k = lambda: fl.flr_forward(x, b, slope, scale)
    bwd_k = lambda: fl.flr_backward(x, b, g, slope, scale)
    fwd = dict(err=errs["y"], ms=graph_ms(fwd_k),
               ms_with_host=cuda_ms(fwd_k), plain_ms=graph_ms(
                   lambda: fused_leaky_relu(x, b, slope, scale)),
               **bound(4 * (2 * n + C), 3 * n))      # read x, b; write y
    bwd = dict(err=errs["dx"], db_err=errs["db"], ms=graph_ms(bwd_k),
               ms_with_host=cuda_ms(bwd_k), plain_ms=graph_ms(
                   lambda: fl.fused_leaky_relu_bwd_plain(x, b, g, slope,
                                                         scale)),
               **bound(4 * (3 * n + C), 2 * n))      # read x, b, g; write dx
    return fwd, bwd


def run_pc_sampling(pc_sampling, argv):
    """pc_sampling.main(argv), its output echoed indented: the samples, the
    nfe its printed line gives, and that output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        samples = pc_sampling.main(argv)
    for line in out.getvalue().splitlines():
        print(f"    {line}", flush=True)
    found = re.search(r"\(nfe=(\d+)\)", out.getvalue())
    if found is None:
        raise AssertionError("pc_sampling printed no nfe")
    nfe = int(found.group(1))
    return samples, nfe, out.getvalue()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def main() -> None:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this smoke "
                         "runs on the GPU only")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
        get_continuous_config, make_sde)
    from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import _build
    from inverseproblemwithdiffusionmodel_tpu_torch.ops import (
        fir_kernels as fk, flr_kernels as fl)
    from inverseproblemwithdiffusionmodel_tpu_torch.ops.fused_act import (
        fused_leaky_relu)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        pc_sampling)
    from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
        get_pc_sampler, get_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.training import (
        Checkpointer, FitConfig, TrainState, batch_iterator, fit,
        get_optimizer, make_continuous_score_train_step)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)

    torch.set_num_threads(os.cpu_count() or 1)
    launches = {}     # per path: kernel launches counted during that path

    # 1. device ---------------------------------------------------------------
    t = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    say("device", t, f"{kind} x{count}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvidia-smi: {smi}")
    print(smi, flush=True)

    # 2. build ----------------------------------------------------------------
    t = time.perf_counter()
    build = _build.build()
    ptxas = [line.strip() for line in build.log.splitlines()
             if "registers" in line or "Compiling entry" in line
             or "spill" in line]
    say("build", t, f"nvcc {build.seconds:.2f} s "
        f"({'reused' if build.seconds == 0.0 else 'built'}) -> {build.path}")
    for line in ptxas:
        print(f"    {line}", flush=True)

    # 3. kernels --------------------------------------------------------------
    t = time.perf_counter()
    cfg = get_continuous_config(CONFIG)
    k = tuple(cfg.model.fir_kernel)
    gen = torch.Generator().manual_seed(0)
    rows = {"up2x": [], "down2x": []}
    rows8 = {"up2x": [], "down2x": []}
    with float32_exact():
        for name, C, R in fir_shapes(cfg):
            rows[name].append(kernel_numbers(name, C, R, k, fk, gen, BATCH))
        for name, C, R in fir_shapes(cfg):
            rows8[name].append(kernel_numbers(name, C, R, k, fk, gen,
                                              TRAIN_BATCH))
    summary = summarize(rows, f"one forward at batch {BATCH}")
    summary8 = summarize(rows8, f"one forward at batch {TRAIN_BATCH}")
    for name in rows:
        summary[name]["err"] = max(summary[name]["err"],
                                   summary8[name]["err"])
    host_us = host_us_per_launch(fk, k, fir_shapes(cfg))
    say("kernels", t, f"K1/K2 match their plain versions at all "
        f"{sum(len(r) for r in rows.values())} shapes of a forward, at batch "
        f"{BATCH} and at batch {TRAIN_BATCH} (max_abs_err at batch "
        f"{TRAIN_BATCH} { {n: s['err'] for n, s in summary8.items()} }; rtol "
        f"{KERNEL_RTOL}); host us per launch at the smallest shape "
        f"{json.dumps(host_us)}")

    t = time.perf_counter()
    bwd_rows = {"up2x.bwd": [], "down2x.bwd": []}
    with float32_exact():
        for name, C, R in bwd_shapes(cfg):
            bwd_rows[name].append(kernel_numbers(name, C, R, k, fk, gen,
                                                 TRAIN_BATCH))
    summary.update(summarize(bwd_rows, "one training step's backward"))
    per_step_bwd = {name: len(rs) for name, rs in bwd_rows.items()}
    say("kernels_bwd", t, f"K3 backward (K2 for up, K1 for down) matches "
        f"the plain transposes at all {sum(per_step_bwd.values())} shapes "
        f"of a training step, batch {TRAIN_BATCH} (rtol {KERNEL_RTOL}): "
        f"{per_step_bwd}")

    t = time.perf_counter()
    flr_in = []
    for shape in FLR_SHAPES:
        x = torch.randn(*shape, generator=gen).cuda()
        b = torch.randn(shape[-1], generator=gen).cuda()
        g = torch.randn(*shape, generator=gen).cuda()
        flr_in.append((shape, x, b, g))
    fl.LAUNCHES.clear()
    flr_out = []
    for shape, x, b, g in flr_in:           # the op, as a user calls it
        xg, bg = x.clone().requires_grad_(), b.clone().requires_grad_()
        y = fl.fused_leaky_relu_kernel(xg, bg)
        dx, db = torch.autograd.grad(y, (xg, bg), g)
        flr_out.append((y.detach(), dx, db))
    torch.cuda.synchronize()
    launches["flr_op"] = dict(fl.LAUNCHES)
    if launches["flr_op"] != {"flr_fwd": len(FLR_SHAPES),
                              "flr_bwd": len(FLR_SHAPES)}:
        raise AssertionError(f"K4 op launched {launches['flr_op']}")
    flr_rows = {"flr_fwd": [], "flr_bwd": []}
    for (shape, x, b, g), (y, dx, db) in zip(flr_in, flr_out):
        fwd, bwd = flr_numbers(shape, y, dx, db, x, b, g, fl,
                               fused_leaky_relu)
        flr_rows["flr_fwd"].append(fwd)
        flr_rows["flr_bwd"].append(bwd)
        for name, r in (("flr_fwd", fwd), ("flr_bwd", bwd)):
            print(f"    {name} {shape}: kernel_ms device {r['ms']:.4f} "
                  f"with host {r['ms_with_host']:.4f}, plain_ms "
                  f"{r['plain_ms']:.4f} library_ms: no single call, bound_us "
                  f"{1e3 * r['bound_ms']:.2f} ({r['bound_by']}) max_abs_err "
                  f"{r['err']:.3g}" + (f" (db {r['db_err']:.3g})"
                                       if "db_err" in r else ""), flush=True)
    for name, rs in flr_rows.items():
        tot = {key: sum(r[key] for r in rs) for key in
               ("ms", "ms_with_host", "plain_ms", "bound_ms", "bytes_ms",
                "ops_ms")}
        summary[name] = dict(tot, err=max(r["err"] for r in rs),
                             library_ms=None,
                             bound_by="bytes" if tot["bytes_ms"]
                             >= tot["ops_ms"] else "operations")
    del flr_in, flr_out
    say("flr", t, f"K4 forward, dx and db match the plain versions at "
        f"{len(FLR_SHAPES)} shapes (rtol {KERNEL_RTOL}); launches "
        f"{launches['flr_op']}")

    # 4. model ----------------------------------------------------------------
    t = time.perf_counter()
    model_cpu = seeded_weights(create_model(cfg), seed=0).eval()
    model = copy.deepcopy(model_cpu).cuda().eval()
    n_params = sum(p.numel() for p in model.parameters())
    size, ch = cfg.data.image_size, cfg.data.num_channels
    x = torch.rand(1, size, size, ch, generator=gen)
    sigma = torch.tensor([5.0])
    xc, sc = x.cuda(), sigma.cuda()
    with torch.no_grad(), float32_exact():
        fk.LAUNCHES.clear()
        out = model(xc, sc)
        torch.cuda.synchronize()
        fwd_launches = dict(fk.LAUNCHES)
        fwd_ms = cuda_ms(lambda: model(xc, sc), reps=5)
        ref = model_cpu(x, sigma)
    # Batch 2 in the float32 mode, where cuDNN's heuristics alone would
    # pick the FFT convolution: card vs CPU, and the forward's time.
    xe = torch.rand(BATCH, size, size, ch, generator=gen)
    se = torch.tensor([5.0, 0.5])
    with torch.no_grad(), float32_exact():
        out_e = model(xe.cuda(), se.cuda())
        exact_b_ms = cuda_ms(lambda: model(xe.cuda(), se.cuda()), reps=5)
        rel_e = rel_l2(out_e.cpu(), model_cpu(xe, se))
    xb, sb = x.repeat(BATCH, 1, 1, 1).cuda(), sigma.repeat(BATCH).cuda()
    with torch.no_grad():
        fwd_b_ms, fwd_b_host_ms = cuda_ms(lambda: model(xb, sb), reps=5,
                                          host=True)
    rel = ((out.cpu() - ref).norm() / ref.norm()).item()
    per_forward = {name: len(rs) for name, rs in rows.items()}
    if fwd_launches != per_forward:
        raise AssertionError(f"one forward launched {fwd_launches}, "
                             f"expected {per_forward} (18 each at FFHQ-256)")
    if not (torch.isfinite(out).all() and rel <= MODEL_REL_L2
            and rel_e <= MODEL_REL_L2):
        raise AssertionError(f"card vs CPU forward: rel L2 {rel} (batch 1),"
                             f" {rel_e} (batch {BATCH})")
    w0 = {name: v.detach().clone() for name, v in model_cpu.state_dict()
          .items()}
    del model_cpu, ref
    say("model", t, f"{CONFIG} NCSN++ {n_params} params, batch 1: card vs "
        f"CPU rel L2 {rel:.3g} (<= {MODEL_REL_L2}); forward {fwd_ms:.2f} ms "
        f"on the card, TF32 off; launches {fwd_launches}. Batch {BATCH}, "
        f"float32 mode (cuDNN benchmark on): card vs CPU rel L2 {rel_e:.3g},"
        f" forward {exact_b_ms:.2f} ms. Batch {BATCH}, torch defaults: "
        f"forward {fwd_b_ms:.2f} ms on the card, {fwd_b_host_ms:.2f} ms on "
        f"the host to enqueue it")

    # 5. sample ---------------------------------------------------------------
    t = time.perf_counter()
    save_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        torch.cuda.reset_peak_memory_stats()
        fk.LAUNCHES.clear()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        samples, nfe, _ = run_pc_sampling(pc_sampling, [
            "--config", CONFIG, "--num_samples", str(BATCH), "--seed", "0",
            "--override", f"model.num_scales={NUM_SCALES}",
            "--save_dir", save_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches["sample"] = dict(fk.LAUNCHES)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated()
    # Each evaluation launches each kernel per_forward times: the counts
    # hold the printed nfe to 2 per step (reverse diffusion + Langevin).
    expect = {name: n * NUM_SCALES * 2 for name, n in per_forward.items()}
    if nfe != NUM_SCALES * 2:
        raise AssertionError(f"nfe {nfe} != {NUM_SCALES * 2}")
    if launches["sample"] != expect:
        raise AssertionError(f"sampling launched {launches['sample']}, "
                             f"expected {expect}: each kernel's calls per "
                             "forward times nfe")
    if samples.shape != (BATCH, size, size, ch) or not np.isfinite(
            samples).all():
        raise AssertionError(f"samples {samples.shape}, finite "
                             f"{np.isfinite(samples).all()}")
    say("sample", t, f"pc_sampling.main {CONFIG} num_scales {NUM_SCALES} "
        f"(reduced from 2000), {BATCH} samples, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}: nfe {nfe}, wall {wall:.2f} s "
        f"(model set-up included), {nfe / wall:.2f} net evals/s, peak memory "
        f"{peak / 2**30:.2f} GiB, launches {launches['sample']}")

    t = time.perf_counter()
    tiny = cfg.replace(**{"data.image_size": 16, "model.nf": 16,
                          "model.ch_mult": (1, 2, 2),
                          "model.num_res_blocks": 1,
                          "model.attn_resolutions": (8,),
                          "model.num_scales": 5})
    sde = make_sde(tiny)
    finals = []
    for device in ("cuda", "cpu"):
        net = seeded_weights(create_model(tiny), seed=1).to(device).eval()
        noise_gen = torch.Generator().manual_seed(2)
        sampler = get_pc_sampler(sde, (BATCH, 16, 16, 3),
                                 snr=tiny.sampling.snr, device=device)
        with torch.no_grad(), float32_exact():
            x, _ = sampler(get_score_fn(sde, net), noise=lambda s: torch.randn(
                tuple(s), generator=noise_gen).to(device))
        finals.append(x.cpu())
    rel = ((finals[0] - finals[1]).norm() / finals[1].norm()).item()
    if not rel <= MODEL_REL_L2:
        raise AssertionError(f"tiny PC run, card vs CPU: rel L2 {rel}")
    say("sample_ref", t, f"tiny PC run (16x16, N 5) card vs CPU, same noise: "
        f"rel L2 {rel:.3g} (<= {MODEL_REL_L2})")

    # 6. train ----------------------------------------------------------------
    t = time.perf_counter()
    sde = make_sde(cfg)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        model.train()
        state = TrainState.create(model, get_optimizer(cfg),
                                  ema_decay=cfg.model.ema_rate)
        step = make_continuous_score_train_step(
            model, sde, reduce_mean=cfg.training.reduce_mean)
        data = np.random.RandomState(0).rand(
            TRAIN_BATCH * TRAIN_STEPS, size, size, ch).astype(np.float32)
        watch = "conv_in.bias"
        losses, seconds, history = [], [], []

        def recorded_step(state, batch, generator):
            t_step = time.perf_counter()
            state, loss = step(state, batch, generator)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t_step)
            losses.append(float(loss))
            history.append(state.params[watch].detach().double().cpu())
            return state, loss

        torch.cuda.reset_peak_memory_stats()
        fk.LAUNCHES.clear()
        fl.LAUNCHES.clear()
        state = fit(state, recorded_step,
                    batch_iterator(data, TRAIN_BATCH, seed=0),
                    FitConfig(n_epochs=1, max_steps=TRAIN_STEPS, log_every=1,
                              seed=0, log_dir=log_dir))
        torch.cuda.synchronize()
        launches["train"] = dict(fk.LAUNCHES)
        train_peak = torch.cuda.max_memory_allocated()
        ckpt_dir = os.path.join(log_dir, "ckpts")
        ckpt_steps = Checkpointer(ckpt_dir, track_best=False).all_steps()

        decay = cfg.model.ema_rate
        ema = w0[watch].double()
        for p in history:
            ema = decay * ema + (1 - decay) * p
        ema_err = (state.ema.params[watch].double().cpu() - ema).abs().max()
        moved = (state.params["conv_in.weight"].detach().cpu()
                 - w0["conv_in.weight"]).abs().max().item()
        expect = {name: n * TRAIN_STEPS for name, n in
                  {**per_forward, **per_step_bwd}.items()}
        if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()):
            raise AssertionError(f"losses {losses}")
        if state.step != TRAIN_STEPS or ckpt_steps != [TRAIN_STEPS]:
            raise AssertionError(f"step {state.step}, checkpoints "
                                 f"{ckpt_steps}")
        if not moved > 0:
            raise AssertionError("training left conv_in.weight unchanged")
        if not ema_err <= 1e-6 * ema.abs().max():
            raise AssertionError(f"EMA of {watch} off its formula by "
                                 f"{ema_err}")
        if launches["train"] != expect or sum(fl.LAUNCHES.values()):
            raise AssertionError(f"training launched {launches['train']}, "
                                 f"expected {expect}")
        step_s = float(np.mean(seconds[1:]))
        say("train", t, f"fit, {CONFIG} full width, batch {TRAIN_BATCH} "
            f"(reduced from 64, the leaf's batch), Adam lr {cfg.optim.lr} "
            f"grad_clip {cfg.optim.grad_clip}, ema {decay}, reduce_mean "
            f"{cfg.training.reduce_mean}, cuDNN TF32 "
            f"{torch.backends.cudnn.allow_tf32}: {TRAIN_STEPS} steps, losses "
            f"{[round(v, 2) for v in losses]}; {step_s:.4f} s per step (first "
            f"step {seconds[0]:.2f} s excluded), {TRAIN_BATCH / step_s:.2f} "
            f"images/s, peak memory {train_peak / 2**30:.2f} GiB; EMA of "
            f"{watch} off its formula by {ema_err:.3g}; checkpoint "
            f"{ckpt_steps}; launches {launches['train']} ({TRAIN_STEPS} "
            f"steps)")
        del state, step, model
        torch.cuda.empty_cache()

        # 7. train_parity ---------------------------------------------------
        t = time.perf_counter()
        pgen = torch.Generator().manual_seed(3)
        x1 = torch.rand(1, size, size, ch, generator=pgen)
        t1 = torch.rand(1, generator=pgen) * (sde.T - 1e-5) + 1e-5
        z1 = torch.randn(1, size, size, ch, generator=pgen)
        results = []
        with float32_exact():
            for device in ("cuda", "cpu"):
                net = create_model(cfg)
                net.load_state_dict(w0)
                net.to(device)
                st = TrainState.create(net, get_optimizer(cfg),
                                       ema_decay=None)
                stp = make_continuous_score_train_step(
                    net, sde, reduce_mean=cfg.training.reduce_mean)
                _, loss = stp(st, x1, t=t1.to(device), z=z1.to(device))
                grads = torch.cat([p.grad.reshape(-1).cpu() for p in
                                   net.parameters() if p.grad is not None])
                results.append((loss.item(), grads))
                del net, st, stp
        (loss_gpu, g_gpu), (loss_cpu, g_cpu) = results
        loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        grad_rel = rel_l2(g_gpu, g_cpu)
        if not (loss_rel <= MODEL_REL_L2 and grad_rel <= MODEL_REL_L2):
            raise AssertionError(f"train step card vs CPU: loss rel "
                                 f"{loss_rel}, gradient rel L2 {grad_rel}")
        say("train_parity", t, f"one train step, full width, batch 1, TF32 "
            f"off, same weights, batch, t and z: loss card {loss_gpu:.6f} "
            f"CPU {loss_cpu:.6f} (rel {loss_rel:.3g}); gradients (clipped, "
            f"{g_cpu.numel()} entries) rel L2 {grad_rel:.3g} (<= "
            f"{MODEL_REL_L2})")

        # 8. sample_ckpt ----------------------------------------------------
        t = time.perf_counter()
        save_dir = os.path.join(log_dir, "samples")
        fk.LAUNCHES.clear()
        samples, nfe, text = run_pc_sampling(pc_sampling, [
            "--config", CONFIG, "--num_samples", str(BATCH), "--seed", "0",
            "--ckpt_dir", ckpt_dir, "--override",
            f"model.num_scales={CKPT_NUM_SCALES}", "--save_dir", save_dir])
        torch.cuda.synchronize()
        launches["sample_ckpt"] = dict(fk.LAUNCHES)
        expect = {name: n * CKPT_NUM_SCALES * 2
                  for name, n in per_forward.items()}
        if f"restored step {TRAIN_STEPS} from" not in text:
            raise AssertionError("pc_sampling printed no restored step "
                                 f"{TRAIN_STEPS}")
        if samples.shape != (BATCH, size, size, ch) or not np.isfinite(
                samples).all() or launches["sample_ckpt"] != expect or \
                nfe != CKPT_NUM_SCALES * 2:
            raise AssertionError(f"samples {samples.shape}, finite "
                                 f"{np.isfinite(samples).all()}, launches "
                                 f"{launches['sample_ckpt']}, nfe {nfe}")
        say("sample_ckpt", t, f"pc_sampling.main --ckpt_dir (the train "
            f"phase's checkpoint, EMA weights) num_scales {CKPT_NUM_SCALES}: "
            f"restored step {TRAIN_STEPS}, nfe {nfe}, finite samples "
            f"{samples.shape}, launches {launches['sample_ckpt']}")
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)

    kernels = []
    for name in ("up2x", "down2x", "up2x.bwd", "down2x.bwd", "flr_fwd",
                 "flr_bwd"):
        s = summary[name]
        by_path = {path: counts[name] for path, counts in launches.items()
                   if counts.get(name)}
        kernels.append({
            "name": name if name.startswith("flr") else f"fir_{name}",
            "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": s["err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"],
            "ms_with_host": s["ms_with_host"]})
        if name in summary8:
            s8 = summary8[name]
            kernels[-1][f"batch{TRAIN_BATCH}"] = {
                key: s8[key] for key in ("ms", "ms_with_host", "plain_ms",
                                         "library_ms", "bound_ms")}
        if name in host_us:
            kernels[-1]["host_us_per_launch"] = host_us[name]
    say("total", t0, "all phases passed")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()

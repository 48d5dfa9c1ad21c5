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
9. ncsnv2: the ACDC config's NCSNv2Deepest at full width (256 px, ngf
   128, 94.1 M parameters, weights drawn from seed 0) through
   make_score_fn on channel-last x, as the reconstruction calls it: card
   against CPU at batch 2 in the float32 mode, then the forward at batch
   32 (the reconstruction's) with torch's defaults and in bf16: device ms,
   host ms, peak memory; beside them the same forwards on the bare
   permute of x, which torch runs in NHWC, and in a channels-last net.
10. recon: samplers.ald_pair.make_stepped_pair_reconstructor at bench.py's
   geometry (16 chains, 4 coils, R = 8, the ladder cut to 8 of 2311
   levels, 3 inner steps, CG 4, lr_scaled 5.0, denoising), the net in
   float32 (torch's defaults) and in bf16: one warm-up and 3 timed runs,
   each ended by a host read; chain-steps/s from the fastest, peak memory,
   finite outputs; one level step timed and profiled (top device kernels
   and operators, launches per inner step, the device's idle share); bf16
   against float32; one chain on the card against the CPU, same noise,
   float32 mode: the score at the first and last levels, the proximal's
   correction at the step's c and at c = 1, and a whole inner step at the
   first and last levels.
11. serve: the serving entry point at the recon geometry, for f32 and
   bf16: scripts.serve_recon.build_engine (weights from seed 0), the
   engine's warm-up, 3 requests over HTTP on 127.0.0.1 (npz in and out:
   the default operator; a new R = 8 mask with lr_scaled 3.0; new coil
   maps) and one in-process request: shapes, finite values, headers,
   /healthz's request count, one input signature, chain-steps/s per
   request, warm-up seconds, peak memory; the f32 engine against
   make_stepped_pair_reconstructor on the same problem and seed in the
   float32 mode; a guided bf16 engine (the full-width seg UNet, seed 0) on
   a disk label, one request over HTTP and one in-process; card against
   CPU on one chain: a guided inner step at the last level (float32
   mode), the guidance gradient in float64, and the card's float32
   gradient against the float64 one.
12. cine: the 2D+time serving path at README's cine geometry (CINE127,
   128 px, T = 24, 4 coils, per-frame R = 8 masks; spatial NCSNv2Deepest
   and temporal NCSN1D on 8 x 8 pixel tubes, ngf 128 each, seed 0; 4
   chains, the ladder cut to 8 of 1000 levels), for f32 and bf16:
   scripts.serve_recon.build_engine --workload cine, its warm-up, 3
   requests over HTTP (default operator; new per-frame masks with
   lr_scaled 3.0; new coil maps) and one in-process with lamda_T 0.5:
   shapes, finite values, headers, /healthz, one input signature,
   chain-steps/s, warm-up, peak memory, the host's seconds for a
   request's operator and (T, W, W) normal kernel; the f32 engine against
   make_stepped_2d_time_pair_reconstructor (same card, TF32); bf16
   against f32; a level step with a temporal step split by CUDA events into the
   spatial net, the temporal step and net, the proximal and the rest,
   and profiled; card against CPU: the full-width NCSN1D and one inner
   step on one chain, random shift off and on. Phases 9 to 12
   launch none of K1, K2 or K4 (checked).

Every comparison with a plain or CPU version runs in the port's float32
mode (utils/precision.float32_exact: TF32 off for cuDNN and matmul, cuDNN
benchmark mode on, since its heuristics would pick an FFT convolution at
batch >= 2; PERF.md), so the card computes in float32 like the reference.
The sampling and training runs themselves use torch's defaults, as a
user's run does: cuDNN convolutions in TF32. Launch counts are cleared just
before each path (sample, train, sample_ckpt, the K4 op, ncsnv2, recon,
serve, cine) and read just after it. Any failure raises and exits non-zero.
Phases 9 to 12 print their numbers as one JSON line before `total`. The last
lines are nvidia-smi's name and power limit, a JSON line of per-kernel
numbers, and
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
BF16_REL_L2 = 1e-2         # bf16 net vs float32, whole reconstruction: the
                           # score's bf16 error (about 1e-2) enters scaled
                           # by the step beside the shared injected noise
ENGINE_REL_L2 = 1e-5       # serving engine vs the direct reconstructor: the
                           # same operations on the card (ACDC in the
                           # float32 mode, cine in torch's defaults)
SEG_F64_REL_L2 = 1e-10     # the seg guidance gradient card vs CPU, float64
SEG_F32_REL_L2 = 5e-3      # the card's float32 seg gradient vs float64:
                           # float32 loses up to about 3e-3 in the UNet's
                           # instance norms (PERF.md); TF32 about 3e-2
TRAIN_BATCH = 8            # the leaf's 64, reduced
TRAIN_STEPS = 6
CKPT_NUM_SCALES = 10
FLR_SHAPES = [(8 * 256 * 256, 128), (8 * 16 * 16, 256), (7 * 5 * 5, 3)]
# The ACDC SENSE ALD reconstruction at bench.py's geometry (bench.py:232-272)
ACDC_CHAINS = 16           # the net runs at batch 32: Re and Im interleaved
ACDC_COILS = 4
ACDC_R = 8
ACDC_LEVELS = 8            # of the config's 2311
ACDC_CG_ITERS = 4
ACDC_LR_SCALED = 5.0
ACDC_REPS = 3              # timed runs after one warm-up; the fastest counts
# The cine (2D+time) serving path: README's 128 px, T = 24, 4 coils, R = 8
CINE_FRAMES = 24
CINE_CHAINS = 4            # the CineEngineSpec default; serve_recon's is 16
CINE_LEVELS = 8            # of the config's 1000
CINE_WIN = 8               # 8 x 8 pixel tubes: the temporal net's 64 channels
CINE_LAMDA_T = 0.5         # the in-process request's temporal weight
CINE_CHECK_LEVEL = 1       # the first level with a temporal step
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


def acdc_model(seed: int = 0):
    """The ACDC config (configs/acdc.yml in the JAX package) and its
    NCSNv2Deepest at full width, weights drawn from `seed`, on the CPU."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models import (
        NCSNv2Deepest)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
        seeded_weights)
    cfg = load_config("ACDC", "real-imag")
    return cfg, seeded_weights(NCSNv2Deepest(cfg), seed=seed).eval()


def no_kernel_launches(fk, fl, what: str) -> None:
    """The ACDC path runs none of K1, K2 or K4."""
    counts = {**fk.LAUNCHES, **fl.LAUNCHES}
    if any(counts.values()):
        raise AssertionError(f"{what} launched FIR/FLR kernels: {counts}")


def ncsnv2_phase(fk, fl, device="cuda") -> dict:
    """NCSNv2Deepest at full width (256 px, ngf 128) through
    models/registry.make_score_fn on channel-last (B, 256, 256, 1) input,
    as the reconstruction calls it: card against CPU at batch 2 (the
    ladder's first and last levels) in the float32 mode, then device ms at
    batch 32 (the reconstruction's) with torch's defaults and in bf16, and
    the peak memory of those calls. For the record, the same forwards in
    two other layouts: the bare permute of x, whose channels-last strides
    make torch run the net in NHWC against NCHW weights, and that view
    into the net converted to channels-last."""
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        make_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        sigma_ladder)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg, model_cpu = acdc_model()
    model = copy.deepcopy(model_cpu).to(device)
    sigmas = sigma_ladder(cfg.model.sigma_begin, cfg.model.sigma_end,
                          ACDC_LEVELS, "geometric")
    size = cfg.data.image_size
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(BATCH, size, size, 1, generator=gen)
    labels = torch.tensor([0, ACDC_LEVELS - 1])
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    with torch.inference_mode(), float32_exact():
        out = make_score_fn(model, sigmas)(x.to(device),
                                           labels.to(device)).cpu()
        ref = make_score_fn(model_cpu, sigmas)(x, labels)
    no_kernel_launches(fk, fl, "the NCSNv2Deepest forward")
    rel = rel_l2(out, ref)
    if not (torch.isfinite(out).all() and rel <= MODEL_REL_L2):
        raise AssertionError(f"NCSNv2Deepest card vs CPU: rel L2 {rel}")
    del model_cpu, ref
    nb = 2 * ACDC_CHAINS
    xb = torch.rand(nb, size, size, 1, generator=gen).to(device)
    lb = (torch.arange(nb) % ACDC_LEVELS).to(device)
    numbers = dict(params=sum(p.numel() for p in model.parameters()),
                   rel_l2=rel)
    with torch.inference_mode():
        for dtype, name in ((None, "f32"), (torch.bfloat16, "bf16")):
            score = make_score_fn(model, sigmas, dtype)
            net = model if dtype is None else copy.deepcopy(model).to(dtype)
            sig = torch.as_tensor(sigmas, device=device).to(
                dtype or torch.float32)[lb]
            view = xb.to(dtype or torch.float32).permute(0, 3, 1, 2)
            net_cl = copy.deepcopy(net).to(memory_format=torch.channels_last)
            for key, fn in ((name, lambda: score(xb, lb)),
                            (f"{name}_nhwc_view", lambda: net(view, sig)),
                            (f"{name}_channels_last",
                             lambda: net_cl(view, sig))):
                fn()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms, host_ms = cuda_ms(fn, reps=5, host=True)
                numbers[key] = dict(ms=ms, host_ms=host_ms,
                                    peak=torch.cuda.max_memory_allocated())
            del score, net, net_cl
    return numbers


def acdc_problem(cfg, device):
    """bench.py's reconstruction problem (bench.py:85-97, 232-272): the
    pair SENSE with 4 real exponential coil maps and one R = 8
    variable-density line mask (seed 0), the measurement of 16 chains of
    uniform magnitude and normal phase (a torch.Generator seeded 0), the CG
    proximal on the normal kernel, and the ladder cut to 8 levels."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairL2Penalty, PairSENSE)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.sigmas import (
        sigma_ladder)
    size = cfg.data.image_size
    mask = generate_mask(1, size, seed=0, **MASK_PRESETS[ACDC_R])
    maps = np.stack([_exp_sens_map(size, size, i) for i in range(ACDC_COILS)])
    maps = maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
    sens = torch.tensor(maps[..., None], dtype=torch.float32)
    lin_tfm = PairSENSE(mask=torch.tensor(mask.reshape(1, 1, size, 1)),
                        sens_re=sens, sens_im=torch.zeros_like(sens)
                        ).to(device)
    gen = torch.Generator().manual_seed(0)
    shape = (ACDC_CHAINS, size, size, 1)
    mag = torch.rand(shape, generator=gen).to(device)
    phase = torch.randn(shape, generator=gen).to(device)
    with torch.inference_mode():
        yr, yi = lin_tfm(mag * torch.cos(phase), mag * torch.sin(phase))
    proximal = PairL2Penalty.with_normal_kernel(lin_tfm,
                                                num_iters=ACDC_CG_ITERS)
    sigmas = sigma_ladder(cfg.model.sigma_begin, cfg.model.sigma_end,
                          ACDC_LEVELS, "geometric")
    return lin_tfm, proximal, sigmas, yr, yi


def idle_share(prof, wall_us: float) -> float:
    """1 - (union of the device's kernel and copy intervals) / wall time."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return 1.0 - busy / wall_us


def recon_phase(fk, fl, device="cuda") -> dict:
    """make_stepped_pair_reconstructor at bench.py's geometry, float32
    (torch's defaults) and bf16 net: one warm-up, ACDC_REPS timed runs each
    ended by a host read of |xr|.sum() + |xi|.sum() (bench.py:365-369),
    chain-steps/s from the fastest, peak memory, finite outputs; one level
    step of the float32 run under torch.profiler; the first inner step on
    the card against the CPU, 1 chain, same noise, float32 mode."""
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_pair_reconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
        stack_parts)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg, model_cpu = acdc_model()
    model = copy.deepcopy(model_cpu)
    lin_tfm, proximal, sigmas, yr, yi = acdc_problem(cfg, device)
    n_steps = cfg.sampling.n_steps_each
    ald_cfg = ALDConfig(n_steps_each=n_steps, step_lr=cfg.sampling.step_lr)
    chain_steps = ACDC_LEVELS * n_steps * ACDC_CHAINS
    numbers, outputs = dict(n_steps=n_steps), {}
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        recon = make_stepped_pair_reconstructor(
            model, sigmas, lin_tfm, proximal, ald_cfg,
            lr_scaled=ACDC_LR_SCALED, compute_dtype=dtype, device=device)

        def run_fetch(seed):
            xr, xi = recon(yr, yi, seed=seed)
            return float(xr.abs().sum() + xi.abs().sum()), (xr, xi)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run_fetch(1)
        times = []
        for seed in range(2, 2 + ACDC_REPS):
            t_run = time.perf_counter()
            total, out = run_fetch(seed)
            times.append(time.perf_counter() - t_run)
        finite = all(bool(torch.isfinite(v).all()) for v in out)
        if not (finite and np.isfinite(total)):
            raise AssertionError(f"{name} reconstruction is not finite")
        outputs[name] = out
        numbers[name] = dict(
            seconds=times, chain_steps_per_s=chain_steps / min(times),
            peak=torch.cuda.max_memory_allocated(), finite=finite,
            abs_max=max(v.abs().max().item() for v in out))
        if name == "f32":
            numbers["profile"] = profile_level(recon, yr, yi, n_steps,
                                               device)
    no_kernel_launches(fk, fl, "the reconstruction")
    numbers["bf16_vs_f32_rel_l2"] = max(
        rel_l2(a, b) for a, b in zip(outputs["bf16"], outputs["f32"]))

    if not numbers["bf16_vs_f32_rel_l2"] <= BF16_REL_L2:
        raise AssertionError(f"bf16 reconstruction vs float32: rel L2 "
                             f"{numbers['bf16_vs_f32_rel_l2']}")

    # Card against CPU on the reconstruction's own tensors: one chain, the
    # float32 mode, the same injected noise. Parts: the score at the chain
    # start (the interleaved batch of 2, channel-last) at the first and the
    # last level; the proximal's correction prox(z) - z at the step's c
    # from z = 0 (from the z of a step the correction is about 1e-6 of
    # |z|, and float32's rounding of z, 6e-8 of |z|, moves it by percents
    # on either device) and at c = 1 from
    # z = the start plus level 0's noise, where A^H A moves x by about a
    # tenth and the normal kernel and the CG show; the whole inner step at
    # the first and the last level.
    one = ALDConfig(n_steps_each=1, step_lr=cfg.sampling.step_lr,
                    denoise=False)
    gen = torch.Generator().manual_seed(5)
    shape = (1,) + tuple(yr.shape[2:])
    draws = [torch.randn(shape, generator=gen) for _ in range(2)]
    last = ACDC_LEVELS - 1
    results = []
    with float32_exact():
        for dev, net in ((device, model), ("cpu", model_cpu)):
            recon = make_stepped_pair_reconstructor(
                net, sigmas, lin_tfm, proximal, one,
                lr_scaled=ACDC_LR_SCALED, device=dev)
            n_re, n_im = (d.to(dev) for d in draws)
            s0 = float(one.step_lr * (recon.sigmas[0] / recon.sigmas[-1]) ** 2)
            got = {}
            with torch.inference_mode():
                y1 = yr[:, :1].to(dev), yi[:, :1].to(dev)
                xr, xi, prox = recon.start(*y1)
                stacked = stack_parts(xr, xi)
                for c in (0, last):
                    got[f"score_level{c}"] = (recon.score_fn(
                        stacked, torch.full((2,), c, device=dev)),)
                    it = iter((n_re, n_im))
                    got[f"step_level{c}"] = recon.level_step(
                        prox, xr, xi, *y1, c, lambda s: next(it))
                zero = torch.zeros_like(xr)
                got["prox_step_c_from_0"] = prox(
                    zero, zero, *y1, one.step_lr * ACDC_LR_SCALED, 1.0)
                amp = (2 * s0) ** 0.5
                zr, zi = xr + amp * n_re, xi + amp * n_im
                pr, pi = prox(zr, zi, *y1, 1.0, 1.0)
                got["prox_c1_correction"] = (pr - zr, pi - zi)
            results.append({k: [v.cpu() for v in vs]
                            for k, vs in got.items()})
    card, cpu = results
    numbers["card_vs_cpu_rel_l2"] = checks = {
        k: max(rel_l2(a, b) for a, b in zip(card[k], cpu[k])) for k in card}
    failed = {k: v for k, v in checks.items() if not v <= MODEL_REL_L2}
    if failed:
        raise AssertionError(f"reconstruction card vs CPU: rel L2 {failed}")
    return numbers


def serve_argv(dtype: str) -> list:
    """scripts.serve_recon's flags for acdc_problem's geometry, weights
    drawn from seed 0 (no --ckpt_dir)."""
    return ["--ds_name", "ACDC", "--R", str(ACDC_R), "--num_sens",
            str(ACDC_COILS), "--synth_sens", "--chains", str(ACDC_CHAINS),
            "--levels", str(ACDC_LEVELS), "--lr_scaled", str(ACDC_LR_SCALED),
            "--prox_iters", str(ACDC_CG_ITERS), "--dtype", dtype, "--mode",
            "steps", "--seed", "0", "--device", "cuda"]


def disk_label(size: int) -> np.ndarray:
    """A (size, size) int map: 1 inside a centred disk of radius size / 4."""
    hh, ww = np.mgrid[0:size, 0:size] - (size - 1) / 2
    return (hh ** 2 + ww ** 2 <= (size / 4) ** 2).astype(np.int64)


def post_npz(url: str, **arrays):
    """POST an npz body; returns (the response's arrays, its headers, the
    client's wall seconds for the round trip)."""
    import urllib.request
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t_req = time.perf_counter()
    with urllib.request.urlopen(req) as r:
        body = r.read()
        headers = dict(r.headers)
    wall = time.perf_counter() - t_req
    with np.load(io.BytesIO(body), allow_pickle=False) as npz:
        out = {k: npz[k] for k in npz.files}
    return out, headers, wall


def serve_requests(eng, requests, chain_steps: int) -> dict:
    """Serve `eng` on 127.0.0.1 (a free port) and POST each (query,
    arrays) of `requests`: every response holds the six arrays at their
    shapes, finite, and both headers; then /healthz counts the requests.
    Per request: the engine's latency and chain-steps/s (headers) and the
    client's round trip."""
    import urllib.request
    from inverseproblemwithdiffusionmodel_tpu_torch.serving.server import (
        serve)
    s = eng.spec
    image = (s.height, s.width, s.channels)
    if hasattr(s, "frames"):                 # a cine engine: volumes
        image = (s.frames,) + image
    shapes = {"x_re": (s.chains,) + image, "x_im": (s.chains,) + image,
              "mean_re": image, "mean_im": image, "mean_mag": image,
              "std_mag": image}
    before = eng.stats()["requests"]
    httpd = serve(eng, "127.0.0.1", 0, background=True)
    rows = []
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for query, arrays in requests:
            out, headers, wall = post_npz(f"{base}/reconstruct?{query}",
                                          **arrays)
            got = {k: v.shape for k, v in out.items()}
            finite = {k: bool(np.isfinite(v).all()) for k, v in out.items()}
            if got != shapes or not all(finite.values()):
                raise AssertionError(f"response {query}: shapes {got}, "
                                     f"finite {finite}")
            if not {"X-Latency-S", "X-Chain-Steps-Per-S"} <= set(headers):
                raise AssertionError(f"response {query}: headers {headers}")
            rows.append(dict(
                query=query, latency_s=float(headers["X-Latency-S"]),
                chain_steps_per_s=float(headers["X-Chain-Steps-Per-S"]),
                client_s=wall, client_chain_steps_per_s=chain_steps / wall))
        with urllib.request.urlopen(f"{base}/healthz") as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    if health["requests"] != before + len(requests):
        raise AssertionError(f"/healthz counts {health['requests']} "
                             f"requests, expected {before + len(requests)}")
    return dict(requests=rows, healthz_requests=health["requests"])


def serve_phase(fk, fl, device="cuda") -> dict:
    """The serving entry point at acdc_problem's geometry: for f32 and bf16
    in turn, scripts.serve_recon.build_engine (weights from seed 0), its
    warm-up, 3 requests over HTTP on 127.0.0.1 (the default operator, seed
    0; a new R = 8 mask, seed 1, lr_scaled 3.0; new coil maps, seed 2) and
    one in-process request; one input signature over them; peak memory.
    The f32 engine against make_stepped_pair_reconstructor on
    acdc_problem's operator, same measurement and seed, float32 mode. A
    guided bf16 engine (the full-width seg UNet of load_general_config,
    seed 0, seg_lamda 1.0 from the first level) on a disk label: one
    request over HTTP and one in-process. Card against CPU on one chain:
    a guided inner step at the last level (float32 mode) and
    compute_seg_grad (float64; float32 against float64). None of K1, K2 or
    K4 launches."""
    import dataclasses
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        load_model, make_seg_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairL2Penalty)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig, compute_seg_grad)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_pair_reconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        serve_recon)
    from inverseproblemwithdiffusionmodel_tpu_torch.serving import (
        ReconstructionEngine)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.misc import (
        stack_parts)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg = load_config("ACDC", "real-imag")
    size = cfg.data.image_size
    lin_tfm, proximal, sigmas, yr, yi = acdc_problem(cfg, device)
    # the single-copy measurement of chain 0, as a client sends it
    y_re, y_im = (v[:, 0].cpu().numpy() for v in (yr, yi))
    mask1 = generate_mask(1, size, seed=1, **MASK_PRESETS[ACDC_R])
    maps = np.stack([_exp_sens_map(size, size, 10 + i)
                     for i in range(ACDC_COILS)])
    maps = (maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True)))[..., None]
    requests = [("seed=0", dict(y_re=y_re, y_im=y_im)),
                ("seed=1&lr_scaled=3.0", dict(y_re=y_re, y_im=y_im,
                                              mask=mask1)),
                ("seed=2", dict(y_re=y_re, y_im=y_im, sens_re=maps))]
    n_steps = cfg.sampling.n_steps_each
    chain_steps = ACDC_LEVELS * n_steps * ACDC_CHAINS
    numbers = dict(chain_steps=chain_steps)
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    for name in ("f32", "bf16"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        eng = serve_recon.build_engine(serve_recon.parse_args(
            serve_argv(name)))
        build_s = time.perf_counter() - t_build
        warmup_s = eng.warmup()
        served = serve_requests(eng, requests, chain_steps)
        res = eng.reconstruct(y_re, y_im, seed=3)
        # host work of a request outside the engine's latency: the normal
        # kernel (a W x W einsum) before it, the npz encoding after it
        t_host = time.perf_counter()
        PairL2Penalty.with_normal_kernel(eng.default_lin_tfm,
                                         num_iters=ACDC_CG_ITERS)
        kernel_s = time.perf_counter() - t_host
        t_host = time.perf_counter()
        np.savez(io.BytesIO(), **res.to_npz_dict())
        npz_s = time.perf_counter() - t_host
        stats = eng.stats()
        if stats["input_signatures"] != 1 or stats["requests"] != 4:
            raise AssertionError(f"{name} engine stats {stats}")
        if not (np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
            raise AssertionError(f"{name} in-process request not finite")
        numbers[name] = dict(
            build_s=build_s, warmup_s=warmup_s, **served,
            normal_kernel_s=kernel_s, npz_encode_s=npz_s,
            in_process=dict(latency_s=res.latency_s,
                            chain_steps_per_s=res.chain_steps_per_s),
            input_signatures=stats["input_signatures"],
            peak=torch.cuda.max_memory_allocated())
        if name == "f32":
            # the engine against the direct path on acdc_problem's
            # operator (built apart from serve_recon's), float32 mode
            ald_cfg = ALDConfig(n_steps_each=n_steps,
                                step_lr=cfg.sampling.step_lr)
            with float32_exact():
                ours = eng.reconstruct(y_re, y_im, seed=5)
                recon = make_stepped_pair_reconstructor(
                    eng.model, sigmas, lin_tfm, proximal, ald_cfg,
                    lr_scaled=ACDC_LR_SCALED, device=device)
                shape = (ACDC_COILS, ACDC_CHAINS) + tuple(yr.shape[2:])
                ref = recon(yr[:, :1].expand(shape).contiguous(),
                            yi[:, :1].expand(shape).contiguous(), seed=5)
            numbers["engine_vs_direct_rel_l2"] = max(
                rel_l2(torch.from_numpy(a), b.cpu())
                for a, b in zip((ours.x_re, ours.x_im), ref))
            if not numbers["engine_vs_direct_rel_l2"] <= ENGINE_REL_L2:
                raise AssertionError(
                    f"engine vs make_stepped_pair_reconstructor: rel L2 "
                    f"{numbers['engine_vs_direct_rel_l2']}")
            del recon, ref
            del eng
            continue
        # the guided bf16 engine: the bf16 engine's net and operator, and
        # the full-width seg UNet
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seg_cpu, _ = load_model(None, "Seg", seed=0)
        label = disk_label(size)
        spec = dataclasses.replace(eng.spec, seg_lamda=1.0,
                                   seg_start_time=0.0)
        t_build = time.perf_counter()
        guided = ReconstructionEngine(
            eng.model, eng.sigmas, spec=spec,
            mask=eng.default_lin_tfm.mask.cpu().numpy(),
            sens_re=eng.default_lin_tfm.sens_re.cpu().numpy(),
            seg_model=copy.deepcopy(seg_cpu), device=device)
        build_s = time.perf_counter() - t_build
        warmup_s = guided.warmup()
        served = serve_requests(guided, [("seed=0", dict(
            y_re=y_re, y_im=y_im, seg_label=label))], chain_steps)
        res = guided.reconstruct(y_re, y_im, seed=3, seg_label=label)
        if not (np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
            raise AssertionError("guided in-process request not finite")
        numbers["guided_bf16"] = dict(
            build_s=build_s, warmup_s=warmup_s, **served,
            in_process=dict(latency_s=res.latency_s,
                            chain_steps_per_s=res.chain_steps_per_s),
            input_signatures=guided.stats()["input_signatures"],
            peak=torch.cuda.max_memory_allocated(),
            seg_params=sum(p.numel() for p in seg_cpu.parameters()))
        seg_dev = guided.seg_model
        del guided, eng
    no_kernel_launches(fk, fl, "the serving phase")
    torch.cuda.empty_cache()

    # Card against CPU, one chain. The guided inner step at the last level
    # (the ramp's weight is 0 at the first level and 1 at the last), float32
    # mode. The guidance gradient at the chain's start, on the same input
    # on both devices: in float64 (the same function), and each device's
    # float32 gradient against the CPU's float64 one. In float32 the
    # gradient loses digits in the backward through the UNet's instance
    # norms, 4e-4 to 3e-3 on the card and up to 8e-4 on the CPU at 256 px
    # (PERF.md), so the card's float32 gradient is held to the
    # float64 one at SEG_F32_REL_L2, not to the CPU's float32 result.
    _, model_cpu = acdc_model()
    model = copy.deepcopy(model_cpu).to(device)
    one = ALDConfig(n_steps_each=1, step_lr=cfg.sampling.step_lr,
                    denoise=False)
    gen = torch.Generator().manual_seed(6)
    draws = [torch.randn((1,) + tuple(yr.shape[2:]), generator=gen)
             for _ in range(2)]
    label1 = torch.from_numpy(label)[None]
    last = ACDC_LEVELS - 1
    steps = []
    with float32_exact():
        for dev, net, seg in ((device, model, seg_dev),
                              ("cpu", model_cpu, seg_cpu)):
            recon = make_stepped_pair_reconstructor(
                net, sigmas, lin_tfm, proximal, one,
                lr_scaled=ACDC_LR_SCALED, seg_fn=make_seg_fn(seg),
                seg_label=label1, seg_lamda=1.0, seg_start_time=0.0,
                device=dev)
            with torch.no_grad():
                y1 = yr[:, :1].to(dev), yi[:, :1].to(dev)
                xr, xi, prox = recon.start(*y1)
                it = iter(d.to(dev) for d in draws)
                steps.append([v.cpu() for v in recon.level_step(
                    prox, xr, xi, *y1, last, lambda s: next(it))])
        # the chain's start on the CPU (the last loop pass), both labels
        stacked = stack_parts(xr, xi)
        label2 = recon.seg_label2
        grads = {}
        for dev, seg in ((device, seg_dev), ("cpu", seg_cpu)):
            for dtype in (torch.float32, torch.float64):
                net = copy.deepcopy(seg).to(dev, dtype)
                grads[dev, dtype] = compute_seg_grad(
                    make_seg_fn(net), stacked.to(dev, dtype),
                    label2.to(dev)).cpu()
                del net
    exact = grads["cpu", torch.float64]
    checks = {
        f"guided_step_level{last}": max(rel_l2(a, b) for a, b in
                                        zip(*steps)),
        "seg_grad_f64": rel_l2(grads[device, torch.float64], exact),
        "seg_grad_f32_card_vs_f64": rel_l2(grads[device, torch.float32],
                                           exact),
        "seg_grad_f32_cpu_vs_f64": rel_l2(grads["cpu", torch.float32],
                                          exact),
        "seg_grad_f32_card_vs_cpu": rel_l2(grads[device, torch.float32],
                                           grads["cpu", torch.float32])}
    numbers["guided_card_vs_cpu_rel_l2"] = checks
    if not (checks[f"guided_step_level{last}"] <= MODEL_REL_L2
            and checks["seg_grad_f64"] <= SEG_F64_REL_L2
            and checks["seg_grad_f32_card_vs_f64"] <= SEG_F32_REL_L2):
        raise AssertionError(f"guided card vs CPU: rel L2 {checks}")
    return numbers


def cine_argv(dtype: str) -> list:
    """scripts.serve_recon's flags for the cine phase: README's cine
    geometry, spatial NCSNv2Deepest (CINE127) and temporal NCSN1D
    (CINE127_1D), weights drawn from seed 0 (no --ckpt_dir)."""
    return ["--workload", "cine", "--ds_name", "CINE127", "--ds_name_T",
            "CINE127_1D", "--mode_T", "diffusion1d", "--frames",
            str(CINE_FRAMES), "--win_size", str(CINE_WIN), "--R", "8",
            "--num_sens", "4", "--synth_sens", "--chains", str(CINE_CHAINS),
            "--levels", str(CINE_LEVELS), "--dtype", dtype, "--mode", "steps",
            "--seed", "0", "--device", "cuda"]


def cine_problem(size: int, frames: int, coils: int = 4):
    """serve_recon's default cine operator for --seed 0 (per-frame R = 8
    masks, 4 synthetic coil maps) and one cine measurement of it, a
    single copy as a client sends it: frames of uniform magnitude and
    normal phase (a torch.Generator seeded 0). Returns the mask (T, 1, W,
    1), the maps (coils, H, W, 1) and y_re, y_im (coils, T, H, W)."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairSENSE)
    mask = generate_mask(frames, size, seed=0, **MASK_PRESETS[8]).reshape(
        frames, 1, size, 1)
    maps = np.stack([_exp_sens_map(size, size, i) for i in range(coils)])
    maps = (maps / np.sqrt((maps ** 2).sum(axis=0, keepdims=True))
            )[..., None].astype(np.float32)
    sens = torch.tensor(maps)
    lin = PairSENSE(mask=torch.tensor(mask), sens_re=sens,
                    sens_im=torch.zeros_like(sens))
    gen = torch.Generator().manual_seed(0)
    shape = (frames, size, size, 1)
    mag, phase = torch.rand(shape, generator=gen), torch.randn(
        shape, generator=gen)
    yr, yi = lin(mag * torch.cos(phase), mag * torch.sin(phase))
    return mask, maps, yr[..., 0].numpy(), yi[..., 0].numpy()


def cine_tiled(mask, maps, y_re, y_im, chains: int, device):
    """The operator, proximal and measurement of `chains` chains: the
    per-frame mask and the measurement tiled over the chains x frames
    axis, as the cine engine tiles them."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.pair import (
        PairL2Penalty, PairSENSE)
    sens = torch.tensor(maps)
    lin = PairSENSE(mask=torch.tensor(np.tile(mask, (chains, 1, 1, 1))),
                    sens_re=sens, sens_im=torch.zeros_like(sens)).to(device)
    prox = PairL2Penalty.with_normal_kernel(lin, num_iters=4)
    tile = lambda y: torch.tensor(y)[:, None, ..., None].expand(
        (y.shape[0], chains) + y.shape[1:] + (1,)).flatten(1, 2).to(device)
    return lin, prox, tile(y_re), tile(y_im)


class PhaseTimer:
    """CUDA events around each call of wrapped functions, summed per name
    after a synchronize: the device time of each part of a level step (the
    stream is busy throughout, the host enqueues ahead of it)."""

    def __init__(self):
        self.events = {}

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return timed

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in pairs)
                for name, pairs in self.events.items()}


def profile_cine_level(eng, y_re, y_im, device) -> dict:
    """One level step of the engine's chain at CINE_CHECK_LEVEL (a level
    with a temporal step), torch's defaults: its device ms split by CUDA
    events into the spatial net (make_score_fn, its NCHW view and casts),
    the temporal step (apply_in_tube_space: the tube reshapes, the roll,
    the tube Langevin updates and the temporal net), the temporal net
    alone (its (B', T, C) <-> (B', C, T) copies included), the proximal
    (CG), and the rest (the frames' Langevin updates and the Re/Im
    interleaves); then profile_level's profiler numbers for the same
    step."""
    from inverseproblemwithdiffusionmodel_tpu_torch.operators import (
        finite_diff)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers import ald_pair
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
        gaussian_noise)
    s = eng.spec
    yr, yi = (eng._broadcast_chains(eng._canon_measurement(v))
              for v in (y_re, y_im))
    recon = eng._reconstructor(eng.default_lin_tfm,
                               eng._build_proximal(eng.default_lin_tfm),
                               s.lr_scaled, s.lamda_T)
    timer = PhaseTimer()
    split = copy.copy(recon)
    split.inner = ald_pair._pair_2d_time_inner(
        timer.wrap("spatial_net", eng._score_S),
        timer.wrap("temporal_net", eng._score_T), finite_diff.FiniteDiff(1),
        recon.config, s.mode_T, s.win_size, recon.sigmas[-1],
        recon.sigmas_T[-1])
    noise = gaussian_noise(7, device)
    tubes = ald_pair.apply_in_tube_space
    with torch.inference_mode():
        xr, xi, prox = recon.start(yr, yi)
        split.level_step(prox, xr, xi, yr, yi, CINE_CHECK_LEVEL, noise)
        timer.events.clear()
        ald_pair.apply_in_tube_space = timer.wrap("temporal_step", tubes)
        try:
            timer.wrap("level", split.level_step)(
                timer.wrap("proximal", prox), xr, xi, yr, yi,
                CINE_CHECK_LEVEL, noise)
        finally:
            ald_pair.apply_in_tube_space = tubes
    ms = timer.ms()
    ms["tube_reshapes_and_langevin"] = ms["temporal_step"] - ms["temporal_net"]
    ms["frame_langevin_and_rest"] = ms["level"] - sum(
        ms[k] for k in ("spatial_net", "temporal_step", "proximal"))
    return dict(split_ms=ms, **profile_level(recon, yr, yi, s.n_steps_each,
                                             device, CINE_CHECK_LEVEL))


def cine_phase(fk, fl, device="cuda") -> dict:
    """The cine serving path at README's geometry (CINE127 frames, 128 px,
    T = 24, 4 coils, per-frame R = 8 masks; spatial NCSNv2Deepest ngf 128,
    temporal NCSN1D ngf 128 on 8 x 8 tubes; 4 chains, the ladder cut to 8
    of 1000 levels): for f32 and bf16 in turn, scripts.serve_recon.
    build_engine --workload cine (weights from seed 0), its warm-up, 3
    requests over HTTP on 127.0.0.1 (the default operator, seed 0; new
    per-frame R = 8 masks, seed 1, lr_scaled 3.0; new coil maps, seed 2)
    and one in-process request with lamda_T 0.5 (the f32 engine's against
    make_stepped_2d_time_pair_reconstructor on the same problem and seed,
    both in torch's defaults; bf16 against it); one input signature; the
    host's seconds for a request's operator and normal kernel; peak
    memory. A profiled level step of the f32 engine. The full-width
    NCSN1D forward and one inner step at a temporal level (one chain,
    shift off and on, the same injected noise and shift) card against
    CPU in the float32 mode. None of K1, K2 or K4 launches."""
    from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
    from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
        make_score_fn)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.fourier import (
        MASK_PRESETS, _exp_sens_map)
    from inverseproblemwithdiffusionmodel_tpu_torch.operators.masks import (
        generate_mask)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald import (
        ALDConfig)
    from inverseproblemwithdiffusionmodel_tpu_torch.samplers.ald_pair import (
        make_stepped_2d_time_pair_reconstructor)
    from inverseproblemwithdiffusionmodel_tpu_torch.scripts import (
        serve_recon)
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.precision import (
        float32_exact)
    cfg = load_config("CINE127", "real-imag")
    size, T = cfg.data.image_size, CINE_FRAMES
    mask, maps, y_re, y_im = cine_problem(size, T)
    mask1 = generate_mask(T, size, seed=1, **MASK_PRESETS[8]).reshape(
        T, 1, size, 1)
    maps2 = np.stack([_exp_sens_map(size, size, 10 + i) for i in range(4)])
    maps2 = (maps2 / np.sqrt((maps2 ** 2).sum(axis=0, keepdims=True))
             )[..., None]
    requests = [("seed=0", dict(y_re=y_re, y_im=y_im)),
                ("seed=1&lr_scaled=3.0", dict(y_re=y_re, y_im=y_im,
                                              mask=mask1)),
                ("seed=2", dict(y_re=y_re, y_im=y_im, sens_re=maps2))]
    n_steps = cfg.sampling.n_steps_each
    chain_steps = CINE_LEVELS * n_steps * CINE_CHAINS
    numbers = dict(chain_steps=chain_steps, frames=T, chains=CINE_CHAINS,
                   levels=CINE_LEVELS,
                   reduced=f"chains {CINE_CHAINS} (serve_recon's default "
                           f"16), {CINE_LEVELS} of the config's 1000 levels")
    outputs = {}
    fk.LAUNCHES.clear()
    fl.LAUNCHES.clear()
    for name in ("f32", "bf16"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        eng = serve_recon.build_engine(serve_recon.parse_args(
            cine_argv(name)))
        build_s = time.perf_counter() - t_build
        warmup_s = eng.warmup()
        served = serve_requests(eng, requests, chain_steps)
        # a request's host work before the chain: its operator (mask
        # tiled over the chains) and its (T, W, W) normal kernel
        t_host = time.perf_counter()
        lin = eng._build_lin_tfm(mask1, None, None)
        torch.cuda.synchronize()
        operator_s = time.perf_counter() - t_host
        t_host = time.perf_counter()
        prox = eng._build_proximal(lin)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t_host
        if tuple(prox.kernel_re.shape) != (T, size, size):
            raise AssertionError(f"normal kernel of shape "
                                 f"{tuple(prox.kernel_re.shape)}")
        res = eng.reconstruct(y_re, y_im, seed=3, lamda_T=CINE_LAMDA_T)
        outputs[name] = (res.x_re, res.x_im)
        stats = eng.stats()
        want = (CINE_CHAINS, T, size, size, 1)
        if (stats["input_signatures"] != 1 or stats["requests"] != 4
                or res.x_re.shape != want):
            raise AssertionError(f"{name} cine engine stats {stats}, shape "
                                 f"{res.x_re.shape}")
        if not (np.isfinite(res.x_re).all() and np.isfinite(res.x_im).all()):
            raise AssertionError(f"{name} cine in-process request not finite")
        numbers[name] = dict(
            build_s=build_s, warmup_s=warmup_s, **served,
            operator_s=operator_s, normal_kernel_s=kernel_s,
            in_process=dict(latency_s=res.latency_s,
                            chain_steps_per_s=res.chain_steps_per_s,
                            lamda_T=CINE_LAMDA_T),
            input_signatures=stats["input_signatures"], shape=list(want),
            peak=torch.cuda.max_memory_allocated())
        if name == "bf16":
            del eng
            continue
        # the engine against the direct path on cine_problem's operator
        # (built apart from serve_recon's), the same seed and lamda_T: the
        # same operations on the same card, so torch's defaults (TF32) as
        # in the request; the float32 mode would take 4.3 times as long
        # (42.37 s a request, PERF.md)
        lin_d, prox_d, yb_re, yb_im = cine_tiled(mask, maps, y_re, y_im,
                                                 CINE_CHAINS, device)
        direct = make_stepped_2d_time_pair_reconstructor(
            eng.model_S, eng.model_T, eng.sigmas_S, eng.sigmas_T, lin_d,
            prox_d, eng.ald_config, lr_scaled=eng.spec.lr_scaled,
            lamda_T=CINE_LAMDA_T, win_size=CINE_WIN, num_frames=T,
            device=device)(yb_re, yb_im, seed=3)
        numbers["engine_vs_direct_rel_l2"] = max(
            rel_l2(torch.from_numpy(a), b.cpu())
            for a, b in zip(outputs["f32"], direct))
        if not numbers["engine_vs_direct_rel_l2"] <= ENGINE_REL_L2:
            raise AssertionError(
                f"cine engine vs make_stepped_2d_time_pair_reconstructor: "
                f"rel L2 {numbers['engine_vs_direct_rel_l2']}")
        del direct
        numbers["profile"] = profile_cine_level(eng, y_re, y_im, device)
        # the two nets alone at the chain's batches, torch's defaults
        tubes = 2 * CINE_CHAINS * (size // CINE_WIN) ** 2
        gen = torch.Generator().manual_seed(4)
        with torch.inference_mode():
            xs = torch.rand(2 * CINE_CHAINS * T, size, size, 1,
                            generator=gen).to(device)
            xt = torch.rand(tubes, T, CINE_WIN ** 2, generator=gen).to(device)
            lab = lambda n: torch.full((n,), CINE_CHECK_LEVEL, device=device)
            numbers["spatial_net_ms"] = cuda_ms(
                lambda: eng._score_S(xs, lab(len(xs))), reps=3)
            numbers["temporal_net_ms"] = cuda_ms(
                lambda: eng._score_T(xt, lab(len(xt))), reps=3)
        numbers["net_batches"] = dict(spatial=len(xs), temporal=tubes)
        model_S, model_T = eng.model_S, eng.model_T
        sigmas_S, sigmas_T = eng.sigmas_S, eng.sigmas_T
        del eng, xs, xt
    no_kernel_launches(fk, fl, "the cine phase")
    numbers["bf16_vs_f32_rel_l2"] = max(
        rel_l2(torch.from_numpy(a), torch.from_numpy(b))
        for a, b in zip(outputs["bf16"], outputs["f32"]))
    if not numbers["bf16_vs_f32_rel_l2"] <= BF16_REL_L2:
        raise AssertionError(f"cine bf16 vs f32: rel L2 "
                             f"{numbers['bf16_vs_f32_rel_l2']}")
    torch.cuda.empty_cache()

    # Card against CPU, float32 mode. The full-width NCSN1D through
    # make_score_fn on channel-last tubes at the first temporal level and
    # the last; one inner step at CINE_CHECK_LEVEL on one chain of T
    # frames, the same injected noise (the frames' Re and Im, then the
    # tubes') and, with the random shift on, the same roll.
    cpu_S = copy.deepcopy(model_S).cpu()
    cpu_T = copy.deepcopy(model_T).cpu()
    gen = torch.Generator().manual_seed(8)
    tubes = torch.rand(64, T, CINE_WIN ** 2, generator=gen)
    labels = torch.tensor([57, 342] * 32)
    outs = []
    with torch.inference_mode(), float32_exact():
        for dev, net in ((device, model_T), ("cpu", cpu_T)):
            outs.append(make_score_fn(net, sigmas_T)(
                tubes.to(dev), labels.to(dev)).cpu())
    checks = {"ncsn1d_forward": rel_l2(*outs)}
    lin1, prox1, y1_re, y1_im = cine_tiled(mask, maps, y_re, y_im, 1, "cpu")
    frames = (T, size, size, 1)
    tube_shape = ((size // CINE_WIN) ** 2, T, CINE_WIN ** 2)
    draws = [torch.randn(shp, generator=gen)
             for shp in (frames, frames, tube_shape, tube_shape)]
    one = ALDConfig(n_steps_each=1, step_lr=cfg.sampling.step_lr)
    cpu_s = 0.0
    for shift_on in (False, True):
        steps = []
        for dev, nets in ((device, (model_S, model_T)),
                          ("cpu", (cpu_S, cpu_T))):
            t_dev = time.perf_counter()
            recon = make_stepped_2d_time_pair_reconstructor(
                *nets, sigmas_S, sigmas_T, lin1, prox1, one,
                lr_scaled=5.0, if_random_shift=shift_on, win_size=CINE_WIN,
                num_frames=T, device=dev)
            it = iter(d.to(dev) for d in draws)
            with torch.inference_mode(), float32_exact():
                y1 = y1_re.to(dev), y1_im.to(dev)
                xr, xi, prox = recon.start(*y1)
                steps.append([v.cpu() for v in recon.level_step(
                    prox, xr, xi, *y1, CINE_CHECK_LEVEL, lambda s: next(it),
                    lambda win: (3, 5))])
            if dev == "cpu":
                cpu_s += time.perf_counter() - t_dev
        checks[f"inner_step_shift_{'on' if shift_on else 'off'}"] = max(
            rel_l2(a, b) for a, b in zip(*steps))
    numbers["card_vs_cpu_rel_l2"] = checks
    numbers["cpu_check_s"] = cpu_s
    failed = {k: v for k, v in checks.items() if not v <= MODEL_REL_L2}
    if failed:
        raise AssertionError(f"cine card vs CPU: rel L2 {failed}")
    return numbers


def profile_level(recon, yr, yi, n_steps, device, level: int = 0) -> dict:
    """One level step (n_steps inner steps at `level`) of `recon` timed by
    CUDA events
    and by the host clock, then the same under torch.profiler: the top 10
    device kernels and the top 10 operators by device time (with call
    counts), launches per inner step, and the device's idle share of the
    profiled window."""
    from torch.profiler import ProfilerActivity, profile
    from inverseproblemwithdiffusionmodel_tpu_torch.utils.device import (
        gaussian_noise)
    noise = gaussian_noise(7, device)
    with torch.inference_mode():
        xr, xi, prox = recon.start(yr, yi)
        step = lambda: recon.level_step(prox, xr, xi, yr, yi, level, noise)
        device_ms, host_ms = cuda_ms(step, reps=3, host=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_run = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t_run)
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type.name == "CUDA"),
                     key=lambda e: -e.device_time_total)
    ops = sorted((e for e in events if e.device_type.name == "CPU"
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)
    device_us = sum(e.device_time_total for e in kernels)
    launches = sum(e.count for e in events if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")))
    return dict(
        level_device_ms=device_ms, level_host_ms=host_ms,
        profiled_wall_ms=wall_us / 1e3, profiled_device_ms=device_us / 1e3,
        idle_share=idle_share(prof, wall_us),
        launches_per_inner_step=launches / n_steps,
        device_events_per_inner_step=sum(e.count for e in kernels) / n_steps,
        top_kernels=[(e.key[:90], e.count, e.device_time_total / 1e3)
                     for e in kernels[:10]],
        top_ops=[(e.key, e.count, e.self_device_time_total / 1e3)
                 for e in ops[:10]])


def report_cine(cine: dict, t: float) -> None:
    """The cine phase's lines: per engine, then the profiled level step,
    then the phase's summary."""
    prof = cine["profile"]
    for name in ("f32", "bf16"):
        r = cine[name]
        http = ", ".join(
            f"{q['query']}: {q['chain_steps_per_s']:.2f} (engine) / "
            f"{q['client_chain_steps_per_s']:.2f} (client, "
            f"{q['client_s']:.4f} s)" for q in r["requests"])
        print(f"    {name}: build {r['build_s']:.2f} s, warm-up "
              f"{r['warmup_s']:.2f} s; chain-steps/s over HTTP {http}; "
              f"in-process (lamda_T {CINE_LAMDA_T}) "
              f"{r['in_process']['chain_steps_per_s']:.2f} "
              f"({r['in_process']['latency_s']:.4f} s); shape {r['shape']}; "
              f"/healthz requests {r['healthz_requests']}; input signatures "
              f"{r['input_signatures']}; peak {r['peak']} bytes; host: "
              f"operator {r['operator_s']:.4f} s, (T, W, W) normal kernel "
              f"{r['normal_kernel_s']:.4f} s", flush=True)
    split = ", ".join(f"{k} {v:.2f}" for k, v in prof["split_ms"].items())
    print(f"    one level step (f32, level {CINE_CHECK_LEVEL}, "
          f"{CINE_FRAMES} frames x {CINE_CHAINS} chains): device ms by part: "
          f"{split}; profiled: wall {prof['profiled_wall_ms']:.2f} ms, "
          f"kernels {prof['profiled_device_ms']:.2f} ms, idle share "
          f"{prof['idle_share']:.4f}, launches per inner step "
          f"{prof['launches_per_inner_step']:.1f}; nets alone (torch "
          f"defaults): spatial {cine['spatial_net_ms']:.2f} ms at batch "
          f"{cine['net_batches']['spatial']}, temporal "
          f"{cine['temporal_net_ms']:.2f} ms at batch "
          f"{cine['net_batches']['temporal']}", flush=True)
    for label, rows in (("kernel", prof["top_kernels"]),
                        ("op", prof["top_ops"])):
        for key, calls, ms in rows:
            print(f"    top {label}: {ms:.3f} ms over {calls} calls | {key}",
                  flush=True)
    say("cine", t, f"serve_recon --workload cine (CINE127 128 px spatial "
        f"NCSNv2Deepest + CINE127_1D NCSN1D, ngf 128 each, seed 0; "
        f"{CINE_FRAMES} frames, 4 coils, per-frame R = 8, {CINE_WIN}x"
        f"{CINE_WIN} tubes; reduced: {cine['reduced']}), 3 requests over "
        f"HTTP per engine and one in-process: f32 "
        f"{cine['f32']['in_process']['chain_steps_per_s']:.2f} "
        f"chain-steps/s in-process, bf16 "
        f"{cine['bf16']['in_process']['chain_steps_per_s']:.2f}; engine vs "
        f"make_stepped_2d_time_pair_reconstructor "
        f"(same card, TF32) rel L2 {cine['engine_vs_direct_rel_l2']:.3g} (<= "
        f"{ENGINE_REL_L2}); bf16 vs f32 rel L2 "
        f"{cine['bf16_vs_f32_rel_l2']:.3g} (<= {BF16_REL_L2}); card vs CPU "
        f"(float32 mode) rel L2 {json.dumps(cine['card_vs_cpu_rel_l2'])} "
        f"(each <= {MODEL_REL_L2}; the CPU side {cine['cpu_check_s']:.1f} "
        f"s); one input signature per engine; no K1/K2/K4 launch")


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

    # 9. ncsnv2 ---------------------------------------------------------------
    t = time.perf_counter()
    nv2 = ncsnv2_phase(fk, fl)
    say("ncsnv2", t, f"ACDC NCSNv2Deepest, 256 px, ngf 128, {nv2['params']} "
        f"params (seed 0), through make_score_fn on channel-last x: card vs "
        f"CPU at batch {BATCH}, float32 mode, rel L2 {nv2['rel_l2']:.3g} (<= "
        f"{MODEL_REL_L2}); forward at batch {2 * ACDC_CHAINS}: torch "
        f"defaults (cuDNN TF32 {torch.backends.cudnn.allow_tf32}) "
        f"{nv2['f32']['ms']:.2f} ms on the card ({nv2['f32']['host_ms']:.2f} "
        f"ms host), peak {nv2['f32']['peak']} bytes; bf16 "
        f"{nv2['bf16']['ms']:.2f} ms ({nv2['bf16']['host_ms']:.2f} ms host), "
        f"peak {nv2['bf16']['peak']} bytes; on the bare permute (NHWC run): "
        f"f32 {nv2['f32_nhwc_view']['ms']:.2f} ms, bf16 "
        f"{nv2['bf16_nhwc_view']['ms']:.2f} ms; channels-last net: f32 "
        f"{nv2['f32_channels_last']['ms']:.2f} ms, bf16 "
        f"{nv2['bf16_channels_last']['ms']:.2f} ms; no K1/K2/K4 launch")

    # 10. recon ---------------------------------------------------------------
    t = time.perf_counter()
    rec = recon_phase(fk, fl)
    launches["recon"] = {}
    prof = rec["profile"]
    for name in ("f32", "bf16"):
        r = rec[name]
        print(f"    {name}: runs {[round(v, 4) for v in r['seconds']]} s, "
              f"{r['chain_steps_per_s']:.2f} chain-steps/s, peak "
              f"{r['peak']} bytes, finite {r['finite']}, max |x| "
              f"{r['abs_max']:.4g}", flush=True)
    print(f"    one level step (f32, {rec['n_steps']} inner steps): "
          f"{prof['level_device_ms']:.2f} ms on the card by CUDA events, "
          f"{prof['level_host_ms']:.2f} ms host to enqueue; profiled: "
          f"wall {prof['profiled_wall_ms']:.2f} ms, kernels "
          f"{prof['profiled_device_ms']:.2f} ms, idle share "
          f"{prof['idle_share']:.4f}, launches per inner step "
          f"{prof['launches_per_inner_step']:.1f} (device events "
          f"{prof['device_events_per_inner_step']:.1f})", flush=True)
    for label, rows in (("kernel", prof["top_kernels"]),
                        ("op", prof["top_ops"])):
        for key, calls, ms in rows:
            print(f"    top {label}: {ms:.3f} ms over {calls} calls | {key}",
                  flush=True)
    say("recon", t, f"make_stepped_pair_reconstructor, bench.py geometry "
        f"(256 px, ngf 128, {ACDC_CHAINS} chains, {ACDC_COILS} coils, R = "
        f"{ACDC_R}, {ACDC_LEVELS} levels (of 2311) x 3 steps, CG "
        f"{ACDC_CG_ITERS}, lr_scaled {ACDC_LR_SCALED}, denoise on): f32 "
        f"{rec['f32']['chain_steps_per_s']:.2f} chain-steps/s, bf16 "
        f"{rec['bf16']['chain_steps_per_s']:.2f}; bf16 vs f32 rel L2 "
        f"{rec['bf16_vs_f32_rel_l2']:.3g} (<= {BF16_REL_L2}); card vs CPU "
        f"(1 chain, float32 mode) rel L2 "
        f"{json.dumps(rec['card_vs_cpu_rel_l2'])} (each <= {MODEL_REL_L2}); "
        f"no K1/K2/K4 launch")

    # 11. serve ---------------------------------------------------------------
    t = time.perf_counter()
    srv = serve_phase(fk, fl)
    launches["serve"] = {}
    for name in ("f32", "bf16", "guided_bf16"):
        r = srv[name]
        http = ", ".join(
            f"{q['query']}: {q['chain_steps_per_s']:.2f} (engine) / "
            f"{q['client_chain_steps_per_s']:.2f} (client, "
            f"{q['client_s']:.4f} s)" for q in r["requests"])
        print(f"    {name}: build {r['build_s']:.2f} s, warm-up "
              f"{r['warmup_s']:.2f} s; chain-steps/s over HTTP {http}; "
              f"in-process {r['in_process']['chain_steps_per_s']:.2f} "
              f"({r['in_process']['latency_s']:.4f} s); /healthz requests "
              f"{r['healthz_requests']}; input signatures "
              f"{r['input_signatures']}; peak {r['peak']} bytes" + (
                  f"; host: normal kernel {r['normal_kernel_s']:.4f} s, "
                  f"npz encoding {r['npz_encode_s']:.4f} s"
                  if "normal_kernel_s" in r else ""), flush=True)
    say("serve", t, f"serve_recon.build_engine + serving.server at the recon "
        f"geometry, 3 requests over HTTP per engine (default operator; new "
        f"R = {ACDC_R} mask, lr_scaled 3.0; new coil maps) and one "
        f"in-process: f32 "
        f"{srv['f32']['in_process']['chain_steps_per_s']:.2f} chain-steps/s "
        f"in-process, bf16 "
        f"{srv['bf16']['in_process']['chain_steps_per_s']:.2f}, guided bf16 "
        f"(seg UNet {srv['guided_bf16']['seg_params']} params) "
        f"{srv['guided_bf16']['in_process']['chain_steps_per_s']:.2f}; "
        f"engine vs make_stepped_pair_reconstructor (float32 mode) rel L2 "
        f"{srv['engine_vs_direct_rel_l2']:.3g} (<= {ENGINE_REL_L2}); guided "
        f"card vs CPU (1 chain) rel L2 "
        f"{json.dumps(srv['guided_card_vs_cpu_rel_l2'])} (the step <= "
        f"{MODEL_REL_L2} in the float32 mode, the float64 gradient <= "
        f"{SEG_F64_REL_L2}, the card's float32 gradient vs float64 <= "
        f"{SEG_F32_REL_L2}); one input signature per engine; no K1/K2/K4 "
        f"launch")

    # 12. cine ----------------------------------------------------------------
    t = time.perf_counter()
    cine = cine_phase(fk, fl)
    launches["cine"] = {}
    report_cine(cine, t)
    print(json.dumps({"ncsnv2": nv2, "recon": rec, "serve": srv,
                      "cine": cine}), flush=True)

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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

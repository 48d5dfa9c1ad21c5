"""Time and profile one NCSN++ forward, or one train step, on the GPU:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.profile_forward \\
      --config ve/ffhq_256_ncsnpp_continuous --batch 2 [--exact_fp32] \\
      [--backward | --step [--bf16]]

Prints, for weights drawn from --seed: the device time of one forward (CUDA
events over --reps calls, after warm-up), the host time to enqueue it, peak
device memory of those calls and of the first call (where cuDNN's
benchmark mode tries its algorithms), the number of kernel launches in one
forward, its FLOP count (torch.utils.flop_counter) and rate, the device
time of its kernels in one profiled call and the share of the timed call
the card was idle, and torch.profiler's kernels by device time.
--backward does the same for a forward and backward of mean(out^2) (the
work of a train step without the optimizer). --step does it for one
continuous train step (training.make_continuous_score_train_step on a
seeded batch in [0, 1]: the leaf's loss, the backward, Adam and the EMA),
its net in bf16 with --bf16 (the step's compute_dtype). --exact_fp32 turns
TF32 off for cuDNN and matmul and cuDNN's benchmark mode on
(utils/precision.float32_exact). By default torch's own settings hold
(cuDNN in TF32, heuristics). The last line is the numbers as one JSON
object.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from ..configs_continuous import get_continuous_config, make_sde
from ..models.registry import create_model
from ..training import (TrainState, get_optimizer,
                        make_continuous_score_train_step)
from ..utils.convert import seeded_weights
from ..utils.precision import float32_exact


def _launches(events) -> int:
    return sum(e.count for e in events
               if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))


def _kernel_ms(events) -> float:
    """Device ms of the kernels among `events`; user annotations, such as
    the optimizer's range, are not kernels."""
    return sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in events if e.device_type.name == "CUDA"
               and not e.is_user_annotation) / 1e3


def _timed(fn, reps: int):
    """(device ms, host ms) per call by CUDA events, after 3 warm-ups; the
    peak memory counter is reset after the warm-ups, so it reads the timed
    calls alone (cuDNN's benchmark mode tries algorithms in the first)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    return start.elapsed_time(end) / reps, host_ms


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="ve/ffhq_256_ncsnpp_continuous")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--exact_fp32", action="store_true")
    p.add_argument("--backward", action="store_true")
    p.add_argument("--step", action="store_true",
                   help="one continuous train step, Adam and EMA included")
    p.add_argument("--bf16", action="store_true",
                   help="with --step: the net in bf16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    if args.bf16 and not args.step:
        p.error("--bf16 needs --step")
    if not torch.cuda.is_available():
        raise RuntimeError("profile_forward times the GPU, but torch sees no "
                           "CUDA device")
    device = torch.device("cuda")
    mode = float32_exact() if args.exact_fp32 else contextlib.nullcontext()
    with mode:
        return _profile(args, device)


def _profile(args, device):
    cfg = get_continuous_config(args.config)
    model = seeded_weights(create_model(cfg), args.seed).to(device).eval()
    s, ch = cfg.data.image_size, cfg.data.num_channels
    gen = torch.Generator().manual_seed(args.seed)
    x = torch.rand(args.batch, s, s, ch, generator=gen).to(device)
    sigma = torch.full((args.batch,), 5.0, device=device)

    def forward():
        return model(x, sigma)

    def forward_backward():
        params = [q for q in model.parameters() if q.requires_grad]
        torch.autograd.grad(model(x, sigma).square().mean(), params)

    if args.step:
        model.train()
        state = TrainState.create(model, get_optimizer(cfg),
                                  ema_decay=cfg.model.ema_rate)
        step = make_continuous_score_train_step(
            model, make_sde(cfg), reduce_mean=cfg.training.reduce_mean,
            compute_dtype=torch.bfloat16 if args.bf16 else None)
        step_gen = torch.Generator(device=device).manual_seed(args.seed)

        def train_step():
            step(state, x, step_gen)
        run = train_step
    else:
        run = forward_backward if args.backward else forward
    grad_mode = (contextlib.nullcontext() if args.backward or args.step
                 else torch.no_grad())
    with grad_mode:
        torch.cuda.reset_peak_memory_stats()
        run()
        warmup_peak = torch.cuda.max_memory_allocated()
        device_ms, host_ms = _timed(run, args.reps)
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        with FlopCounterMode(display=False) as flops:
            run()

    events = prof.key_averages()
    print(events.table(sort_by="cuda_time_total", row_limit=args.top))
    numbers = {
        "device": torch.cuda.get_device_name(device), "config": args.config,
        "batch": args.batch, "exact_fp32": args.exact_fp32,
        "backward": args.backward, "step": args.step, "bf16": args.bf16,
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "device_ms": device_ms, "host_ms": host_ms,
        "kernel_ms": _kernel_ms(events),
        "idle_share": 1.0 - _kernel_ms(events) / device_ms,
        "peak_bytes": peak,
        "first_call_peak_bytes": warmup_peak,
        "launches": _launches(events),
        "fft_kernels": sum(e.count for e in events
                           if e.device_type.name == "CUDA"
                           and "fft" in e.key.lower()),
        "gflop": flops.get_total_flops() / 1e9,
        "tflop_per_s": flops.get_total_flops() / device_ms / 1e9}
    print(json.dumps(numbers), flush=True)
    return numbers


if __name__ == "__main__":
    main()

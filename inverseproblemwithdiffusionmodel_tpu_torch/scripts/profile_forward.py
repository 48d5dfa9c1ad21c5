"""Time and profile one NCSN++ forward on the GPU:

  python -m inverseproblemwithdiffusionmodel_tpu_torch.scripts.profile_forward \\
      --config ve/ffhq_256_ncsnpp_continuous --batch 2 [--exact_fp32] \\
      [--backward]

Prints, for weights drawn from --seed: the device time of one forward (CUDA
events over --reps calls, after warm-up), the host time to enqueue it, peak
device memory of those calls and of the first call (where cuDNN's
benchmark mode tries its algorithms), the number of kernel launches in one
forward, its FLOP count (torch.utils.flop_counter) and rate, and
torch.profiler's kernels by device time. --backward does the same for a forward and backward of mean(out^2)
(the work of a train step without the optimizer). --exact_fp32 turns TF32
off for cuDNN and matmul and cuDNN's benchmark mode on
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

from ..configs_continuous import get_continuous_config
from ..models.registry import create_model
from ..utils.convert import seeded_weights
from ..utils.precision import float32_exact


def _launches(events) -> int:
    return sum(e.count for e in events
               if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))


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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
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

    run = forward_backward if args.backward else forward
    grad_mode = contextlib.nullcontext() if args.backward else torch.no_grad()
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
        "backward": args.backward,
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "device_ms": device_ms, "host_ms": host_ms, "peak_bytes": peak,
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

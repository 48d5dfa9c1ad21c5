"""Profiling and timing helpers.

Port of inverseproblemwithdiffusionmodel_tpu/utils/profiling.py (the
reference has only wall-clock prints, scripts/cine_SENSE_real_img_2d_time.py:
163-182):

- `trace(log_dir)`: a torch.profiler session (CPU and, where torch sees a
  card, CUDA activities) around a block; on exit it writes a Chrome trace
  (`trace.json`, for Perfetto or chrome://tracing) into log_dir. The
  session is yielded, so the block's caller can read `key_averages()`.
- `annotate(name)`: a named region of the trace (record_function).
- `timed(fn, *args, warmup=1, iters=3)`: the JAX form's semantics: the
  first call is timed as `compile_s` (here the first call's set-up:
  cuDNN's plans, the kernels' build), warmup - 1 more calls, then `iters`
  timed calls. Where fn's result holds a CUDA tensor, each call is timed
  by CUDA events on the current stream, so the numbers are the device's;
  on the CPU by the host clock. Returns {'compile_s', 'mean_s', 'best_s',
  'result'}.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; write `<log_dir>/trace.json` on exit."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    return torch.profiler.record_function(name)


def _cuda_device(out) -> Optional[torch.device]:
    """The device of the first CUDA tensor in out (a tensor or a nest of
    tuples, lists and dicts), or None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for item in items:
        device = _cuda_device(item)
        if device is not None:
            return device
    return None


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 3,
          **kwargs) -> Dict[str, Any]:
    """Time fn(*args, **kwargs): the first call, warmup - 1 untimed calls,
    then `iters` timed calls (CUDA events where the result is on a card,
    else the host clock)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    device = _cuda_device(out)
    if device is not None:
        torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        out = fn(*args, **kwargs)
    times = []
    for _ in range(iters):
        if device is None:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / 1e3)
    return {"compile_s": compile_s, "mean_s": sum(times) / len(times),
            "best_s": min(times), "result": out}

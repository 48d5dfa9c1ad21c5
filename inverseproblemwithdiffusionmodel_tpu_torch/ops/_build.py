"""Build and load the port's CUDA kernels: one `nvcc -c` per `csrc/*.cu`,
all started together, then one link into a shared library with a plain C
interface, loaded with `ctypes`. The build takes as long as its slowest
source, not the sum (`int8_ab.py` times both forms).

The library is built on first use into `_build/<key>/libport_kernels.so` at
the root of this package, where `<key>` is the sha256 of the sources and the
flags, so an edited source gets a fresh build and an unchanged one is
reused. `nvcc` writes a temporary file that `os.replace` then moves into
place, so two processes building at once need no lock: the last rename wins
and both results are the same library (each process compiles into object
files of its own).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_LIB_NAME = "libport_kernels.so"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

_PTR, _I64, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
# argtypes of the C launchers, by function; every one returns a cudaError_t.
_ARGTYPES = {
    # csrc/fir2x.cu: input, output, N, H, W, C, four taps for the H axis,
    # four for the W axis, stream; float32 and bf16 tensors.
    "fir_up2x_f32": [_PTR, _PTR] + [_I64] * 4 + [_F32] * 8 + [_PTR],
    "fir_down2x_f32": [_PTR, _PTR] + [_I64] * 4 + [_F32] * 8 + [_PTR],
    "fir_up2x_bf16": [_PTR, _PTR] + [_I64] * 4 + [_F32] * 8 + [_PTR],
    "fir_down2x_bf16": [_PTR, _PTR] + [_I64] * 4 + [_F32] * 8 + [_PTR],
    # csrc/flr.cu: x, bias, y, rows, C, slope, scale, stream.
    "flr_fwd_f32": [_PTR] * 3 + [_I64] * 2 + [_F32] * 2 + [_PTR],
    "flr_fwd_bf16": [_PTR] * 3 + [_I64] * 2 + [_F32] * 2 + [_PTR],
    # csrc/flr.cu: x, bias, g, dx, rows, C, scale, scale * slope, stream.
    "flr_bwd_f32": [_PTR] * 4 + [_I64] * 2 + [_F32] * 2 + [_PTR],
    "flr_bwd_bf16": [_PTR] * 4 + [_I64] * 2 + [_F32] * 2 + [_PTR],
    # csrc/int8conv.cu K5: x, amax (float32), scratch (the ticket and one
    # partial per block), then int8_kernels.absmax_launch_args (head,
    # body_bytes, tail, blocks), the scratch's words; stream.
    "int8_absmax_f32": [_PTR] * 3 + [_I64] * 5 + [_PTR],
    "int8_absmax_bf16": [_PTR] * 3 + [_I64] * 5 + [_PTR],
    # K6: x (N, C, P) contiguous, amax, codes, scale, N, C, P, Cp, stream.
    "int8_quantize_f32": [_PTR] * 4 + [_I64] * 4 + [_PTR],
    "int8_quantize_bf16": [_PTR] * 4 + [_I64] * 4 + [_PTR],
    # K7: codes, weight codes, scale, weight scales, out, int32 sums (or
    # null), then int8_kernels.conv_launch_args (N, H, W, Cp, O, KH, KW,
    # dilation, Ho, Wo, and the plan: bn, cb, chunks, k_iters, stages,
    # blocks_per_sm, stage_bytes, m_tiles, o_tiles, run, lower_w, lower_h,
    # upper_w, upper_h, shared bytes); stream.
    "int8_conv_f32": [_PTR] * 6 + [_I64] * 25 + [_PTR],
    "int8_conv_bf16": [_PTR] * 6 + [_I64] * 25 + [_PTR],
}


@dataclasses.dataclass(frozen=True)
class Build:
    """A loaded kernel library and how it came to be."""
    lib: ctypes.CDLL
    path: str
    seconds: float   # wall time of this process's nvcc calls; 0.0 if reused
    log: str         # nvcc's output, including ptxas register and smem lines


def find_nvcc() -> str:
    """`nvcc` from $CUDA_HOME, torch's CUDA_HOME, or PATH; raises if absent."""
    homes = [os.environ.get("CUDA_HOME")]
    from torch.utils.cpp_extension import CUDA_HOME
    homes.append(CUDA_HOME)
    for home in homes:
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH; "
                       "the CUDA kernels are built from source on first use")


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _key(sources) -> str:
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def build(sources: Optional[Tuple[str, ...]] = None,
          launchers: Optional[Tuple[str, ...]] = None) -> Build:
    """Build the library if no build of these sources exists, then load it.
    `sources` defaults to every csrc/*.cu; another set (the same C
    functions from other files, as fir_ab.py builds a second version to
    time against) gets a library of its own. `launchers` names the C
    launchers the library must export, by default every one in _ARGTYPES;
    a missing one raises here."""
    sources = _sources() if sources is None else list(sources)
    out_dir = os.path.join(_BUILD_ROOT, _key(sources))
    path = os.path.join(out_dir, _LIB_NAME)
    log_path = path + ".log"
    seconds = 0.0
    if not os.path.isfile(path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        jobs = []
        for src in sources:
            obj = os.path.join(out_dir, f"{os.path.basename(src)}."
                               f"{os.getpid()}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if not failed:
            cmd = [nvcc, *ARCH, "-shared", "-o", tmp,
                   *[obj for _, obj, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{logs[-1]}")
        for _, obj, _ in jobs:
            if os.path.exists(obj):
                os.remove(obj)
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        log = "".join(logs)
        with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
            f.write(log)
        os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
        os.replace(tmp, path)
    with open(log_path) as f:
        log = f.read()
    lib = ctypes.CDLL(path)
    for name in _ARGTYPES if launchers is None else launchers:
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return Build(lib=lib, path=path, seconds=seconds, log=log)

"""Build and load the port's CUDA kernels: one `nvcc` call compiles every
`csrc/*.cu` into one shared library with a plain C interface, loaded with
`ctypes`.

The library is built on first use into `_build/<key>/libport_kernels.so` at
the root of this package, where `<key>` is the sha256 of the sources and the
flags, so an edited source gets a fresh build and an unchanged one is
reused. `nvcc` writes a temporary file that `os.replace` then moves into
place, so two processes building at once need no lock: the last rename wins
and both results are the same library.
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

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_LIB_NAME = "libport_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR, _I64, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
# argtypes of the C launchers, by function; every one returns a cudaError_t.
_ARGTYPES = {
    # csrc/fir2x.cu: input, output, N, H, W, C, four taps for the H axis,
    # four for the W axis, stream.
    "fir_up2x_f32": [_PTR, _PTR] + [_I64] * 4 + [_F32] * 8 + [_PTR],
    "fir_down2x_f32": [_PTR, _PTR] + [_I64] * 4 + [_F32] * 8 + [_PTR],
    # csrc/flr.cu: x, bias, y, rows, C, slope, scale, stream.
    "flr_fwd_f32": [_PTR] * 3 + [_I64] * 2 + [_F32] * 2 + [_PTR],
    # csrc/flr.cu: x, bias, g, dx, rows, C, scale, scale * slope, stream.
    "flr_bwd_f32": [_PTR] * 4 + [_I64] * 2 + [_F32] * 2 + [_PTR],
}


@dataclasses.dataclass(frozen=True)
class Build:
    """A loaded kernel library and how it came to be."""
    lib: ctypes.CDLL
    path: str
    seconds: float   # time spent in nvcc by this process; 0.0 if reused
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
def build() -> Build:
    """Build the library if no build of these sources exists, then load it."""
    sources = _sources()
    out_dir = os.path.join(_BUILD_ROOT, _key(sources))
    path = os.path.join(out_dir, _LIB_NAME)
    log_path = path + ".log"
    seconds = 0.0
    if not os.path.isfile(path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
            f.write(log)
        os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
        os.replace(tmp, path)
    with open(log_path) as f:
        log = f.read()
    lib = ctypes.CDLL(path)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Build(lib=lib, path=path, seconds=seconds, log=log)

"""ctypes binding for the native prefetching batcher (native/batcher.cpp).

Port of inverseproblemwithdiffusionmodel_tpu/data/native_loader.py.
`NativeBatchIterator` is a drop-in for `training.batch_iterator` with the
gather + shuffle running on a C++ worker thread (the reference's DataLoader
num_workers analog). Falls back cleanly: `native_available()` gates usage.

The library is built with g++ on first use into `_build/<key>/
libbatcher.so` at the root of this package, where `<key>` is the sha256 of
the source and the flags, so an edited source gets a fresh build and an
unchanged one is reused; never next to the source. g++ writes a temporary
file that `os.replace` moves into place, so two processes building at once
need no lock (ops/_build.py builds the CUDA kernels the same way).

`reference_batches` is the plain version: the same XorShift Fisher-Yates
per epoch (seed + 0x1000003 (epoch + 1)) in Python, yielding the sample
indices of each batch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "batcher.cpp")
_BUILD_ROOT = os.path.join(_ROOT, "_build")
_LIB_NAME = "libbatcher.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path(src: str = _SRC) -> str:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], _LIB_NAME)


def build(src: str = _SRC, path: Optional[str] = None) -> str:
    """Compile `src` with g++ into `path` (default `library_path(src)`)
    unless it is there; returns the path. Raises where g++ is missing or
    fails."""
    path = path or library_path(src)
    if os.path.isfile(path):
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise OSError("g++ not found on PATH")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, src, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types on `lib`."""
    lib.batcher_create.restype = ctypes.c_void_p
    lib.batcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int]
    lib.batcher_batches_per_epoch.restype = ctypes.c_int64
    lib.batcher_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.batcher_next.restype = ctypes.c_int64
    lib.batcher_next.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_float)]
    lib.batcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            _lib = bind(ctypes.CDLL(build()))
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = str(e) + getattr(e, "stderr", "")
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeBatchIterator:
    """Infinite shuffled batch stream over an in-memory float32 array with
    C++ worker-thread prefetch. Use `batches_per_epoch` to bound epochs."""

    def __init__(self, data: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, prefetch_depth: int = 2,
                 lib: Optional[ctypes.CDLL] = None):
        lib = lib or _load()
        if lib is None:
            raise RuntimeError(f"native batcher unavailable: {_build_error}")
        self._lib = lib
        # keep a contiguous float32 copy alive for the C++ side
        self._data = np.ascontiguousarray(data, dtype=np.float32)
        n = self._data.shape[0]
        self._sample_shape = self._data.shape[1:]
        sample_size = int(np.prod(self._sample_shape))
        self.batch_size = batch_size
        self._handle = lib.batcher_create(
            self._data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, sample_size, batch_size, int(shuffle), seed, int(drop_last),
            prefetch_depth)
        if not self._handle:
            raise RuntimeError("batcher_create failed")
        self.batches_per_epoch = int(
            lib.batcher_batches_per_epoch(self._handle))
        self._out = np.empty((batch_size, sample_size), np.float32)

    def next(self) -> np.ndarray:
        count = self._lib.batcher_next(
            self._handle,
            self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if count <= 0:
            raise StopIteration
        # count < batch_size only for the drop_last=False epoch tail -
        # a short batch, matching training.batch_iterator exactly
        return self._out[:count].reshape(int(count),
                                         *self._sample_shape).copy()

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def epoch_iter(self):
        """One epoch's worth of batches (for the fit() train_iter_fn API)."""
        for _ in range(self.batches_per_epoch):
            yield self.next()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.batcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_batch_iterator(data: np.ndarray, batch_size: int, **kw):
    """Factory matching training.batch_iterator's call contract:
    returns `make()` yielding one epoch of batches per call."""
    it = NativeBatchIterator(data, batch_size, **kw)

    def make():
        return it.epoch_iter()

    make.iterator = it
    return make


# -- the plain version ---------------------------------------------------------

_MASK = (1 << 64) - 1


def reference_permutation(n: int, seed: int, epoch: int,
                          shuffle: bool = True) -> np.ndarray:
    """The batcher's sample order in `epoch` (0-based): XorShift
    (13, 7, 17) seeded with seed + 0x1000003 (epoch + 1) (0 -> the golden
    ratio constant), Fisher-Yates from the last index down, each draw
    bounded by rejection."""
    perm = list(range(n))
    if not shuffle:
        return np.asarray(perm, np.int64)
    state = (seed + 0x1000003 * (epoch + 1)) & _MASK or 0x9E3779B97F4A7C15

    def draw() -> int:
        nonlocal state
        state ^= (state << 13) & _MASK
        state ^= state >> 7
        state ^= (state << 17) & _MASK
        return state

    for i in range(n - 1, 0, -1):
        bound = i + 1
        lim = _MASK - (_MASK % bound)
        v = draw()
        while v >= lim:
            v = draw()
        j = v % bound
        perm[i], perm[j] = perm[j], perm[i]
    return np.asarray(perm, np.int64)


def reference_batches(n: int, batch_size: int, shuffle: bool = True,
                      seed: int = 0, drop_last: bool = True
                      ) -> Iterator[np.ndarray]:
    """The sample indices of each batch the batcher hands out, epoch after
    epoch: with drop_last, n // batch_size full batches an epoch; without,
    a short last batch."""
    epoch = 0
    while True:
        perm = reference_permutation(n, seed, epoch, shuffle)
        stop = n - n % batch_size if drop_last else n
        for i in range(0, stop, batch_size):
            yield perm[i:i + batch_size]
        epoch += 1

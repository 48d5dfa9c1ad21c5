"""Float32-exact mode for comparisons on the card.

By default torch runs float32 convolutions through cuDNN in TF32, which
keeps about three decimal digits; a comparison with the CPU or the JAX
package turns TF32 off. With TF32 off, cuDNN's heuristics pick an FFT
algorithm for some of NCSN++'s convolutions at batch >= 2, which holds
17 GiB and launches tens of thousands of small kernels per forward
(PERF.md). `float32_exact` therefore also turns on cuDNN's benchmark mode,
which times the algorithms once per shape and keeps the fastest; all of
them compute in float32.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN and matmul, cuDNN benchmark mode on; the previous
    settings are restored afterwards."""
    flags = (torch.backends.cudnn, "allow_tf32", False), \
        (torch.backends.cuda.matmul, "allow_tf32", False), \
        (torch.backends.cudnn, "benchmark", True)
    saved = [getattr(obj, name) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(flags, saved):
            setattr(obj, name, value)

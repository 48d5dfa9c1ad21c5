"""Fused bias + leaky ReLU on a hand-written CUDA kernel pair (K4).

Port of `fused_leaky_relu_pallas` in inverseproblemwithdiffusionmodel_tpu/
ops/pallas_kernels.py (forward body :50, custom VJP :80-98). No model calls
it, in the JAX package or here; it exists as a standalone op.

`fused_leaky_relu_kernel(x, bias)` is a `torch.autograd.Function` over
`flr_forward` and `flr_backward`: on a CUDA tensor these launch `flr_fwd_f32`
and `flr_bwd_f32`, or `flr_fwd_bf16` and `flr_bwd_bf16` for bf16 x and bias
(csrc/flr.cu, built by ops/_build.py), or raise; on a CPU tensor they run
the plain versions, `ops/fused_act.fused_leaky_relu` and
`fused_leaky_relu_bwd_plain`. The bf16 forms compute in float32 and round
once, like their plain versions. The bias gradient is a torch reduction
over the rows of dx on both devices, as JAX computes it in XLA. Launches
are counted in `LAUNCHES` ("flr_fwd", "flr_bwd"; ".bf16" appended in
bf16).
"""
from __future__ import annotations

import collections

import torch

from . import _build
from .fused_act import fused_leaky_relu

LAUNCHES: collections.Counter = collections.Counter()


def fused_leaky_relu_bwd_plain(x: torch.Tensor, bias: torch.Tensor,
                               g: torch.Tensor, negative_slope: float,
                               scale: float) -> torch.Tensor:
    """The backward kernel's plain version: g * (scale if x + b >= 0 else
    scale * slope), the factor multiplied in Python as in the JAX package.
    bf16 is computed in float32 and rounded to bf16 once."""
    compute = torch.promote_types(x.dtype, torch.float32)
    v = x.to(compute) + bias.to(compute)
    return (g.to(compute) * torch.where(v >= 0, scale, scale
                                        * negative_slope)).to(x.dtype)


# the kernels' dtypes: (C launcher suffix, LAUNCHES key suffix)
_DTYPES = {torch.float32: ("f32", ""), torch.bfloat16: ("bf16", ".bf16")}


def _check(x: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or bias.dtype != x.dtype:
        raise TypeError(f"fused_leaky_relu_kernel takes float32 or bfloat16 "
                        f"x and a bias of the same dtype, got {x.dtype} and "
                        f"{bias.dtype}")
    if x.ndim < 1 or bias.shape != (x.shape[-1],):
        raise ValueError(f"bias must have shape (C,) = ({x.shape[-1]},), "
                         f"got {tuple(bias.shape)} for x {tuple(x.shape)}")
    if x.device != bias.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x on {x.device} and bias on {bias.device}: both "
                         "must be on the CPU or on one CUDA device")


def _call(fn: str, *tensors: torch.Tensor, out: torch.Tensor, scalars
          ) -> torch.Tensor:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{fn}: the kernel takes contiguous tensors")
    if any(t.dtype != out.dtype for t in tensors) or out.dtype not in _DTYPES:
        raise TypeError(f"{fn}: float32 or bf16 tensors of one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    suffix, tag = _DTYPES[out.dtype]
    lib = _build.build().lib
    C = tensors[0].shape[-1]
    rows = tensors[0].numel() // C if C else 0
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = getattr(lib, f"{fn}_{suffix}")(*(t.data_ptr() for t in tensors),
                                            out.data_ptr(), rows, C, *scalars,
                                            stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
    LAUNCHES[fn + tag] += 1
    return out


def flr_forward(x: torch.Tensor, bias: torch.Tensor, negative_slope: float,
                scale: float) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, its plain version on a CPU one."""
    if x.device.type == "cpu":
        return fused_leaky_relu(x, bias, negative_slope, scale)
    return _call("flr_fwd", x, bias, out=torch.empty_like(x),
                 scalars=(negative_slope, scale))


def flr_backward(x: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                 negative_slope: float, scale: float) -> torch.Tensor:
    """dx: the backward kernel on a CUDA tensor, its plain version on a CPU
    one."""
    if x.device.type == "cpu":
        return fused_leaky_relu_bwd_plain(x, bias, g, negative_slope, scale)
    return _call("flr_bwd", x, bias, g, out=torch.empty_like(x),
                 scalars=(scale, scale * negative_slope))


class _FusedLeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.consts = (negative_slope, scale)
        return flr_forward(x, bias, negative_slope, scale)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx = flr_backward(x, bias, g.contiguous(), *ctx.consts)
        db = dx.reshape(-1, x.shape[-1]).sum(0) if ctx.needs_input_grad[1] \
            else None
        return dx, db, None, None


def fused_leaky_relu_kernel(x: torch.Tensor, bias: torch.Tensor,
                            negative_slope: float = 0.2,
                            scale: float = 2 ** 0.5) -> torch.Tensor:
    """y = scale * leaky_relu(x + bias); x (..., C) and bias (C,) float32,
    or both bf16."""
    _check(x, bias)
    return _FusedLeakyReLU.apply(x, bias, float(negative_slope), float(scale))

"""Fused bias + leaky ReLU, plain PyTorch.

Port of inverseproblemwithdiffusionmodel_tpu/ops/fused_act.py. It is the
plain version of the K4 kernels (ops/flr_kernels.py), which the tests and
chip_smoke.py hold the kernels against. No model of the port calls it.
"""
from __future__ import annotations

from typing import Optional

import torch


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5) -> torch.Tensor:
    """scale * leaky_relu(x + bias); x (..., C) channel-last, bias (C,)."""
    if bias is not None:
        x = x + bias
    return scale * torch.where(x >= 0, x, negative_slope * x)

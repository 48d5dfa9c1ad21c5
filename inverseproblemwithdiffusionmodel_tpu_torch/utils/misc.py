"""Batch collation for the training steps.

Port of `collate_batch` from inverseproblemwithdiffusionmodel_tpu/utils/
misc.py:146 (reference: helpers/load_data.py:324-369) for real-valued
data.
"""
from __future__ import annotations

import torch

MODES = ("real-valued", "mag", "complex", "real-imag", "real-imag-random")


def collate_batch(batch: torch.Tensor, mode: str = "real-valued"):
    """Prepare a real-valued batch (B, H, W, C) or (B, T, C) for a data mode:
    'real-valued' and 'mag' return it unchanged. The modes that add an
    imaginary part ('complex', 'real-imag', 'real-imag-random') are not
    ported yet and raise."""
    if mode not in MODES:
        raise ValueError(f"unknown data mode {mode!r}; one of {MODES}")
    if mode in ("real-valued", "mag"):
        return batch
    raise NotImplementedError(
        f"data mode {mode!r} (complex data) is not ported yet (ROADMAP: "
        "Slice A)")

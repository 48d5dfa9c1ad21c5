"""Annealed Langevin dynamics: the sampler parameters and the update step.

Port of `ALDConfig`, `_labels`, `_langevin_update`, the guidance
gradients `compute_clf_grad` / `compute_seg_grad` and the 2D+time ladders
(`interp_sigmas_T`, `interp_sigma_T_indices`, `setup_2d_time_ladders`)
from inverseproblemwithdiffusionmodel_tpu/samplers/ald.py (reference:
ncsn/models/ALD_optimizers.py:49-155 and 342-361,
ncsn/models/__init__.py:172-215). Randomness is injected: the update
takes its noise tensor, drawn by the caller from a `noise(shape)` function
(utils/device.gaussian_noise builds one from a seed and an explicit
torch.Generator), so a test can feed the JAX sampler's own draws.

Score function interface: `score_fn(x, labels) -> score`, labels an
integer (B,) tensor of ladder indices; models/registry.make_score_fn
builds one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ALDConfig:
    """Static sampler parameters (reference `params` dict,
    ALD_optimizers.py:50-56). snapshot_every > 0 calls the samplers'
    snapshot_fn every that-many levels."""
    n_steps_each: int = 3
    step_lr: float = 9e-7
    denoise: bool = True
    snapshot_every: int = 0


def _labels(x: torch.Tensor, c: int) -> torch.Tensor:
    return torch.full((x.shape[0],), c, dtype=torch.long, device=x.device)


def _langevin_update(x: torch.Tensor, grad: torch.Tensor,
                     step_size: torch.Tensor, noise: torch.Tensor
                     ) -> torch.Tensor:
    """x + s * grad + noise * sqrt(2 s), s a float32 tensor."""
    return x + step_size * grad + noise * torch.sqrt(step_size * 2.0)


# -- 2D+time ladders (host numpy: the level loop reads them on the host) ----

MODES_T = ("tv", "diffusion1d", "none", "diffusion1d-only", "tv-only")


def _n_overlap(sigmas_S: np.ndarray, sigmas_T: np.ndarray) -> int:
    n = int((sigmas_S <= sigmas_T[0]).sum())
    if n == 0:
        raise ValueError(
            f"temporal ladder (max {sigmas_T[0]:g}) lies entirely below "
            f"the spatial ladder (min {sigmas_S.min():g}); no level would "
            "run a temporal step - check sigma_begin_T/sigma_end_S")
    return n


def interp_sigmas_T(sigmas_S, sigmas_T) -> np.ndarray:
    """The temporal ladder nearest-interpolated onto the tail of the
    spatial ladder (the levels with sigma_S <= sigma_T[0]); earlier levels
    get the sentinel -1, no temporal step (reference:
    ALD_optimizers.py:342-345). float32."""
    sigmas_S, sigmas_T = np.asarray(sigmas_S), np.asarray(sigmas_T)
    n = _n_overlap(sigmas_S, sigmas_T)
    out = np.full(sigmas_S.shape, -1.0, dtype=np.float32)
    # torch F.interpolate(mode="nearest") from len L_T to len n
    out[-n:] = sigmas_T[(np.arange(n) * sigmas_T.shape[0] / n)
                        .astype(np.int64)]
    return out


def interp_sigma_T_indices(sigmas_S, sigmas_T) -> np.ndarray:
    """Per spatial level, the index into the RAW temporal ladder that the
    temporal net receives as its label (sigmas_T[idx[c]] ==
    interp_sigmas_T(...)[c] on active levels; 0 on inactive ones). The
    reference overwrites scorenet_T.sigmas with the interpolated ladder
    instead (ALD_optimizers.py:342-346). int32."""
    sigmas_S, sigmas_T = np.asarray(sigmas_S), np.asarray(sigmas_T)
    n = _n_overlap(sigmas_S, sigmas_T)
    out = np.zeros(sigmas_S.shape, dtype=np.int32)
    out[-n:] = (np.arange(n) * sigmas_T.shape[0] / n).astype(np.int32)
    return out


def setup_2d_time_ladders(sigmas, sigmas_T, mode_T: str
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(the ladder the levels run over, per-level sigma_T, per-level RAW
    temporal label), as numpy arrays on the host:

    - '*-only' modes run over the temporal ladder (reference:
      ALD_optimizers.py:355-361);
    - 'diffusion1d' interpolates sigmas_T onto the tail of the spatial
      ladder, sentinel -1 before it; the non-overlap ValueError applies;
    - 'tv' / 'none' read no temporal ladder: sentinels, and no overlap
      check.
    """
    if mode_T not in MODES_T:
        raise ValueError(f"unknown mode_T {mode_T!r}; one of {MODES_T}")
    sigmas = np.array(sigmas, np.float32)
    sigmas_T = np.array(sigmas_T, np.float32)
    if mode_T in ("diffusion1d-only", "tv-only"):
        return (sigmas_T, sigmas_T,
                np.arange(sigmas_T.shape[0], dtype=np.int32))
    if "diffusion1d" in mode_T:
        return (sigmas, interp_sigmas_T(sigmas, sigmas_T),
                interp_sigma_T_indices(sigmas, sigmas_T))
    return (sigmas, np.full(sigmas.shape, -1.0, np.float32),
            np.zeros(sigmas.shape, np.int32))



# -- guidance gradients -----------------------------------------------------
# The gradient with respect to x only: give the guidance net's parameters
# requires_grad=False, and the backward computes no weight gradient. Run
# these under torch.no_grad (or with grad enabled), not under
# torch.inference_mode, which no autograd can re-enter.

def _grad_of(logp: Callable[[torch.Tensor], torch.Tensor],
             x: torch.Tensor) -> torch.Tensor:
    if torch.is_inference_mode_enabled():
        raise RuntimeError("a guidance gradient needs autograd: call it "
                           "under torch.no_grad, not torch.inference_mode")
    with torch.enable_grad():
        x_in = x.detach().requires_grad_()
        (grad,) = torch.autograd.grad(logp(x_in), x_in)
    return grad


def compute_clf_grad(clf_fn: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """grad_x sum_b log_softmax(clf(x))[b, cls_b]."""
    def logp(x_in):
        logps = F.log_softmax(clf_fn(x_in), dim=-1)
        return torch.gather(logps, -1, cls.long()[:, None]).sum()

    return _grad_of(logp, x)


def compute_seg_grad(seg_fn: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor, label: torch.Tensor,
                     mode: str = "full") -> torch.Tensor:
    """grad_x sum log_softmax(seg(x)) gathered at the per-pixel target
    label. x: (B, H, W, C); label: (B, H, W) int; seg(x): (B, H, W, K)
    logits. mode 'FG' multiplies the gradient by the label, which masks it
    to the foreground of a 0/1 map."""
    if mode not in ("full", "FG"):
        raise ValueError(f"unknown seg guidance mode {mode!r} (full|FG)")

    def logp(x_in):
        logps = F.log_softmax(seg_fn(x_in), dim=-1)
        return torch.gather(logps, -1, label.long()[..., None]).sum()

    grad = _grad_of(logp, x)
    if mode == "FG":
        grad = grad * label[..., None].to(grad.dtype)
    return grad

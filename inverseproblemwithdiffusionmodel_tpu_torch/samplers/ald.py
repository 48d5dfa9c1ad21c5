"""Annealed Langevin dynamics: the sampler parameters and the update step.

Port of `ALDConfig`, `_labels`, `_langevin_update` and the guidance
gradients `compute_clf_grad` / `compute_seg_grad` from
inverseproblemwithdiffusionmodel_tpu/samplers/ald.py (reference:
ncsn/models/ALD_optimizers.py:49-155, ncsn/models/__init__.py:172-215).
Randomness is injected: the update
takes its noise tensor, drawn by the caller from a `noise(shape)` function
(utils/device.gaussian_noise builds one from a seed and an explicit
torch.Generator), so a test can feed the JAX sampler's own draws.

Score function interface: `score_fn(x, labels) -> score`, labels an
integer (B,) tensor of ladder indices; models/registry.make_score_fn
builds one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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

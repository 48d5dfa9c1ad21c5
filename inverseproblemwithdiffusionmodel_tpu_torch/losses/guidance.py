"""Noise-robust classifier and segmentation losses of the guidance nets.

Port of `_perturb` (:17), `clf_loss_with_perturbation` (:23),
`dice_ce_loss` (:44) and `seg_loss_with_perturbation` (:79) from
inverseproblemwithdiffusionmodel_tpu/losses/guidance.py (reference:
ncsn/losses/clf_loss.py:5-20, ncsn/losses/seg_loss.py:7-37). Channel-last:
images (B, H, W, C); seg labels (B, H, W) int; seg logits (B, H, W, K);
clf logits (B, K).

Each perturbed loss draws from `generator` on the images' device unless
the draws are given (tests feed the numbers JAX draws): the noise labels
first, then the noise.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def _perturb(X: torch.Tensor, sigmas: torch.Tensor, labels: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """X + noise * sigmas[labels], one sigma per sample."""
    used = sigmas[labels].reshape(X.shape[0], *([1] * (X.ndim - 1)))
    return X + noise * used


def perturb_draws(X: torch.Tensor, num_levels: int,
                  generator: Optional[torch.Generator] = None,
                  labels: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None):
    """The classifier loss's draws, in order, each kept where given: labels
    ~ U{0..num_levels-1} per sample, then noise ~ N(0, 1) shaped like X."""
    if labels is None:
        labels = torch.randint(0, num_levels, (X.shape[0],),
                               generator=generator, device=X.device)
    if noise is None:
        noise = torch.randn(X.shape, generator=generator, dtype=X.dtype,
                            device=X.device)
    return labels, noise


def seg_draws(X: torch.Tensor, num_levels: int,
              generator: Optional[torch.Generator] = None,
              labels: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None):
    """The perturbed seg loss's draws, in order, each kept where given: one
    noise label shared by the batch (expanded to (B,)), then noise ~ N(0,
    1) shaped like X."""
    if labels is None:
        labels = torch.randint(0, num_levels, (1,), generator=generator,
                               device=X.device).expand(X.shape[0])
    return perturb_draws(X, num_levels, generator, labels, noise)


def clf_loss_with_perturbation(
    clf_fn: Callable[[torch.Tensor], torch.Tensor],
    X: torch.Tensor,
    y: torch.Tensor,
    sigmas: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    labels: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of clf_fn on X perturbed at sigma[labels], labels ~
    U{0..L-1} per sample. Returns (loss, logits)."""
    labels, noise = perturb_draws(X, sigmas.shape[0], generator, labels,
                                  noise)
    logits = clf_fn(_perturb(X, sigmas, labels, noise=noise))
    logp = F.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, y.long()[:, None]).mean()
    return loss, logits


def dice_ce_terms(logits: torch.Tensor, y: torch.Tensor,
                  include_background: bool = False,
                  squared_pred: bool = True):
    """dice_ce_loss's terms: (ce, intersection, denom), the cross-entropy
    averaged over batch and pixels, and the Dice term's per-class sums
    over batch and pixels (the background left out unless
    `include_background`). A data-parallel step sums the two per-class
    sums over its ranks before `dice_term` (training/train.py)."""
    num_cls = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(y.long(), num_cls).to(logits.dtype)
    logp = F.log_softmax(logits, dim=-1)
    ce = -torch.mean(torch.sum(onehot * logp, dim=-1))

    start = 0 if include_background else 1
    p, g = probs[..., start:], onehot[..., start:]
    dims = tuple(range(p.ndim - 1))                  # all but the class axis
    intersection = torch.sum(p * g, dim=dims)
    if squared_pred:
        denom = torch.sum(p ** 2, dim=dims) + torch.sum(g ** 2, dim=dims)
    else:
        denom = torch.sum(p, dim=dims) + torch.sum(g, dim=dims)
    return ce, intersection, denom


def dice_term(intersection: torch.Tensor, denom: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """1 - the class mean of (2 intersection + eps) / (denom + eps)."""
    return 1.0 - torch.mean((2.0 * intersection + eps) / (denom + eps))


def dice_ce_loss(
    logits: torch.Tensor,
    y: torch.Tensor,
    include_background: bool = False,
    squared_pred: bool = True,
    lambda_ce: float = 0.5,
    lambda_dice: float = 0.5,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Dice + cross-entropy, MONAI's DiceCELoss(include_background=False,
    softmax=True, squared_pred=True, batch=True) as the reference configures
    it (ncsn/losses/seg_loss.py:24-32): the cross-entropy is the mean over
    batch and pixels; the Dice term sums over batch and pixels jointly, per
    class, and averages over the classes (the background left out).

    logits: (B, H, W, K); y: (B, H, W) int labels."""
    ce, intersection, denom = dice_ce_terms(logits, y, include_background,
                                            squared_pred)
    return lambda_ce * ce + lambda_dice * dice_term(intersection, denom, eps)


def seg_loss_with_perturbation(
    seg_fn: Callable[[torch.Tensor], torch.Tensor],
    X: torch.Tensor,
    y: torch.Tensor,
    sigmas: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    labels: Optional[torch.Tensor] = None,
    perturb: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DiceCE of seg_fn on X, with one noise label shared by the batch.
    The reference disables the input perturbation (seg_loss.py:20,
    `X_perturbed = X`), as `perturb=False` does here; then nothing is
    drawn (JAX draws the label and does not use it). Returns (loss,
    logits)."""
    if perturb:
        labels, noise = seg_draws(X, sigmas.shape[0], generator, labels,
                                  noise)
        X = _perturb(X, sigmas, labels, noise=noise)
    logits = seg_fn(X)
    return dice_ce_loss(logits, y), logits

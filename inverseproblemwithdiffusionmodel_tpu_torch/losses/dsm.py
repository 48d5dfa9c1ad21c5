"""Denoising score-matching losses.

Port of `anneal_dsm_score_estimation` (:24, reference semantics:
ncsn/losses/dsm.py:3-19) and `continuous_dsm_loss` (:60, reference:
helpers/losses.py:7-24) from inverseproblemwithdiffusionmodel_tpu/losses/
dsm.py.

Each loss makes two draws from `generator` on the samples' device unless
they are injected (tests feed the numbers JAX draws): the discrete loss
labels ~ U{0..L-1} of shape (B,), then noise ~ N(0, 1) shaped like the
samples; the continuous loss t ~ U(eps, T) of shape (B,), then z ~ N(0, 1).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) matching `like`'s rank."""
    return v.reshape(v.shape[0], *([1] * (like.ndim - 1)))


def dsm_draws(samples: torch.Tensor, num_levels: int,
              generator: Optional[torch.Generator] = None,
              labels: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None):
    """The discrete loss's draws, in order, each kept where given: labels ~
    U{0..num_levels-1} of shape (B,), then noise ~ N(0, 1) shaped like
    the samples. A data-parallel step draws them for the global batch and
    takes its rows (training/train.py)."""
    if labels is None:
        labels = torch.randint(0, num_levels, (samples.shape[0],),
                               generator=generator, device=samples.device)
    if noise is None:
        noise = torch.randn(samples.shape, generator=generator,
                            dtype=samples.dtype, device=samples.device)
    return labels, noise


def continuous_draws(samples: torch.Tensor, T: float, eps: float = 1e-5,
                     generator: Optional[torch.Generator] = None,
                     t: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None):
    """The continuous loss's draws, in order, each kept where given: t ~
    U(eps, T) of shape (B,), then z ~ N(0, 1) shaped like the samples."""
    if t is None:
        t = torch.rand(samples.shape[0], generator=generator,
                       dtype=samples.dtype, device=samples.device) * (
                           T - eps) + eps
    if z is None:
        z = torch.randn(samples.shape, generator=generator,
                        dtype=samples.dtype, device=samples.device)
    return t, z


def anneal_dsm_score_estimation(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    samples: torch.Tensor,
    sigmas: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    labels: Optional[torch.Tensor] = None,
    anneal_power: float = 2.0,
    sample_weight: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Discrete annealed DSM loss, a scalar tensor.

    score_fn(x, labels) -> score; samples (B, *feature); sigmas (L,) on
    the samples' device. Perturb with sigma[labels], target -noise /
    sigma^2, per-sample loss 0.5 * sum((score - target)^2) *
    sigma^anneal_power, averaged over the batch, or weighted by
    `sample_weight` (B,) and divided by its sum (at least 1e-12): the
    foreground filter of the 1-D tubes.
    """
    B = samples.shape[0]
    labels, noise = dsm_draws(samples, sigmas.shape[0], generator, labels,
                              noise)
    used_sigmas = _expand(sigmas[labels], samples)
    noise = noise * used_sigmas
    target = -noise / used_sigmas ** 2
    scores = score_fn(samples + noise, labels)
    sq = torch.sum((scores - target).reshape(B, -1) ** 2, dim=-1)
    loss = 0.5 * sq * sigmas[labels] ** anneal_power
    if sample_weight is not None:
        return torch.sum(loss * sample_weight) / torch.clamp(
            torch.sum(sample_weight), min=1e-12)
    return loss.mean()


def continuous_dsm_loss(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sde,
    samples: torch.Tensor,
    eps: float = 1e-5,
    reduce_mean: bool = True,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Continuous DSM loss, a scalar tensor.

    reduce_mean=True: mean of (s(x_t, t) + z / std)^2 over features and
    batch, the reference's training loss. reduce_mean=False: mean over the
    batch of 0.5 * the per-sample sum of (s * std + z)^2, score_sde's
    sigma^2-weighted convention (`training.reduce_mean=False`).
    """
    B = samples.shape[0]
    t, z = continuous_draws(samples, sde.T, eps, generator, t, z)
    mean, std = sde.marginal_prob(samples, t)
    std = _expand(std, z)
    perturbed = mean + z * std
    score = score_fn(perturbed, t)
    if reduce_mean:
        return torch.mean((score + z / std) ** 2)
    sq = (score * std + z) ** 2
    return torch.mean(0.5 * torch.sum(sq.reshape(B, -1), dim=-1))

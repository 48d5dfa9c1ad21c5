"""Continuous-time denoising score matching.

Port of `continuous_dsm_loss` from inverseproblemwithdiffusionmodel_tpu/
losses/dsm.py:60 (reference semantics: helpers/losses.py:7-24). The discrete
annealed loss (`anneal_dsm_score_estimation`) belongs to ROADMAP Slice E.

The two draws, t ~ U(eps, T) of shape (B,) and z ~ N(0, 1) shaped like the
samples, come from `generator` on the samples' device, t first, unless they
are injected: tests feed the numbers JAX draws.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) matching `like`'s rank."""
    return v.reshape(v.shape[0], *([1] * (like.ndim - 1)))


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
    if t is None:
        t = torch.rand(B, generator=generator, dtype=samples.dtype,
                       device=samples.device) * (sde.T - eps) + eps
    if z is None:
        z = torch.randn(samples.shape, generator=generator,
                        dtype=samples.dtype, device=samples.device)
    mean, std = sde.marginal_prob(samples, t)
    std = _expand(std, z)
    perturbed = mean + z * std
    score = score_fn(perturbed, t)
    if reduce_mean:
        return torch.mean((score + z / std) ** 2)
    sq = (score * std + z) ** 2
    return torch.mean(0.5 * torch.sum(sq.reshape(B, -1), dim=-1))

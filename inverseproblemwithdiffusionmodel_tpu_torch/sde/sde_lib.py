"""Continuous-time SDEs: the abstract forward SDE, its reverse, and the VP,
subVP and VE SDEs.

Port of inverseproblemwithdiffusionmodel_tpu/sde/sde_lib.py (SDE :28,
ReverseSDE :63, get_ddpm_params :95, _DiscreteBetaSchedule :121, VPSDE
:145, subVPSDE :190, VESDE :224). Time `t` is a float32 tensor of shape
(B,); each per-sample scalar is broadcast over the image dimensions.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Noise = Callable[[Sequence[int]], torch.Tensor]


def _expand(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], *([1] * (like.ndim - 1)))


def linspace_f32(start: float, stop: float, num: int) -> torch.Tensor:
    """The float32 grid of `jnp.linspace(start, stop, num)`, on the CPU.

    The sampler casts t * (N - 1) to an integer ladder index, and at some
    steps t * (N - 1) is an integer in exact arithmetic (N - 1 - i (1 - eps)
    at every 1000th step for eps = 1e-3), so one ulp of t picks the sigma.
    torch.linspace rounds such a step the other way from JAX. This grid is
    computed in float64 from the float32 end points and rounded once. XLA's
    float32 arithmetic lands within one ulp of 1.0 of it and on the same
    side at those steps, so the indices agree with JAX's at every step
    (tests/test_torch_sde_sampling.py).
    """
    start64 = float(torch.tensor(start, dtype=torch.float32))
    stop64 = float(torch.tensor(stop, dtype=torch.float32))
    if num == 1:
        return torch.tensor([start64], dtype=torch.float32)
    frac = torch.arange(num, dtype=torch.float64) / (num - 1)
    out = (start64 * (1 - frac) + stop64 * frac).to(torch.float32)
    out[-1] = stop64
    return out


@dataclasses.dataclass(frozen=True)
class SDE:
    """Abstract forward SDE dx = f(x,t) dt + g(t) dw on t in [0, T]."""
    N: int = 1000

    @property
    def T(self) -> float:
        return 1.0

    def sde(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def marginal_prob(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and std of p_t(x_t | x_0)."""
        raise NotImplementedError

    def prior_sampling(self, noise: Noise, shape) -> torch.Tensor:
        raise NotImplementedError

    def prior_logp(self, z: torch.Tensor) -> torch.Tensor:
        """log p_T(z) of the prior, per sample."""
        raise NotImplementedError

    def discretize(self, x, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Euler-Maruyama one-step discretization x_{i+1} = x_i + f + G z.
        Returns (f, G)."""
        dt = self.T / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)

    def reverse(self, score_fn: ScoreFn,
                probability_flow: bool = False) -> "ReverseSDE":
        return ReverseSDE(self, score_fn, probability_flow)


@dataclasses.dataclass(frozen=True)
class ReverseSDE:
    """Reverse-time SDE / probability-flow ODE of a forward SDE."""
    fwd: SDE
    score_fn: ScoreFn
    probability_flow: bool = False

    @property
    def N(self) -> int:
        return self.fwd.N

    @property
    def T(self) -> float:
        return self.fwd.T

    def sde(self, x, t):
        drift, diffusion = self.fwd.sde(x, t)
        score = self.score_fn(x, t)
        factor = 0.5 if self.probability_flow else 1.0
        drift = drift - _expand(diffusion ** 2, x) * score * factor
        if self.probability_flow:
            diffusion = torch.zeros_like(diffusion)
        return drift, diffusion

    def discretize(self, x, t):
        f, G = self.fwd.discretize(x, t)
        score = self.score_fn(x, t)
        factor = 0.5 if self.probability_flow else 1.0
        rev_f = f - _expand(G ** 2, x) * score * factor
        rev_G = torch.zeros_like(G) if self.probability_flow else G
        return rev_f, rev_G


def _std_normal_logp(z: torch.Tensor, var: float = 1.0) -> torch.Tensor:
    """log N(z; 0, var I) per sample, as the JAX package writes it."""
    D = int(np.prod(z.shape[1:]))
    return (-D / 2.0 * math.log(2 * math.pi * var)
            - torch.sum(z.reshape(z.shape[0], -1) ** 2, dim=-1) / (2.0 * var))


def get_ddpm_params(beta_min: float = 0.1, beta_max: float = 20.0,
                    num_scales: int = 1000) -> dict:
    """The discrete DDPM schedule (betas, alphas, cumulative products, their
    square roots), computed in float64 numpy and cast to float32 once, as
    the JAX package does. The ladder has 1000 steps whatever num_scales,
    and the returned beta_min / beta_max are the start / end rates times
    the last index, as the JAX package (and score_sde) computes them."""
    n = 1000
    beta_start = beta_min / num_scales
    beta_end = beta_max / num_scales
    betas = np.linspace(beta_start, beta_end, n, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    return {
        "betas": f32(betas), "alphas": f32(alphas),
        "alphas_cumprod": f32(alphas_cumprod),
        "sqrt_alphas_cumprod": f32(np.sqrt(alphas_cumprod)),
        "sqrt_1m_alphas_cumprod": f32(np.sqrt(1.0 - alphas_cumprod)),
        "beta_min": beta_start * (n - 1), "beta_max": beta_end * (n - 1),
        "num_diffusion_timesteps": n,
    }


@functools.lru_cache(maxsize=None)
def _beta_ladder(beta_min: float, beta_max: float, N: int,
                 device: torch.device) -> Tuple[torch.Tensor, ...]:
    # betas = jnp.linspace(beta_min / N, beta_max / N, N) in float32 (the
    # port's linspace_f32: torch.linspace rounds other steps than XLA);
    # alphas = 1 - betas; their cumulative product in float32, as
    # jnp.cumprod. Built once per device.
    betas = linspace_f32(beta_min / N, beta_max / N, N)
    alphas = 1.0 - betas
    return (betas.to(device), alphas.to(device),
            torch.cumprod(alphas, 0).to(device))


class _DiscreteBetaSchedule:
    """The DDPM beta ladder that VP and subVP share: the discretization,
    the ancestral predictor, the correctors' alphas and the discrete score
    conversion read it. (score_sde's subVPSDE has none, which crashes its
    correctors; the JAX package gives subVP the ladder, and so does the
    port.) Each method takes the device to build the ladder on."""

    def discrete_betas(self, device=None) -> torch.Tensor:
        return _beta_ladder(self.beta_min, self.beta_max, self.N,
                            torch.device(device or "cpu"))[0]

    def alphas(self, device=None) -> torch.Tensor:
        return _beta_ladder(self.beta_min, self.beta_max, self.N,
                            torch.device(device or "cpu"))[1]

    def alphas_cumprod(self, device=None) -> torch.Tensor:
        return _beta_ladder(self.beta_min, self.beta_max, self.N,
                            torch.device(device or "cpu"))[2]


def _log_mean_coeff(sde, t: torch.Tensor) -> torch.Tensor:
    return (-0.25 * t ** 2 * (sde.beta_max - sde.beta_min)
            - 0.5 * t * sde.beta_min)


@dataclasses.dataclass(frozen=True)
class VPSDE(SDE, _DiscreteBetaSchedule):
    """Variance-preserving (DDPM) SDE with a linear beta schedule."""
    beta_min: float = 0.1
    beta_max: float = 20.0

    def _beta(self, t: torch.Tensor) -> torch.Tensor:
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x, t):
        beta_t = self._beta(t)
        drift = -0.5 * _expand(beta_t, x) * x
        return drift, torch.sqrt(beta_t)

    def marginal_prob(self, x, t):
        lmc = _log_mean_coeff(self, t)
        mean = _expand(torch.exp(lmc), x) * x
        std = torch.sqrt(1.0 - torch.exp(2.0 * lmc))
        return mean, std

    def prior_sampling(self, noise: Noise, shape) -> torch.Tensor:
        return noise(shape)

    def prior_logp(self, z):
        return _std_normal_logp(z)

    def discretize(self, x, t):
        """DDPM ancestral discretization on the integer ladder index."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int64)
        beta = self.discrete_betas(t.device)[timestep]
        alpha = 1.0 - beta
        f = _expand(torch.sqrt(alpha), x) * x - x
        return f, torch.sqrt(beta)


@dataclasses.dataclass(frozen=True)
class subVPSDE(SDE, _DiscreteBetaSchedule):
    """Sub-VP SDE (score_sde's likelihood SDE)."""
    beta_min: float = 0.1
    beta_max: float = 20.0

    def _beta(self, t: torch.Tensor) -> torch.Tensor:
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def sde(self, x, t):
        beta_t = self._beta(t)
        drift = -0.5 * _expand(beta_t, x) * x
        integral = (self.beta_min * t
                    + 0.5 * t ** 2 * (self.beta_max - self.beta_min))
        discount = 1.0 - torch.exp(-2.0 * integral)
        return drift, torch.sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        lmc = _log_mean_coeff(self, t)
        mean = _expand(torch.exp(lmc), x) * x
        # no square root: score_sde's definition of the subVP std, which
        # the JAX package keeps
        std = 1.0 - torch.exp(2.0 * lmc)
        return mean, std

    def prior_sampling(self, noise: Noise, shape) -> torch.Tensor:
        return noise(shape)

    def prior_logp(self, z):
        return _std_normal_logp(z)


@functools.lru_cache(maxsize=None)
def _ve_ladder(sigma_min: float, sigma_max: float, N: int,
               device: torch.device) -> torch.Tensor:
    # Built once per device, so a sampling step copies nothing to the card.
    return torch.exp(linspace_f32(math.log(sigma_min), math.log(sigma_max),
                                  N)).to(device)


@dataclasses.dataclass(frozen=True)
class VESDE(SDE):
    """Variance-exploding (SMLD) SDE with geometric sigma(t)."""
    sigma_min: float = 0.01
    sigma_max: float = 50.0

    def _sigma(self, t: torch.Tensor) -> torch.Tensor:
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def discrete_sigmas(self, device=None) -> torch.Tensor:
        """Ascending ladder sigma_min -> sigma_max, float32."""
        return _ve_ladder(self.sigma_min, self.sigma_max, self.N,
                          torch.device(device or "cpu"))

    def sde(self, x, t):
        diffusion = self._sigma(t) * math.sqrt(
            2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self._sigma(t)

    def prior_sampling(self, noise: Noise, shape) -> torch.Tensor:
        return noise(shape) * self.sigma_max

    def prior_logp(self, z):
        return _std_normal_logp(z, self.sigma_max ** 2)

    def discretize(self, x, t):
        """SMLD ancestral discretization on the integer ladder index."""
        timestep = (t * (self.N - 1) / self.T).to(torch.int64)
        sigmas = self.discrete_sigmas(t.device)
        sigma = sigmas[timestep]
        adjacent = torch.where(timestep == 0, torch.zeros_like(sigma),
                               sigmas[(timestep - 1).clamp(min=0)])
        G = torch.sqrt(sigma ** 2 - adjacent ** 2)
        return torch.zeros_like(x), G

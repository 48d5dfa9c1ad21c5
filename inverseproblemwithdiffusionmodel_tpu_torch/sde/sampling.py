"""Predictor-corrector and probability-flow ODE sampling for the
continuous SDE stack.

Port of inverseproblemwithdiffusionmodel_tpu/sde/sampling.py:
`get_score_fn` (VP, subVP and VE), the Euler-Maruyama, reverse-diffusion,
ancestral and none predictors, the Langevin, annealed-Langevin (`ald`) and
none correctors, `get_pc_sampler`, `vanilla_pc_sampler`,
`get_ode_sampler` (on sde/odeint.py, the JAX package's adaptive
Dormand-Prince) and `get_sampling_fn` (pc and ode).

Randomness comes from a noise source, a callable `(shape) -> tensor` of
standard normal draws. The sampler draws from a seeded `torch.Generator` on
its device unless one is injected; tests inject the draws of the JAX
sampler. Draws happen in the JAX sampler's order: the prior, then for each
step the corrector's `n_steps` draws and then the predictor's.
The time loop is a Python loop over the float32 time grid, which is
`jnp.linspace(T, eps, N)` bit for bit (sde_lib.linspace_f32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from .odeint import odeint
from .sde_lib import SDE, VESDE, VPSDE, ReverseSDE, Noise, ScoreFn, \
    _expand, linspace_f32, subVPSDE
from ..utils.device import gaussian_noise


def get_score_fn(sde: SDE, model_fn: Callable[[torch.Tensor, torch.Tensor],
                                                torch.Tensor],
                 continuous: bool = True) -> ScoreFn:
    """Convert a raw network into a score function.
    VP / subVP: the score is -output / std, the network conditioned on
    t * 999 with the marginal std (continuous, and subVP always), or on
    t * (N - 1) with std sqrt(1 - alphas_cumprod[int(label)]) (discrete
    VP). VE: the network output is the score, conditioned on sigma(t)
    (continuous) or on the descending-ladder index (discrete)."""
    if isinstance(sde, (VPSDE, subVPSDE)):
        def score_fn(x, t):
            if continuous or isinstance(sde, subVPSDE):
                labels = t * 999
                _, std = sde.marginal_prob(torch.zeros_like(x), t)
            else:
                labels = t * (sde.N - 1)
                std = torch.sqrt(1.0 - sde.alphas_cumprod(t.device)[
                    labels.to(torch.int64)])
            return -model_fn(x, labels) / _expand(std, x)
        return score_fn
    if isinstance(sde, VESDE):
        def score_fn(x, t):
            if continuous:
                _, cond = sde.marginal_prob(torch.zeros_like(x), t)
            else:
                cond = torch.round((sde.T - t) * (sde.N - 1)).to(torch.int32)
            return model_fn(x, cond)
        return score_fn
    raise NotImplementedError(f"SDE {type(sde).__name__} not supported")


# ---------------------------------------------------------------------------
# predictors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Predictor:
    sde: SDE
    score_fn: ScoreFn
    probability_flow: bool = False

    @property
    def rsde(self) -> ReverseSDE:
        return self.sde.reverse(self.score_fn, self.probability_flow)

    def update_fn(self, noise: Noise, x, t) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        """Returns (x, x_mean)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class EulerMaruyamaPredictor(Predictor):
    def update_fn(self, noise, x, t):
        dt = -self.sde.T / self.sde.N
        z = noise(x.shape)
        drift, diffusion = self.rsde.sde(x, t)
        x_mean = x + drift * dt
        return x_mean + _expand(diffusion, x) * math.sqrt(-dt) * z, x_mean


@dataclasses.dataclass(frozen=True)
class ReverseDiffusionPredictor(Predictor):
    def update_fn(self, noise, x, t):
        f, G = self.rsde.discretize(x, t)
        z = noise(x.shape)
        x_mean = x - f
        return x_mean + _expand(G, x) * z, x_mean


@dataclasses.dataclass(frozen=True)
class AncestralSamplingPredictor(Predictor):
    """SMLD / DDPM ancestral sampling; defined for VE and VP (not subVP)
    without probability flow."""

    def update_fn(self, noise, x, t):
        sde = self.sde
        z = noise(x.shape)
        timestep = (t * (sde.N - 1) / sde.T).to(torch.int64)
        if isinstance(sde, VESDE):
            sigmas = sde.discrete_sigmas(t.device)
            sigma = sigmas[timestep]
            adjacent = torch.where(timestep == 0, torch.zeros_like(sigma),
                                   sigmas[(timestep - 1).clamp(min=0)])
            score = self.score_fn(x, t)
            x_mean = x + _expand(sigma ** 2 - adjacent ** 2, x) * score
            std = torch.sqrt(adjacent ** 2 * (sigma ** 2 - adjacent ** 2)
                             / (sigma ** 2).clamp(min=1e-20))
            return x_mean + _expand(std, x) * z, x_mean
        if isinstance(sde, VPSDE):
            beta = sde.discrete_betas(t.device)[timestep]
            score = self.score_fn(x, t)
            x_mean = (x + _expand(beta, x) * score) / _expand(
                torch.sqrt(1.0 - beta), x)
            return x_mean + _expand(torch.sqrt(beta), x) * z, x_mean
        raise NotImplementedError(
            f"ancestral sampling for {type(sde).__name__}")


@dataclasses.dataclass(frozen=True)
class NonePredictor(Predictor):
    def update_fn(self, noise, x, t):
        return x, x


# ---------------------------------------------------------------------------
# correctors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Corrector:
    sde: SDE
    score_fn: ScoreFn
    snr: float = 0.16
    n_steps: int = 1

    def _alpha(self, t: torch.Tensor) -> torch.Tensor:
        # VP and subVP read the discrete alphas at the ladder index; VE 1.
        if isinstance(self.sde, (VPSDE, subVPSDE)):
            timestep = (t * (self.sde.N - 1) / self.sde.T).to(torch.int64)
            return self.sde.alphas(t.device)[timestep]
        return torch.ones_like(t)

    def update_fn(self, noise: Noise, x, t):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LangevinCorrector(Corrector):
    """SNR-scaled Langevin MCMC."""

    def update_fn(self, noise, x, t):
        alpha = self._alpha(t)
        x_mean = x
        for _ in range(self.n_steps):
            grad = self.score_fn(x, t)
            z = noise(x.shape)
            grad_norm = torch.linalg.vector_norm(
                grad.reshape(grad.shape[0], -1), dim=-1).mean()
            noise_norm = torch.linalg.vector_norm(
                z.reshape(z.shape[0], -1), dim=-1).mean()
            step_size = (self.snr * noise_norm / grad_norm.clamp(min=1e-20)
                         ) ** 2 * 2.0 * alpha
            x_mean = x + _expand(step_size, x) * grad
            x = x_mean + _expand(torch.sqrt(step_size * 2.0), x) * z
        return x, x_mean


@dataclasses.dataclass(frozen=True)
class AnnealedLangevinDynamics(Corrector):
    """NCSNv2-style annealed Langevin corrector: the step follows the
    marginal std at t."""

    def update_fn(self, noise, x, t):
        alpha = self._alpha(t)
        _, std = self.sde.marginal_prob(x, t)
        step_size = (self.snr * std) ** 2 * 2.0 * alpha
        x_mean = x
        for _ in range(self.n_steps):
            grad = self.score_fn(x, t)
            z = noise(x.shape)
            x_mean = x + _expand(step_size, x) * grad
            x = x_mean + _expand(torch.sqrt(step_size * 2.0), x) * z
        return x, x_mean


@dataclasses.dataclass(frozen=True)
class NoneCorrector(Corrector):
    def update_fn(self, noise, x, t):
        return x, x


_PREDICTORS = {"euler_maruyama": EulerMaruyamaPredictor,
               "reverse_diffusion": ReverseDiffusionPredictor,
               "ancestral_sampling": AncestralSamplingPredictor,
               "none": NonePredictor}
_CORRECTORS = {"langevin": LangevinCorrector,
               "ald": AnnealedLangevinDynamics, "none": NoneCorrector}


def register_predictor(cls=None, *, name=None):
    """Register a predictor class under `name` (default its class name),
    as a bare decorator or with name= (reference: sde/sampling.py:38-54);
    get_predictor and get_pc_sampler then find it by name."""
    def _register(cls):
        _PREDICTORS[name or cls.__name__] = cls
        return cls
    return _register(cls) if cls is not None else _register


def register_corrector(cls=None, *, name=None):
    """`register_predictor` for correctors."""
    def _register(cls):
        _CORRECTORS[name or cls.__name__] = cls
        return cls
    return _register(cls) if cls is not None else _register


def get_predictor(name: str):
    if name not in _PREDICTORS:
        raise KeyError(f"unknown predictor {name!r}; registered: "
                       f"{sorted(_PREDICTORS)}")
    return _PREDICTORS[name]


def get_corrector(name: str):
    if name not in _CORRECTORS:
        raise KeyError(f"unknown corrector {name!r}; registered: "
                       f"{sorted(_CORRECTORS)}")
    return _CORRECTORS[name]


# ---------------------------------------------------------------------------
# PC sampler
# ---------------------------------------------------------------------------

def get_pc_sampler(
    sde: SDE,
    shape: Tuple[int, ...],
    predictor: str = "reverse_diffusion",
    corrector: str = "langevin",
    snr: float = 0.16,
    n_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-3,
    inverse_scaler: Callable[[torch.Tensor], torch.Tensor] = lambda x: x,
    device="cuda",
):
    """Build `sampler(score_fn, seed=0, noise=None, x_init=None) ->
    (x, nfe)`. Call it under torch.no_grad()."""
    device = torch.device(device)
    pred_cls = get_predictor(predictor)
    corr_cls = get_corrector(corrector)

    def sampler(score_fn: ScoreFn, seed: int = 0,
                noise: Optional[Noise] = None,
                x_init: Optional[torch.Tensor] = None):
        if noise is None:
            noise = gaussian_noise(seed, device)
        pred = pred_cls(sde=sde, score_fn=score_fn,
                        probability_flow=probability_flow)
        corr = corr_cls(sde=sde, score_fn=score_fn, snr=snr, n_steps=n_steps)
        x = sde.prior_sampling(noise, shape) if x_init is None else x_init
        x_mean = x
        for t in linspace_f32(sde.T, eps, sde.N).tolist():
            vec_t = torch.full((shape[0],), t, dtype=torch.float32,
                               device=device)
            x, x_mean = corr.update_fn(noise, x, vec_t)
            x, x_mean = pred.update_fn(noise, x, vec_t)
        out = x_mean if denoise else x
        return inverse_scaler(out), sde.N * (n_steps + 1)

    return sampler


def vanilla_pc_sampler(score_fn: ScoreFn, sde: SDE, shape, seed: int = 0,
                       noise: Optional[Noise] = None, **kwargs):
    """One-call PC sampling: get_pc_sampler(sde, shape, **kwargs) run on
    score_fn. Returns (x, nfe)."""
    return get_pc_sampler(sde, shape, **kwargs)(score_fn, seed=seed,
                                                noise=noise)


def get_ode_sampler(
    sde: SDE,
    shape: Tuple[int, ...],
    denoise: bool = False,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    eps: float = 1e-3,
    inverse_scaler: Callable[[torch.Tensor], torch.Tensor] = lambda x: x,
    device="cuda",
):
    """Build `sampler(score_fn, seed=0, noise=None, x_init=None,
    stats=None) -> (x, sde.N)`: the probability-flow ODE integrated in s
    from 0 to T - eps along t = T - s (odeint, rtol / atol), from a prior
    draw or `x_init`; `denoise` then takes the reverse-diffusion
    predictor's mean at t = eps. Like the JAX sampler it returns sde.N as
    its count, not the evaluations it made; `stats` (a dict) receives
    odeint's counts. Call it under torch.no_grad()."""
    device = torch.device(device)

    def sampler(score_fn: ScoreFn, seed: int = 0,
                noise: Optional[Noise] = None,
                x_init: Optional[torch.Tensor] = None,
                stats: Optional[dict] = None):
        if noise is None:
            noise = gaussian_noise(seed, device)
        x = sde.prior_sampling(noise, shape) if x_init is None else x_init
        rsde = sde.reverse(score_fn, probability_flow=True)

        def ode_func(x, s):
            vec_t = (sde.T - s).reshape(1).repeat(x.shape[0])
            drift, _ = rsde.sde(x, vec_t)
            return -drift

        ts = torch.tensor([0.0, sde.T - eps], dtype=torch.float32,
                          device=device)
        x = odeint(ode_func, x, ts, rtol=rtol, atol=atol, stats=stats)[-1]
        if denoise:
            pred = ReverseDiffusionPredictor(sde=sde, score_fn=score_fn)
            vec_eps = torch.full((x.shape[0],), eps, dtype=torch.float32,
                                 device=device)
            _, x = pred.update_fn(noise, x, vec_eps)
        return inverse_scaler(x), sde.N

    return sampler


def get_sampling_fn(config, sde: SDE, shape, eps: float = 1e-3,
                    inverse_scaler=lambda x: x, device="cuda"):
    method = config.sampling.method.lower()
    if method == "ode":
        return get_ode_sampler(sde, shape,
                               denoise=config.sampling.noise_removal,
                               eps=eps, inverse_scaler=inverse_scaler,
                               device=device)
    if method == "pc":
        return get_pc_sampler(
            sde, shape,
            predictor=config.sampling.predictor.lower(),
            corrector=config.sampling.corrector.lower(),
            snr=config.sampling.snr,
            n_steps=config.sampling.n_steps_each,
            probability_flow=config.sampling.probability_flow,
            denoise=config.sampling.noise_removal,
            eps=eps, inverse_scaler=inverse_scaler, device=device)
    raise ValueError(f"unknown sampling method {config.sampling.method!r}")

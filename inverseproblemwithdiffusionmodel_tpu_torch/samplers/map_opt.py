"""MAP reconstruction with a score prior, and TV-regularized least squares.

Port of inverseproblemwithdiffusionmodel_tpu/samplers/map_opt.py
(reference: ncsn/models/MAP_optimizers.py, MAPOptimizer :55-116,
SENSEMAP / Inpainting :119-124, MAPOptimizer2DTime :154-337; the TV
baseline of scripts/acdc_SENSE_TV.py, MAPModel in helpers/pl_helpers.py:
402-442).

The complex image is optimized as an (re, im) pair of float32 tensors, the
JAX package's {"re", "im"} pytree: Adam keeps per-component moments, and
no complex leaf meets autograd or torch.optim (whose conjugate Wirtinger
gradient and real view of a complex parameter would not match). The Adam
step is optax's `adam(lr, b1, b2)` written over tensors (`adam_step`),
with its bias correction computed in float32 on the host. Ascent on the
log-posterior is descent on -(grad_data + lamda * grad_prior) (reference
:98-116). The JAX package scans the iterations in one compiled program;
here they are a host loop that reads nothing back from the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .ald import ScoreFn, _labels
from ..operators.finite_diff import FiniteDiff
from ..utils.device import Shift, random_shift, resolve_device
from ..utils.misc import stack_parts, unstack_parts
from ..utils.reshape import apply_in_tube_space

Pair = Tuple[torch.Tensor, torch.Tensor]
ADAM_EPS = 1e-8
MODES_T = ("tv", "diffusion1d", "none")


@dataclasses.dataclass(frozen=True)
class MAPConfig:
    n_iters: int = 200
    lr: float = 1e-3
    b1: float = 0.5
    b2: float = 0.5


@dataclasses.dataclass(frozen=True)
class AdamState:
    """optax's ScaleByAdamState: the step count (a host int) and the first
    and second moments, one tensor per parameter."""
    count: int
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    zeros = tuple(torch.zeros_like(p) for p in params)
    return AdamState(0, zeros, zeros)


def adam_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamState, config: MAPConfig):
    """One step of optax.adam(lr, b1, b2) (eps 1e-8, eps_root 0) on the
    descent direction `grads`: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 -
    b2) g^2, p - lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps).
    The bias corrections are float32, as optax computes them. Returns
    (params, state)."""
    t = state.count + 1
    one = np.float32(1.0)
    bc1 = float(one - np.float32(config.b1) ** np.float32(t))
    bc2 = float(one - np.float32(config.b2) ** np.float32(t))
    out, mus, nus = [], [], []
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        mu = (1 - config.b1) * g + config.b1 * mu
        nu = (1 - config.b2) * (g * g) + config.b2 * nu
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        out.append(p + (-config.lr) * update)
        mus.append(mu)
        nus.append(nu)
    return tuple(out), AdamState(t, tuple(mus), tuple(nus))


def _run_adam(ascent: Callable[[torch.Tensor, torch.Tensor], Pair],
              x0: Pair, config: MAPConfig) -> Pair:
    """config.n_iters Adam steps on the (re, im) pair from x0; ascent(xr,
    xi) returns the ascent direction, whose negation Adam descends. (The
    JAX package's `_run_adam` and `map_pair._run_adam_pair`.)"""
    params = tuple(x0)
    state = adam_init(params)
    for _ in range(config.n_iters):
        g_re, g_im = ascent(*params)
        params, state = adam_step(params, (-g_re, -g_im), state, config)
    return params


def _score_pair(score_fn: ScoreFn, xr: torch.Tensor, xi: torch.Tensor,
                label: int) -> Pair:
    """(score(Re x), score(Im x)) from one forward of the interleaved
    [Re, Im] batch, at ladder index `label`."""
    stacked = stack_parts(xr, xi)
    return unstack_parts(score_fn(stacked, _labels(stacked, label)))


def _split(z: torch.Tensor) -> Pair:
    return z.real, z.imag


def map_optimizer(
    score_fn: ScoreFn,
    measurement: torch.Tensor,
    lin_tfm,
    lamda: float,
    config: MAPConfig = MAPConfig(),
    x_init: Optional[torch.Tensor] = None,
    prior_label: int = 1,
    device="cuda",
) -> torch.Tensor:
    """MAP reconstruction (reference: MAP_optimizers.py:55-116; `Inpainting`
    and `SENSEMAP` are this with the matching lin_tfm, :119-124): Adam
    ascent from A^H y (or x_init) along A^H (y - A x) + lamda * (s(Re x) +
    i s(Im x)), the score at ladder index `prior_label` (the reference fixes
    labels = 1, :101-104). measurement and lin_tfm (complex64) move to
    `device`; score_fn must already run there. Returns complex64."""
    device = resolve_device(device)
    lin_tfm, measurement = lin_tfm.to(device), measurement.to(device)
    with torch.inference_mode():
        x0 = (lin_tfm.conj_op(measurement) if x_init is None
              else x_init.to(device))

        def ascent(xr, xi):
            g = lin_tfm.log_lh_grad(torch.complex(xr, xi), measurement, 1.0)
            s_re, s_im = _score_pair(score_fn, xr, xi, prior_label)
            return g.real + lamda * s_re, g.imag + lamda * s_im

        return torch.complex(*_run_adam(ascent, _split(x0), config))


def _map_2d_time(data_grad: Callable[[torch.Tensor, torch.Tensor], Pair],
                 score_fn_S: Optional[ScoreFn], score_fn_T: Optional[ScoreFn],
                 x0: Pair, config: MAPConfig, prior_weight: float,
                 spatial_step_weight: float, temporal_step_weight: float,
                 mode_T: str, if_random_shift: bool, win_size: int,
                 prior_label: int, seed: int, shift: Optional[Shift]
                 ) -> Pair:
    """The 2D+time MAP loop on (B, T, H, W, C) pairs, shared by the complex
    and the pair form: per iteration the data gradient, the spatial score
    of all B T frames, the temporal gradient ('tv': the FiniteDiff
    subgradient along the frames; 'diffusion1d': score_fn_T on the pixel
    tubes, rolled by shift(win_size) where if_random_shift; 'none'), then
    Adam on data + prior_weight (w_S spatial + w_T temporal)."""
    if mode_T not in MODES_T:
        raise ValueError(f"unknown mode_T {mode_T!r}; one of {MODES_T}")
    if mode_T == "diffusion1d" and temporal_step_weight != 0.0 and (
            score_fn_T is None):
        raise ValueError("mode_T='diffusion1d' needs a temporal score "
                         "function")
    if not if_random_shift:
        shift = None
    elif shift is None:
        shift = random_shift(seed)
    finite_diff = FiniteDiff(dims=1)

    def spatial_grad(xr, xi) -> Pair:
        if score_fn_S is None or spatial_step_weight == 0.0:
            return torch.zeros_like(xr), torch.zeros_like(xi)
        g_re, g_im = _score_pair(score_fn_S, xr.flatten(0, 1),
                                 xi.flatten(0, 1), prior_label)
        return g_re.reshape(xr.shape), g_im.reshape(xi.shape)

    def temporal_grad(xr, xi) -> Pair:
        if mode_T == "none" or temporal_step_weight == 0.0:
            return torch.zeros_like(xr), torch.zeros_like(xi)
        if mode_T == "tv":
            return finite_diff.log_lh_grad(xr), finite_diff.log_lh_grad(xi)
        return apply_in_tube_space(
            lambda tr, ti: _score_pair(score_fn_T, tr, ti, prior_label),
            (xr, xi), win_size, shift)

    def ascent(xr, xi) -> Pair:
        dr, di = data_grad(xr, xi)
        sr, si = spatial_grad(xr, xi)
        tr, ti = temporal_grad(xr, xi)
        return (dr + prior_weight * (spatial_step_weight * sr
                                     + temporal_step_weight * tr),
                di + prior_weight * (spatial_step_weight * si
                                     + temporal_step_weight * ti))

    return _run_adam(ascent, x0, config)


def map_optimizer_2d_time(
    score_fn_S: Optional[ScoreFn],
    score_fn_T: Optional[ScoreFn],
    measurement: torch.Tensor,
    lin_tfm,
    config: MAPConfig = MAPConfig(),
    prior_weight: float = 1.0,
    spatial_step_weight: float = 1.0,
    temporal_step_weight: float = 1.0,
    mode_T: str = "diffusion1d",
    if_random_shift: bool = False,
    win_size: int = 8,
    num_frames: Optional[int] = None,
    x_init: Optional[torch.Tensor] = None,
    prior_label: int = 1,
    seed: int = 0,
    shift: Optional[Shift] = None,
    device="cuda",
) -> torch.Tensor:
    """2D+time MAP reconstruction (reference: MAP_optimizers.py:154-337)
    on complex64 operators. measurement: (num_sens, B T, H, W, C); returns
    complex64 (B, T, H, W, C). grad = A^H (y - A x) + prior_weight (w_S
    grad_S + w_T grad_T), both priors at ladder index `prior_label`.
    mode_T in {tv, diffusion1d, none}. `seed` takes the place of the JAX
    PRNG key: it seeds the random roll of the tubes (if_random_shift);
    `shift(win)` overrides it, one call per iteration."""
    device = resolve_device(device)
    lin_tfm, measurement = lin_tfm.to(device), measurement.to(device)
    _, BT, H, W, C = measurement.shape
    T = num_frames if num_frames is not None else BT
    shape = (BT // T, T, H, W, C)

    def data_grad(xr, xi) -> Pair:
        g = lin_tfm.log_lh_grad(torch.complex(xr, xi).reshape(BT, H, W, C),
                                measurement)
        return g.real.reshape(shape), g.imag.reshape(shape)

    with torch.inference_mode():
        x0 = (lin_tfm.conj_op(measurement).reshape(shape) if x_init is None
              else x_init.to(device))
        return torch.complex(*_map_2d_time(
            data_grad, score_fn_S, score_fn_T, _split(x0), config,
            prior_weight, spatial_step_weight, temporal_step_weight, mode_T,
            if_random_shift, win_size, prior_label, seed, shift))


def _safe_modulus(sq: torch.Tensor) -> torch.Tensor:
    """sqrt(sq) with a zero (not NaN) gradient at sq == 0: the sgn(0) = 0
    subgradient of abs()."""
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, 1.0)), 0.0)


def tv_norm_noncircular(x: torch.Tensor, spatial_axes: Tuple[int, int]
                        ) -> torch.Tensor:
    """Anisotropic-in-space TV with open boundaries, kornia's TotalVariation
    of the reference TV baseline (scripts/acdc_SENSE_TV.py:16,78): the sum
    over both axes of |diff(x, axis)|, |.| the complex modulus for complex
    x (kornia's .abs() on the reference's complex parameter,
    MAP_optimizers.py:45)."""
    if x.is_complex():
        return tv_norm_noncircular_pair(x.real, x.imag, spatial_axes)
    ax0, ax1 = spatial_axes
    return (torch.sum(torch.abs(torch.diff(x, dim=ax0)))
            + torch.sum(torch.abs(torch.diff(x, dim=ax1))))


def tv_norm_noncircular_pair(re: torch.Tensor, im: torch.Tensor,
                             spatial_axes: Tuple[int, int]) -> torch.Tensor:
    """Complex-modulus TV of re + i im: the sum over both axes of
    sqrt(diff(re)^2 + diff(im)^2)."""
    out = torch.zeros((), dtype=re.dtype, device=re.device)
    for ax in spatial_axes:
        dr = torch.diff(re, dim=ax)
        di = torch.diff(im, dim=ax)
        out = out + torch.sum(_safe_modulus(dr * dr + di * di))
    return out


def _loss_grad(loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               xr: torch.Tensor, xi: torch.Tensor) -> Pair:
    """The gradient of loss_fn(re, im) with respect to both real leaves."""
    with torch.enable_grad():
        pr = xr.detach().requires_grad_()
        pi = xi.detach().requires_grad_()
        return torch.autograd.grad(loss_fn(pr, pi), (pr, pi))


def _run_adam_descent(loss_fn, x0: Pair, config: MAPConfig) -> Pair:
    """config.n_iters Adam steps down the autograd gradient of loss_fn,
    under torch.no_grad (not inference_mode, which autograd cannot
    re-enter)."""
    with torch.no_grad():
        return _run_adam(lambda xr, xi: tuple(
            -g for g in _loss_grad(loss_fn, xr, xi)), x0, config)


def tv_reconstruction(
    measurement: torch.Tensor,
    lin_tfm,
    reg_weight: float,
    config: MAPConfig = MAPConfig(),
    x_init: Optional[torch.Tensor] = None,
    spatial_axes: Tuple[int, int] = (1, 2),
    regularizer=None,
    device="cuda",
) -> torch.Tensor:
    """TV-regularized least squares (reference: MAPModel + TrainMAPModel,
    helpers/pl_helpers.py:402-442): Adam on min_x 0.5 ||A x - y||^2 + R(x)
    from A^H y, R = `regularizer` (any regularizers.AbstractRegularizer;
    default TVRegularizer(reg_weight, spatial_axes), the reference's w *
    TV). Returns complex64."""
    from ..regularizers import TVRegularizer
    if regularizer is None:
        regularizer = TVRegularizer(reg_weight, spatial_axes)
    device = resolve_device(device)
    lin_tfm, measurement = lin_tfm.to(device), measurement.to(device)

    def loss_fn(re, im):
        res = lin_tfm(torch.complex(re, im)) - measurement
        data = 0.5 * torch.sum(res.real * res.real + res.imag * res.imag)
        return data + regularizer.pair(re, im)

    with torch.no_grad():
        x0 = (lin_tfm.conj_op(measurement) if x_init is None
              else x_init.to(device))
    return torch.complex(*_run_adam_descent(loss_fn, _split(x0), config))

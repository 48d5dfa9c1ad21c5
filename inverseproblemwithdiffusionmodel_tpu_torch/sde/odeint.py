"""Adaptive Dormand-Prince (RK45) integration in torch, step for step the
integrator the JAX package's ODE sampler uses
(`jax.experimental.ode.odeint`, forward only).

What the port keeps exactly, so that its steps and evaluations are JAX's:

- the state is one flat vector: the error norm (`mean_error_ratio`) is one
  RMS over every element of the batch, so all samples share one step;
- the initial step (`initial_step_size`, Hairer, Norsett and Wanner II.4,
  at order 4) spends one evaluation on a probe, so a solve costs 2 + 6
  evaluations per ATTEMPTED step (first-same-as-last; a rejected step
  still costs 6);
- step-size control (`optimal_step_size`): safety 0.9, ifactor 10, dfactor
  0.2 (1.0 where the error ratio is below 1, so an accepted step never
  shrinks the next), order 5; no mxstep, no hmax;
- the last step overshoots the target, and the output there is the
  4th-order Dopri interpolant (`interp_fit_dopri`) evaluated at it;
- times and coefficients are float32, the coefficients rounded from the
  same double-precision fractions;
- XLA contracts `a * b + c` into one fused multiply-add wherever the JAX
  integrator writes one (the stage states, the step, the interpolant, its
  evaluation, the tolerances); `_fma` rounds those once too, so a step's
  arithmetic is JAX's bit for bit on the CPU (the norms' and dots'
  summation order aside).

Accept or reject stays on the device (`torch.where` over the state, as
JAX's while loop does); the loop test `t < target` is the one host read
per attempted step.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

_ALPHA = [1 / 5, 3 / 10, 4 / 5, 8 / 9, 1., 1., 0]
_BETA = [[1 / 5, 0, 0, 0, 0, 0, 0],
         [3 / 40, 9 / 40, 0, 0, 0, 0, 0],
         [44 / 45, -56 / 15, 32 / 9, 0, 0, 0, 0],
         [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0, 0],
         [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0,
          0],
         [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]]
_C_SOL = [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0]
_C_ERROR = [35 / 384 - 1951 / 21600, 0, 500 / 1113 - 22642 / 50085,
            125 / 192 - 451 / 720, -2187 / 6784 - -12231 / 42400,
            11 / 84 - 649 / 6300, -1. / 60.]
_DPS_C_MID = [6025192743 / 30085553152 / 2, 0,
              51252292925 / 65400821598 / 2,
              -2691868925 / 45128329728 / 2,
              187940372067 / 1594534317056 / 2,
              -1776094331 / 19743644256 / 2, 11237099 / 235043384 / 2]


class _Tableau:
    """The Dopri5 coefficients as float32 tensors on one device."""

    def __init__(self, device):
        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        self.alpha, self.beta = f32(_ALPHA), f32(_BETA)
        self.c_sol, self.c_error = f32(_C_SOL), f32(_C_ERROR)
        self.c_mid = f32(_DPS_C_MID)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c in float32, rounded once: a float32 product is exact in
    float64, so the float64 sum rounds as a fused multiply-add does (but
    for a tie once in about 2^29 draws)."""
    a, b, c = (torch.as_tensor(v).double() for v in (a, b, c))
    return (a * b + c).float()


def initial_step_size(fun, t0, y0, order, rtol, atol, f0) -> torch.Tensor:
    """The first step (reference: jax/experimental/ode.py:78): one probe
    evaluation at t0 + h0."""
    scale = _fma(torch.abs(y0), rtol, atol)
    d0 = _norm(y0 / scale)
    d1 = _norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = _fma(h0, f0, y0)
    f1 = fun(y1, t0 + h0)
    d2 = _norm((f1 - f0) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                     torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1. / (order + 1.)))
    return torch.minimum(100. * h0, h1)


def runge_kutta_step(fun, y0, f0, t0, dt, tab: _Tableau):
    """One Dopri5 step: (y1, f1, the error estimate, the (7, N) stages)."""
    k = torch.zeros((7,) + tuple(f0.shape), dtype=f0.dtype, device=f0.device)
    k[0] = f0
    for i in range(1, 7):
        ti = _fma(dt, tab.alpha[i - 1], t0)
        yi = _fma(dt, tab.beta[i - 1] @ k, y0)
        k[i] = fun(yi, ti)
    y1 = _fma(dt, tab.c_sol @ k, y0)
    y1_error = dt * (tab.c_error @ k)
    return y1, k[-1], y1_error, k


def mean_error_ratio(error_estimate, rtol, atol, y0, y1) -> torch.Tensor:
    """RMS over every element of the state of error / tolerance."""
    err_tol = _fma(rtol, torch.maximum(torch.abs(y0), torch.abs(y1)), atol)
    err_ratio = error_estimate / err_tol
    return torch.sqrt(torch.mean(err_ratio ** 2))


def optimal_step_size(last_step, mean_error_ratio, safety=0.9,
                      ifactor=10.0, dfactor=0.2, order=5.0) -> torch.Tensor:
    """The next step from the last one and its error ratio."""
    dfactor = torch.where(mean_error_ratio < 1, 1.0, dfactor)
    factor = torch.minimum(
        torch.tensor(ifactor, dtype=last_step.dtype, device=last_step.device),
        torch.maximum(mean_error_ratio ** (-1.0 / order) * safety, dfactor))
    return torch.where(mean_error_ratio == 0, last_step * ifactor,
                       last_step * factor)


def interp_fit_dopri(y0, y1, k, dt, tab: _Tableau) -> torch.Tensor:
    """Coefficients (5, N) of the 4th-order polynomial through a step."""
    y_mid = _fma(dt, tab.c_mid @ k, y0)
    dy0, dy1 = k[0], k[-1]

    def chain(*terms):
        # c0 v0 + c1 v1 + ..., left to right, each addition fused
        (c0, v0), *rest = terms
        out = c0 * v0
        for c, v in rest:
            out = _fma(c, v, out)
        return out

    a = chain((-2. * dt, dy0), (2. * dt, dy1), (-8., y0), (-8., y1),
              (16., y_mid))
    b = chain((5. * dt, dy0), (-3. * dt, dy1), (18., y0), (14., y1),
              (-32., y_mid))
    c = chain((-4. * dt, dy0), (dt, dy1), (-11., y0), (-5., y1),
              (16., y_mid))
    return torch.stack([a, b, c, dt * dy0, y0])


def _polyval(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    y = torch.zeros_like(coeffs[0])
    for c in coeffs:
        y = _fma(y, x, c)
    return y


def odeint(func: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
           y0: torch.Tensor, t: torch.Tensor, rtol: float = 1.4e-8,
           atol: float = 1.4e-8, stats: Optional[dict] = None
           ) -> torch.Tensor:
    """Integrate dy/dt = func(y, t) from t[0] through the increasing
    float32 times t; returns the states at t, shape (len(t),) + y0.shape.
    func takes y shaped as y0 and t a 0-d float32 tensor.

    `stats`, where given, receives the solve's counts: `nfe` (evaluations
    of func), `steps` (attempted steps, one host read each), `accepted`
    and `rejected`, and `ratios`, each attempted step's error ratio (a
    step is accepted where it is at most 1), read from the device once, at
    the end.
    """
    shape = y0.shape
    device = y0.device
    tab = _Tableau(device)
    t = t.to(device=device, dtype=torch.float32)
    calls = [0]

    def fun(y, s):
        calls[0] += 1
        return func(y.view(shape), s).reshape(-1)

    y = y0.reshape(-1)
    t0 = t[0]
    f = fun(y, t0)
    dt = torch.clamp(initial_step_size(fun, t0, y, 4, rtol, atol, f),
                     min=0.)
    cur_t, last_t = t0, t0
    interp = torch.stack([y] * 5)
    ratios = []
    out = [y0]
    for target in t[1:]:
        while bool((cur_t < target) & (dt > 0)):
            next_y, next_f, next_err, k = runge_kutta_step(
                fun, y, f, cur_t, dt, tab)
            ratio = mean_error_ratio(next_err, rtol, atol, y, next_y)
            new_interp = interp_fit_dopri(y, next_y, k, dt, tab)
            ok = ratio <= 1.
            y = torch.where(ok, next_y, y)
            f = torch.where(ok, next_f, f)
            last_t = torch.where(ok, cur_t, last_t)
            cur_t = torch.where(ok, cur_t + dt, cur_t)
            interp = torch.where(ok, new_interp, interp)
            ratios.append(ratio)
            dt = torch.clamp(optimal_step_size(dt, ratio), min=0.)
        relative_output_time = (target - last_t) / (cur_t - last_t)
        out.append(_polyval(interp, relative_output_time).view(shape))
    if stats is not None:
        ratios = torch.stack(ratios).tolist() if ratios else []
        n_ok = sum(r <= 1. for r in ratios)
        stats.update(nfe=calls[0], steps=len(ratios), accepted=n_ok,
                     rejected=len(ratios) - n_ok, ratios=ratios)
    return torch.stack(out)

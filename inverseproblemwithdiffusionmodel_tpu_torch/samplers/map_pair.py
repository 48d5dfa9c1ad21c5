"""MAP reconstruction and TV least squares on the real-pair operators.

Port of inverseproblemwithdiffusionmodel_tpu/samplers/map_pair.py: the
semantics of samplers/map_opt.py (reference: ncsn/models/
MAP_optimizers.py:55-116 MAPOptimizer, :154-337 MAPOptimizer2DTime; the TV
baseline of scripts/acdc_SENSE_TV.py) with the measurement and the
operator in (re, im) float32 pair form (operators/pair.py). The data
ascent direction is A^H (y - A x); the prior's is score(Re x) + i score(Im
x) at a fixed noise label. The pair and the complex forms run the same
Adam (map_opt.adam_step) on the same (re, im) state, so their iterates
agree step for step up to the operators' float32 rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .ald import ScoreFn
from .map_opt import (MAPConfig, Pair, _map_2d_time, _run_adam,
                      _run_adam_descent, _score_pair, adam_init, adam_step,
                      tv_norm_noncircular_pair)
from ..utils.device import Shift, resolve_device


def _data_grad_pair(lin_tfm, xr, xi, yr, yi) -> Pair:
    """A^H (y - A x) on pairs (operators/base.py log_lh_grad, lamda 1)."""
    fr, fi = lin_tfm(xr, xi)
    return lin_tfm.conj_op(yr - fr, yi - fi)


def map_optimizer_pair(
    score_fn: ScoreFn,
    measurement: Pair,
    lin_tfm,
    lamda: float,
    config: MAPConfig = MAPConfig(),
    x_init: Optional[Pair] = None,
    prior_label: int = 1,
    device="cuda",
) -> Pair:
    """Pair form of map_optimizer (reference: MAP_optimizers.py:55-116).
    measurement: (yr, yi); returns the reconstruction pair (xr, xi)."""
    device = resolve_device(device)
    lin_tfm = lin_tfm.to(device)
    yr, yi = (v.to(device) for v in measurement)
    with torch.inference_mode():
        x0 = (lin_tfm.conj_op(yr, yi) if x_init is None
              else tuple(v.to(device) for v in x_init))

        def ascent(xr, xi):
            gr, gi = _data_grad_pair(lin_tfm, xr, xi, yr, yi)
            s_re, s_im = _score_pair(score_fn, xr, xi, prior_label)
            return gr + lamda * s_re, gi + lamda * s_im

        return _run_adam(ascent, x0, config)


def map_optimizer_2d_time_pair(
    score_fn_S: Optional[ScoreFn],
    score_fn_T: Optional[ScoreFn],
    measurement: Pair,
    lin_tfm,
    config: MAPConfig = MAPConfig(),
    prior_weight: float = 1.0,
    spatial_step_weight: float = 1.0,
    temporal_step_weight: float = 1.0,
    mode_T: str = "diffusion1d",
    if_random_shift: bool = False,
    win_size: int = 8,
    num_frames: Optional[int] = None,
    x_init: Optional[Pair] = None,
    prior_label: int = 1,
    seed: int = 0,
    shift: Optional[Shift] = None,
    device="cuda",
) -> Pair:
    """Pair form of map_optimizer_2d_time (reference: MAP_optimizers.py:
    154-337). measurement: ((num_sens, B T, H, W, C), same); returns (xr,
    xi) of (B, T, H, W, C). `seed` / `shift(win)` give the tubes' random
    roll where if_random_shift."""
    device = resolve_device(device)
    lin_tfm = lin_tfm.to(device)
    yr, yi = (v.to(device) for v in measurement)
    _, BT, H, W, C = yr.shape
    T = num_frames if num_frames is not None else BT
    shape = (BT // T, T, H, W, C)

    def data_grad(xr, xi) -> Pair:
        gr, gi = _data_grad_pair(lin_tfm, xr.reshape(BT, H, W, C),
                                 xi.reshape(BT, H, W, C), yr, yi)
        return gr.reshape(shape), gi.reshape(shape)

    with torch.inference_mode():
        x0 = (tuple(v.reshape(shape) for v in lin_tfm.conj_op(yr, yi))
              if x_init is None else tuple(v.to(device) for v in x_init))
        return _map_2d_time(
            data_grad, score_fn_S, score_fn_T, x0, config, prior_weight,
            spatial_step_weight, temporal_step_weight, mode_T,
            if_random_shift, win_size, prior_label, seed, shift)


class SteppedMAPPairOptimizer:
    """`run(model, yr, yi, lamda) -> (xr, xi)`: map_optimizer_pair as
    steps. `start` is A^H y with a fresh Adam state; `step` is one Adam
    iteration (the data gradient, one score forward of the interleaved
    [Re, Im] batch, the update), launched from the host with no device
    read. lamda becomes a float32 tensor on the device, so a grid of prior
    weights runs through one set-up. `model` is the NCSNv2 net whose
    weights the run uses (the JAX form's params), moved to `device` in
    eval mode."""

    def __init__(self, sigmas, lin_tfm, config: MAPConfig = MAPConfig(),
                 prior_label: int = 1, device="cuda"):
        self.device = resolve_device(device)
        self.sigmas = torch.as_tensor(sigmas, dtype=torch.float32)
        self.lin_tfm = lin_tfm.to(self.device)
        self.config = config
        self.prior_label = prior_label

    def score_fn(self, model: torch.nn.Module) -> ScoreFn:
        # imported here: models/ imports samplers.sigmas, whose package
        # imports this module
        from ..models.registry import make_score_fn
        return make_score_fn(model.to(self.device).eval(), self.sigmas)

    def start(self, yr: torch.Tensor, yi: torch.Tensor):
        params = self.lin_tfm.conj_op(yr, yi)
        return params, adam_init(params)

    def step(self, score_fn: ScoreFn, params, state, yr, yi,
             lamda: torch.Tensor):
        xr, xi = params
        gr, gi = _data_grad_pair(self.lin_tfm, xr, xi, yr, yi)
        s_re, s_im = _score_pair(score_fn, xr, xi, self.prior_label)
        return adam_step(params, (-(gr + lamda * s_re), -(gi + lamda * s_im)),
                         state, self.config)

    def __call__(self, model: torch.nn.Module, yr: torch.Tensor,
                 yi: torch.Tensor, lamda: Union[float, torch.Tensor]) -> Pair:
        score_fn = self.score_fn(model)
        with torch.inference_mode():
            yr, yi = yr.to(self.device), yi.to(self.device)
            lamda = torch.as_tensor(lamda, dtype=torch.float32).to(
                self.device)
            params, state = self.start(yr, yi)
            for _ in range(self.config.n_iters):
                params, state = self.step(score_fn, params, state, yr, yi,
                                          lamda)
        return params


def make_stepped_map_pair_optimizer(
    model: torch.nn.Module,
    sigmas,
    lin_tfm,
    config: MAPConfig = MAPConfig(),
    prior_label: int = 1,
    device="cuda",
) -> SteppedMAPPairOptimizer:
    """The stepped MAP optimizer for `model`'s architecture (moved to
    `device`, eval mode): returns `run(model, yr, yi, lamda) -> (xr, xi)`,
    which takes the net again as the JAX run takes its params, so one
    optimizer serves several weights of one architecture (reference
    semantics: MAP_optimizers.py:55-116)."""
    opt = SteppedMAPPairOptimizer(sigmas, lin_tfm, config, prior_label,
                                  device)
    model.to(opt.device).eval()
    return opt


def tv_reconstruction_pair(
    measurement: Pair,
    lin_tfm,
    reg_weight: float,
    config: MAPConfig = MAPConfig(),
    x_init: Optional[Pair] = None,
    spatial_axes: Tuple[int, int] = (1, 2),
    device="cuda",
) -> Pair:
    """Pair form of tv_reconstruction (reference: MAPModel + TrainMAPModel,
    helpers/pl_helpers.py:402-442): Adam on min_x 0.5 ||A x - y||^2 + w
    TV(x), TV with complex-modulus differences."""
    device = resolve_device(device)
    lin_tfm = lin_tfm.to(device)
    yr, yi = (v.to(device) for v in measurement)

    def loss_fn(re, im):
        fr, fi = lin_tfm(re, im)
        data = 0.5 * (torch.sum((fr - yr) ** 2) + torch.sum((fi - yi) ** 2))
        return data + reg_weight * tv_norm_noncircular_pair(re, im,
                                                            spatial_axes)

    with torch.no_grad():
        x0 = (lin_tfm.conj_op(yr, yi) if x_init is None
              else tuple(v.to(device) for v in x_init))
    return _run_adam_descent(loss_fn, x0, config)

"""Annealed Langevin dynamics: the sampler parameters and the update step.

Port of `ALDConfig`, `_labels`, `_langevin_update`, the prior sampler
`ald_unconditional_sampler`, the guidance gradients `compute_clf_grad` /
`compute_seg_grad`, the 2D+time ladders (`interp_sigmas_T`,
`interp_sigma_T_indices`, `setup_2d_time_ladders`) and the complex
reconstruction samplers `ald_inverse_seg_proximal_real_imag` and
`ald_2d_time` from inverseproblemwithdiffusionmodel_tpu/samplers/ald.py
(reference: ncsn/models/ALD_optimizers.py:49-155, 158, 161-327 and
330-554, ncsn/models/__init__.py:172-215). Randomness is injected: the
update takes its noise tensor, drawn by the caller from a `noise(shape)`
function (utils/device.gaussian_noise builds one from a seed and an
explicit torch.Generator), so a test can feed the JAX sampler's own
draws.

Score function interface: `score_fn(x, labels) -> score`, labels an
integer (B,) tensor of ladder indices; models/registry.make_score_fn
builds one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .sigmas import get_lh_weights
from ..utils.device import (Noise, Shift, gaussian_noise, random_shift,
                            resolve_device)
from ..utils.misc import stack_parts, unstack_parts

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


# -- unconditional sampling ---------------------------------------------------

def ald_unconditional_sampler(
    score_fn: ScoreFn,
    sigmas,
    shape: Tuple[int, ...],
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    x_init: Optional[torch.Tensor] = None,
    snapshot_fn: Optional[Callable] = None,
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """Prior sampling by annealed Langevin dynamics (reference:
    ALD_optimizers.py:66-137 with its default hooks): a host loop over the
    levels and config.n_steps_each inner steps, each one score evaluation
    and a Langevin update with step_lr (sigma / sigma_L)^2, then where
    config.denoise one denoising step x + sigma_L^2 score(x) at the last
    level.

    shape: (B, *feature), the score function's channel-last layout. x
    starts at U(0, 1) unless `x_init` is given. One torch.Generator on
    `device`, seeded with `seed`, draws the start and then the inner
    steps' noise in order (it takes the JAX PRNG key's place);
    `noise(shape)` overrides the noise, one draw per inner step, as the
    JAX key schedule draws it. snapshot_fn(level, sigma, x) runs on the
    host every config.snapshot_every levels. score_fn must run on
    `device`. Runs under torch.inference_mode; returns float32 x."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    if noise is None:
        noise = lambda s: torch.randn(tuple(s), generator=gen, device=device)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32).to(device)
    L = sigmas.shape[0]
    sigma_last = sigmas[-1]
    with torch.inference_mode():
        if x_init is None:
            x = torch.rand(tuple(shape), generator=gen, device=device)
        else:
            x = torch.as_tensor(x_init, dtype=torch.float32).to(device)
        for c in range(L):
            sigma = sigmas[c]
            step_size = config.step_lr * (sigma / sigma_last) ** 2
            for _ in range(config.n_steps_each):
                grad = score_fn(x, _labels(x, c))
                x = _langevin_update(x, grad, step_size, noise(x.shape))
            if (snapshot_fn is not None and config.snapshot_every > 0
                    and c % config.snapshot_every == 0):
                snapshot_fn(c, float(sigma), x)
        if config.denoise:
            x = x + sigma_last ** 2 * score_fn(x, _labels(x, L - 1))
        return x


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


# -- inverse problem: seg-guided ALD with proximal data consistency ---------

def ald_inverse_seg_proximal_real_imag(
    score_fn: ScoreFn,
    sigmas,
    measurement: torch.Tensor,
    lin_tfm,
    proximal,
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    lr_scaled: float = 1.0,
    seg_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    seg_label: Optional[torch.Tensor] = None,
    seg_lamda: float = 1.0,
    seg_start_time: float = 1.0,
    seg_step_type: str = "linear",
    seg_mode: str = "full",
    snapshot_fn: Optional[Callable] = None,
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """The single-coil / SENSE reconstruction sampler on complex64
    operators (reference: ALDInvSegProximalRealImag,
    ALD_optimizers.py:161-327): a host loop over levels and inner steps.

    It starts at A^H y. Each inner step runs one score forward over the
    interleaved [Re, Im] batch (2B), adds the segmentation guidance
    gradient g_seg / sigma * (lh_w * seg_lamda) where `seg_fn` is given
    (its ramp from get_lh_weights, zero until `seg_start_time`), takes the
    Langevin step of Re and Im, then the proximal step on z = x_re + i
    x_im with alpha = step_lr * lr_scaled and lamda 1 (the unscaled
    step_lr, as the reference's :247,313-315). A denoising step at the last
    level ends the chain when config.denoise.

    measurement, lin_tfm and proximal move to `device`; score_fn and seg_fn
    must already run there. `seed` takes the place of the JAX PRNG key;
    `noise(shape)` overrides it and is drawn Re, then Im, per inner step,
    as the JAX key schedule splits (`key, k_re, k_im = split(key, 3)`).
    seg_label: (B, H, W) int. snapshot_fn(level, sigma, x_re, x_im) runs on
    the host every config.snapshot_every levels. Runs under
    torch.inference_mode, or torch.no_grad with guidance (its gradient
    needs autograd). Returns complex64 (B, H, W, C).
    """
    device = resolve_device(device)
    if noise is None:
        noise = gaussian_noise(seed, device)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32).to(device)
    L = sigmas.shape[0]
    sigma_last = sigmas[-1]
    lin_tfm, proximal = lin_tfm.to(device), proximal.to(device)
    measurement = measurement.to(device)
    use_seg = seg_fn is not None
    if use_seg:
        if seg_label is None:
            raise ValueError("seg_fn given but seg_label is None")
        label = torch.as_tensor(seg_label).to(device)
        # the seg net sees Re and Im separately, the same label for both
        seg_label2 = stack_parts(label, label)
        lh_weights = get_lh_weights(sigmas, seg_start_time,
                                    seg_step_type).to(device)
    alpha = config.step_lr * lr_scaled
    with torch.no_grad() if use_seg else torch.inference_mode():
        x0 = lin_tfm.conj_op(measurement)
        x_re, x_im = x0.real, x0.imag
        for c in range(L):
            sigma = sigmas[c]
            step_size = config.step_lr * (sigma / sigma_last) ** 2
            for _ in range(config.n_steps_each):
                stacked = stack_parts(x_re, x_im)
                grads = score_fn(stacked, _labels(stacked, c))
                if use_seg:
                    g_seg = compute_seg_grad(seg_fn, stacked, seg_label2,
                                             seg_mode)
                    grads = grads + g_seg / sigma * (lh_weights[c]
                                                     * seg_lamda)
                g_re, g_im = unstack_parts(grads)
                x_re = _langevin_update(x_re, g_re, step_size,
                                        noise(x_re.shape))
                x_im = _langevin_update(x_im, g_im, step_size,
                                        noise(x_im.shape))
                z = proximal(torch.complex(x_re, x_im), measurement, alpha,
                             1.0)
                x_re, x_im = z.real, z.imag
            if (snapshot_fn is not None and config.snapshot_every > 0
                    and c % config.snapshot_every == 0):
                snapshot_fn(c, float(sigma), x_re, x_im)
        if config.denoise:
            stacked = stack_parts(x_re, x_im)
            g_re, g_im = unstack_parts(score_fn(stacked,
                                                _labels(stacked, L - 1)))
            x_re = x_re + sigma_last ** 2 * g_re
            x_im = x_im + sigma_last ** 2 * g_im
        return torch.complex(x_re, x_im)


# -- 2D+time (cine) on complex64 operators ----------------------------------

def ald_2d_time(
    score_fn_S: Optional[ScoreFn],
    score_fn_T: Optional[ScoreFn],
    sigmas,
    sigmas_T,
    measurement: torch.Tensor,
    lin_tfm,
    proximal,
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    lr_scaled: float = 1.0,
    mode_T: str = "diffusion1d",
    lamda_T: float = 1.0,
    if_random_shift: bool = False,
    win_size: int = 8,
    num_frames: Optional[int] = None,
    snapshot_fn: Optional[Callable] = None,
    noise: Optional[Noise] = None,
    shift: Optional[Shift] = None,
    device="cuda",
) -> torch.Tensor:
    """The factorized 2D+time cine reconstruction on complex64 operators
    (reference: ALD_optimizers.py:330-554). measurement: (num_sens, B T, H,
    W, C) complex; returns complex64 (B, T, H, W, C). It starts at A^H y;
    per level and inner step: the spatial score step on all B T frames (Re
    and Im interleaved, 2 B T), the temporal step (mode_T 'diffusion1d':
    score_fn_T on the pixel tubes, its labels index the RAW sigmas_T,
    optionally rolled by a random shift; 'tv': the FiniteDiff subgradient;
    'none'; the '*-only' modes skip the spatial step and run over the
    temporal ladder), then the proximal over all frames with alpha =
    step_lr lr_scaled. No denoising step, as in the JAX package.

    The state is the (re, im) pair and the inner step is the pair form's
    (samplers/ald_pair._pair_2d_time_inner); only the proximal is complex.
    Whether a level runs the temporal step is read from the host ladder
    (JAX's lax.cond on sigma_T > 0), with no device read. `seed` takes the
    place of the JAX PRNG key; `noise(shape)` and `shift(win)` override
    its draws, in the JAX key schedule's order (the frames' Re and Im, then
    where the temporal diffusion step runs its roll and the tubes' Re and
    Im). snapshot_fn(level, sigma, x_re, x_im) runs on the host every
    config.snapshot_every levels."""
    from .ald_pair import _pair_2d_time_inner
    from ..operators.finite_diff import FiniteDiff
    if "diffusion1d" in mode_T and score_fn_T is None:
        raise ValueError(f"mode_T={mode_T!r} needs a temporal score function")
    device = resolve_device(device)
    if noise is None:
        noise = gaussian_noise(seed, device)
    if not if_random_shift:
        shift = None
    elif shift is None:
        shift = random_shift(seed)
    levels, sigmas_T_host, labels_T = setup_2d_time_ladders(
        sigmas, sigmas_T, mode_T)
    f32 = dict(dtype=torch.float32, device=device)
    sig, sig_T = (torch.as_tensor(v, **f32) for v in (levels, sigmas_T_host))
    lr_scaled = torch.as_tensor(lr_scaled, **f32)
    lamda_T = torch.as_tensor(lamda_T, **f32)
    lin_tfm, proximal = lin_tfm.to(device), proximal.to(device)
    measurement = measurement.to(device)
    inner = _pair_2d_time_inner(score_fn_S, score_fn_T, FiniteDiff(dims=1),
                                config, mode_T, win_size, sig[-1], sig_T[-1])

    def prox(xr, xi, _yr, _yi, alpha, lamda):
        z = proximal(torch.complex(xr, xi), measurement, alpha, lamda)
        return z.real, z.imag

    with torch.inference_mode():
        x0 = lin_tfm.conj_op(measurement)               # (B T, H, W, C)
        BT = x0.shape[0]
        T = num_frames if num_frames is not None else BT
        shape = (BT // T, T) + tuple(x0.shape[1:])
        xr, xi = x0.real.reshape(shape), x0.imag.reshape(shape)
        for c in range(len(levels)):
            level = (c, int(labels_T[c]), sig[c], sig_T[c],
                     bool(sigmas_T_host[c] > 0))
            for _ in range(config.n_steps_each):
                xr, xi = inner(prox, xr, xi, None, None, *level, lr_scaled,
                               lamda_T, noise, shift)
            if (snapshot_fn is not None and config.snapshot_every > 0
                    and c % config.snapshot_every == 0):
                snapshot_fn(c, float(levels[c]), xr, xi)
        return torch.complex(xr, xi)

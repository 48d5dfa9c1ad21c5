"""ALD reconstruction in real-pair form (no complex dtype).

Port of `_bake_ahy`, `ald_inverse_proximal_pair`,
`make_stepped_pair_reconstructor` and their 2D+time (cine) counterparts
`_pair_2d_time_inner`, `ald_2d_time_pair` and
`make_stepped_2d_time_pair_reconstructor` from
inverseproblemwithdiffusionmodel_tpu/samplers/ald_pair.py (reference:
ALD_optimizers.py:161-327, 330-554): per noise level, n_steps_each
Langevin steps on the Re and Im parts (one score forward of the
interleaved 2B batch), each followed by the proximal data consistency
step, then an optional denoising step at the last level. The 2D+time
chain adds a temporal step between the two (see
`Stepped2DTimePairReconstructor`).

In the JAX package the scanned form is one compiled program and the
stepped form loops over levels on the host; here both are the same host
loop (`SteppedPairReconstructor`), and they give equal results. Each inner
step draws its noise Re first, then Im, as the JAX key schedule does
(`key, k_re, k_im = split(key, 3)`), so a test can replay JAX's stream
through the `noise` hook.

With a segmentation net (`seg_fn`, a per-pixel `seg_label`), each inner
step adds the guidance gradient of samplers/ald.compute_seg_grad, divided
by sigma and weighted by `seg_lamda` times the ramp of get_lh_weights
(zero until `seg_start_time`, then linear to 1), as the JAX samplers do
(reference: ALDInvSegProximalRealImag, ALD_optimizers.py:161-327). The
unguided chain runs under torch.inference_mode; the guided one under
torch.no_grad, since its gradient needs autograd.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple, Union

import torch

from .ald import (ALDConfig, ScoreFn, _labels, _langevin_update,
                  compute_seg_grad, setup_2d_time_ladders)
from .sigmas import get_lh_weights
from ..models.registry import make_score_fn
from ..operators.finite_diff import FiniteDiff
from ..operators.pair import PairL2Penalty
from ..utils.device import (Noise, Shift, gaussian_noise,
                            random_shift, resolve_device)
from ..utils.misc import stack_parts, unstack_parts
from ..utils.reshape import apply_in_tube_space

Pair = Tuple[torch.Tensor, torch.Tensor]


def _bake_ahy(proximal, ahy_r: torch.Tensor, ahy_i: torch.Tensor):
    """Pin the loop-invariant A^H y (the chain's start) into a
    PairL2Penalty so its CG set-up does not recompute a SENSE adjoint every
    inner step."""
    if isinstance(proximal, PairL2Penalty) and proximal.ahy_re is None:
        return proximal.replace(ahy_re=ahy_r, ahy_im=ahy_i)
    return proximal


class SteppedPairReconstructor:
    """`recon(yr, yi, seed=0, noise=None) -> (xr, xi)`: the pair ALD chain
    from the measurement (yr, yi) of shape (num_sens, B, H, W, C) to the
    image pair (B, H, W, C), run under torch.inference_mode on `device`.
    `noise(shape)` overrides the draws from a generator seeded with `seed`.
    `start`, `level_step` and `denoise` are its parts, one noise level at a
    time (the unit a profile or a CUDA graph takes); a caller of the parts
    runs a guided chain under torch.no_grad, not torch.inference_mode.

    seg_fn (channel-last x -> logits, models/registry.make_seg_fn) turns
    the guidance on; seg_label is then the (B, H, W) int target map."""

    def __init__(self, score_fn: ScoreFn, sigmas, lin_tfm, proximal,
                 config: ALDConfig = ALDConfig(),
                 lr_scaled: Union[float, torch.Tensor] = 1.0,
                 snapshot_fn: Optional[Callable] = None, device="cuda", *,
                 seg_fn: Optional[Callable] = None,
                 seg_label: Optional[torch.Tensor] = None,
                 seg_lamda: Union[float, torch.Tensor] = 1.0,
                 seg_start_time: float = 1.0, seg_step_type: str = "linear",
                 seg_mode: str = "full"):
        self.device = resolve_device(device)
        self.score_fn = score_fn
        self.sigmas = torch.as_tensor(sigmas, dtype=torch.float32).to(
            self.device)
        L = self.sigmas.shape[0]
        # a scalar or a per-level (L,) schedule of the data-consistency
        # weight
        self.lr_sched = torch.broadcast_to(torch.as_tensor(
            lr_scaled, dtype=torch.float32).reshape(-1), (L,)).to(self.device)
        self.lin_tfm = lin_tfm.to(self.device)
        self.proximal = proximal.to(self.device)
        self.config = config
        self.snapshot_fn = snapshot_fn
        self.seg_fn = seg_fn
        if seg_fn is not None:
            if seg_label is None:
                raise ValueError("seg_fn given but seg_label is None")
            label = torch.as_tensor(seg_label).to(self.device)
            # the net sees the interleaved [Re, Im] batch: one label each
            self.seg_label2 = stack_parts(label, label)
            self.lh_weights = get_lh_weights(
                self.sigmas, seg_start_time, seg_step_type).to(self.device)
            self.seg_lamda = torch.as_tensor(
                seg_lamda, dtype=torch.float32).to(self.device)
            self.seg_mode = seg_mode

    def start(self, yr: torch.Tensor, yi: torch.Tensor):
        """The chain's start A^H y, and the proximal with it baked in."""
        xr, xi = self.lin_tfm.conj_op(yr, yi)
        return xr, xi, _bake_ahy(self.proximal, xr, xi)

    def level_step(self, prox, xr, xi, yr, yi, c: int, noise: Noise
                   ) -> Pair:
        """The n_steps_each inner steps of noise level c."""
        cfg = self.config
        sigma = self.sigmas[c]
        step_size = cfg.step_lr * (sigma / self.sigmas[-1]) ** 2
        for _ in range(cfg.n_steps_each):
            stacked = stack_parts(xr, xi)
            grads = self.score_fn(stacked, _labels(stacked, c))
            if self.seg_fn is not None:
                g_seg = compute_seg_grad(self.seg_fn, stacked,
                                         self.seg_label2, self.seg_mode)
                grads = grads + g_seg / sigma * (self.lh_weights[c]
                                                 * self.seg_lamda)
            g_re, g_im = unstack_parts(grads)
            xr = _langevin_update(xr, g_re, step_size, noise(xr.shape))
            xi = _langevin_update(xi, g_im, step_size, noise(xi.shape))
            xr, xi = prox(xr, xi, yr, yi, cfg.step_lr * self.lr_sched[c],
                          1.0)
        return xr, xi

    def denoise(self, xr, xi) -> Pair:
        """x + sigma_L^2 * score(x, L - 1)."""
        stacked = stack_parts(xr, xi)
        grads = self.score_fn(stacked,
                              _labels(stacked, self.sigmas.shape[0] - 1))
        g_re, g_im = unstack_parts(grads)
        s2 = self.sigmas[-1] ** 2
        return xr + s2 * g_re, xi + s2 * g_im

    def __call__(self, yr: torch.Tensor, yi: torch.Tensor, seed: int = 0,
                 noise: Optional[Noise] = None) -> Pair:
        if noise is None:
            noise = gaussian_noise(seed, self.device)
        cfg = self.config
        grad_mode = (torch.inference_mode() if self.seg_fn is None
                     else torch.no_grad())
        with grad_mode:
            yr, yi = yr.to(self.device), yi.to(self.device)
            xr, xi, prox = self.start(yr, yi)
            for c in range(self.sigmas.shape[0]):
                xr, xi = self.level_step(prox, xr, xi, yr, yi, c, noise)
                if (self.snapshot_fn is not None and cfg.snapshot_every > 0
                        and c % cfg.snapshot_every == 0):
                    self.snapshot_fn(c, float(self.sigmas[c]), xr, xi)
            if cfg.denoise:
                xr, xi = self.denoise(xr, xi)
        return xr, xi


def ald_inverse_proximal_pair(
    score_fn: ScoreFn,
    sigmas,
    measurement: Pair,
    lin_tfm,
    proximal,
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    lr_scaled: Union[float, torch.Tensor] = 1.0,
    seg_fn: Optional[Callable] = None,
    seg_label: Optional[torch.Tensor] = None,
    seg_lamda: float = 1.0,
    seg_start_time: float = 1.0,
    seg_step_type: str = "linear",
    seg_mode: str = "full",
    snapshot_fn: Optional[Callable] = None,
    noise: Optional[Noise] = None,
    device="cuda",
) -> Pair:
    """measurement: (yr, yi). Returns the reconstruction pair (xr, xi).
    `seed` takes the place of the JAX PRNG key; `noise(shape)` overrides
    it. `lr_scaled` is a scalar or a per-level (L,) schedule. seg_fn(x)
    with the (B, H, W) seg_label turns the segmentation guidance on.
    snapshot_fn(level, sigma, x_re, x_im) runs on the host every
    config.snapshot_every levels."""
    recon = SteppedPairReconstructor(
        score_fn, sigmas, lin_tfm, proximal, config, lr_scaled, snapshot_fn,
        device, seg_fn=seg_fn, seg_label=seg_label, seg_lamda=seg_lamda,
        seg_start_time=seg_start_time, seg_step_type=seg_step_type,
        seg_mode=seg_mode)
    return recon(*measurement, seed=seed, noise=noise)


def make_stepped_pair_reconstructor(
    model: torch.nn.Module,
    sigmas,
    lin_tfm,
    proximal,
    config: ALDConfig = ALDConfig(),
    lr_scaled: Union[float, torch.Tensor] = 1.0,
    seg_fn: Optional[Callable] = None,
    seg_label: Optional[torch.Tensor] = None,
    seg_lamda: float = 1.0,
    seg_start_time: float = 1.0,
    seg_step_type: str = "linear",
    seg_mode: str = "full",
    seg_params=None,
    snapshot_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> SteppedPairReconstructor:
    """The reconstruction as a user calls it: an NCSNv2-family `model`
    (moved to `device`, eval mode) over the ladder `sigmas`. Returns
    `recon(yr, yi, seed=0, noise=None) -> (xr, xi)`; the JAX form takes
    the params and a PRNG key instead. compute_dtype=torch.bfloat16 runs
    the net in bf16 (make_score_fn), everything else in float32, the
    segmentation guidance included. With `seg_params`, the guidance calls
    seg_fn(seg_params, x), else seg_fn(x); seg_fn's net is the caller's to
    place on `device`."""
    device = resolve_device(device)
    model = model.to(device).eval()
    score_fn = make_score_fn(model, sigmas, compute_dtype)
    if seg_fn is not None and seg_params is not None:
        seg_fn = functools.partial(seg_fn, seg_params)
    return SteppedPairReconstructor(
        score_fn, sigmas, lin_tfm, proximal, config, lr_scaled, snapshot_fn,
        device, seg_fn=seg_fn, seg_label=seg_label, seg_lamda=seg_lamda,
        seg_start_time=seg_start_time, seg_step_type=seg_step_type,
        seg_mode=seg_mode)


# -- 2D+time (cine) ---------------------------------------------------------

def _pair_2d_time_inner(score_S: Optional[ScoreFn],
                        score_T: Optional[ScoreFn], finite_diff: FiniteDiff,
                        config: ALDConfig, mode_T: str, win_size: int,
                        sigma_last: torch.Tensor,
                        sigma_T_last: torch.Tensor):
    """One 2D+time inner step on (B, T, H, W, C) pairs: the spatial score
    step, the temporal step, the proximal (reference semantics:
    ALD_optimizers.py:428-554). Returns inner(prox, xr, xi, yr, yi, c,
    label_T, sigma, sigma_T, active_T, lr_scaled, lamda_T, noise, shift)
    -> (xr, xi): `c` indexes score_S's ladder, `label_T` score_T's RAW
    temporal ladder; `active_T` is the host's sigma_T > 0 (the JAX
    package's lax.cond). The noise comes in the JAX key schedule's order:
    the spatial Re and Im of shape (B T, H, W, C), then, where the
    temporal diffusion step runs, its Re and Im of the tube shape
    (B C H1 W1, T, win^2); `shift` (None: no roll) gives the temporal
    step's random roll."""
    skip_spatial = mode_T in ("diffusion1d-only", "tv-only")
    use_diffusion = "diffusion1d" in mode_T
    use_tv = "tv" in mode_T

    def spatial_step(xr, xi, c, sigma, noise):
        if skip_spatial:
            return xr, xi
        step_size = config.step_lr * (sigma / sigma_last) ** 2
        fr, fi = xr.flatten(0, 1), xi.flatten(0, 1)         # (B T, H, W, C)
        stacked = stack_parts(fr, fi)
        g_re, g_im = unstack_parts(score_S(stacked, _labels(stacked, c)))
        fr = _langevin_update(fr, g_re, step_size, noise(fr.shape))
        fi = _langevin_update(fi, g_im, step_size, noise(fi.shape))
        return fr.reshape(xr.shape), fi.reshape(xi.shape)

    def temporal_step(xr, xi, label_T, sigma_T, active_T, lamda_T, noise,
                      shift):
        if use_tv:
            return (xr + finite_diff.log_lh_grad(xr, lamda=lamda_T),
                    xi + finite_diff.log_lh_grad(xi, lamda=lamda_T))
        if not (use_diffusion and active_T):
            return xr, xi
        step_size = (config.step_lr * (sigma_T / sigma_T_last) ** 2
                     ) * lamda_T

        def tube_update(tr, ti):                         # (B', T, win^2)
            stacked = stack_parts(tr, ti)
            g_re, g_im = unstack_parts(score_T(stacked,
                                               _labels(stacked, label_T)))
            return (_langevin_update(tr, g_re, step_size, noise(tr.shape)),
                    _langevin_update(ti, g_im, step_size, noise(ti.shape)))

        return apply_in_tube_space(tube_update, (xr, xi), win_size, shift)

    def inner(prox, xr, xi, yr, yi, c, label_T, sigma, sigma_T, active_T,
              lr_scaled, lamda_T, noise, shift):
        xr, xi = spatial_step(xr, xi, c, sigma, noise)
        xr, xi = temporal_step(xr, xi, label_T, sigma_T, active_T, lamda_T,
                               noise, shift)
        fr, fi = prox(xr.flatten(0, 1), xi.flatten(0, 1), yr, yi,
                      config.step_lr * lr_scaled, 1.0)
        return fr.reshape(xr.shape), fi.reshape(xi.shape)

    return inner


class Stepped2DTimePairReconstructor:
    """`recon(yr, yi, seed=0, noise=None, shift=None) -> (xr, xi)`: the
    factorized 2D+time ALD chain (reference: ALD_optimizers.py:330-554)
    from the measurement pair (num_sens, B T, H, W, C) (or (B T, H, W, C)
    single-coil) to the (B, T, H, W, C) image pair, under
    torch.inference_mode on `device`. Per level and inner step: the
    spatial score step over all B T frames (score_S, labels index
    `sigmas`); the temporal step (mode_T 'diffusion1d': score_T on pixel
    tubes, labels index the RAW `sigmas_T`, step step_lr (sigma_T /
    sigma_T_L)^2 lamda_T; 'tv': the FiniteDiff subgradient; 'none'; the
    '*-only' modes skip the spatial step and run over the temporal
    ladder); the proximal on the flat layout with A^H y baked in. No
    denoising step, as in the JAX package. The ladders live on the host
    (samplers/ald.setup_2d_time_ladders), so whether a level runs the
    temporal step costs no device read. `noise(shape)` and `shift(win)`
    override the draws seeded with `seed`; the shift is drawn only where
    `if_random_shift`."""

    def __init__(self, score_S: Optional[ScoreFn],
                 score_T: Optional[ScoreFn], sigmas, sigmas_T, lin_tfm,
                 proximal, config: ALDConfig = ALDConfig(),
                 lr_scaled: Union[float, torch.Tensor] = 1.0,
                 mode_T: str = "diffusion1d",
                 lamda_T: Union[float, torch.Tensor] = 1.0,
                 if_random_shift: bool = False, win_size: int = 8,
                 num_frames: Optional[int] = None,
                 snapshot_fn: Optional[Callable] = None, device="cuda"):
        if "diffusion1d" in mode_T and score_T is None:
            raise ValueError(f"mode_T={mode_T!r} needs a temporal score "
                             "function")
        self.device = resolve_device(device)
        self.levels, self.sigmas_T_host, self.labels_T = \
            setup_2d_time_ladders(sigmas, sigmas_T, mode_T)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.sigmas = torch.as_tensor(self.levels, **f32)
        self.sigmas_T = torch.as_tensor(self.sigmas_T_host, **f32)
        self.lr_scaled = torch.as_tensor(lr_scaled, **f32)
        self.lamda_T = torch.as_tensor(lamda_T, **f32)
        self.lin_tfm = lin_tfm.to(self.device)
        self.proximal = proximal.to(self.device)
        self.config = config
        self.if_random_shift = if_random_shift
        self.num_frames = num_frames
        self.snapshot_fn = snapshot_fn
        self.inner = _pair_2d_time_inner(
            score_S, score_T, FiniteDiff(dims=1), config, mode_T, win_size,
            self.sigmas[-1], self.sigmas_T[-1])

    def start(self, yr: torch.Tensor, yi: torch.Tensor):
        """The chain's start A^H y as (B, T, H, W, C), and the proximal
        with the flat (B T, H, W, C) A^H y baked in."""
        xr, xi = self.lin_tfm.conj_op(yr, yi)
        prox = _bake_ahy(self.proximal, xr, xi)
        T = self.num_frames or xr.shape[0]
        shape = (xr.shape[0] // T, T) + tuple(xr.shape[1:])
        return xr.reshape(shape), xi.reshape(shape), prox

    def level_step(self, prox, xr, xi, yr, yi, c: int, noise: Noise,
                   shift: Optional[Shift] = None) -> Pair:
        """The n_steps_each inner steps of level c."""
        level = (c, int(self.labels_T[c]), self.sigmas[c], self.sigmas_T[c],
                 bool(self.sigmas_T_host[c] > 0))
        shift = shift if self.if_random_shift else None
        for _ in range(self.config.n_steps_each):
            xr, xi = self.inner(prox, xr, xi, yr, yi, *level,
                                self.lr_scaled, self.lamda_T, noise, shift)
        return xr, xi

    def __call__(self, yr: torch.Tensor, yi: torch.Tensor, seed: int = 0,
                 noise: Optional[Noise] = None,
                 shift: Optional[Shift] = None) -> Pair:
        if noise is None:
            noise = gaussian_noise(seed, self.device)
        if shift is None and self.if_random_shift:
            shift = random_shift(seed)
        cfg = self.config
        with torch.inference_mode():
            yr, yi = yr.to(self.device), yi.to(self.device)
            xr, xi, prox = self.start(yr, yi)
            for c in range(len(self.levels)):
                xr, xi = self.level_step(prox, xr, xi, yr, yi, c, noise,
                                         shift)
                if (self.snapshot_fn is not None and cfg.snapshot_every > 0
                        and c % cfg.snapshot_every == 0):
                    self.snapshot_fn(c, float(self.levels[c]), xr, xi)
        return xr, xi


def ald_2d_time_pair(
    score_fn_S: Optional[ScoreFn],
    score_fn_T: Optional[ScoreFn],
    sigmas,
    sigmas_T,
    measurement: Pair,
    lin_tfm,
    proximal,
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    lr_scaled: Union[float, torch.Tensor] = 1.0,
    mode_T: str = "diffusion1d",
    lamda_T: Union[float, torch.Tensor] = 1.0,
    if_random_shift: bool = False,
    win_size: int = 8,
    num_frames: Optional[int] = None,
    snapshot_fn: Optional[Callable] = None,
    noise: Optional[Noise] = None,
    shift: Optional[Shift] = None,
    device="cuda",
) -> Pair:
    """Pair-form factorized 2D+time reconstruction: measurement ((num_sens,
    B T, H, W, C), same); returns (xr, xi) of shape (B, T, H, W, C).
    score_fn_T's integer labels index the RAW sigmas_T ladder. `seed`
    takes the place of the JAX PRNG key; `noise` and `shift` override
    it."""
    recon = Stepped2DTimePairReconstructor(
        score_fn_S, score_fn_T, sigmas, sigmas_T, lin_tfm, proximal, config,
        lr_scaled, mode_T, lamda_T, if_random_shift, win_size, num_frames,
        snapshot_fn, device)
    return recon(*measurement, seed=seed, noise=noise, shift=shift)


def make_stepped_2d_time_pair_reconstructor(
    model_S: torch.nn.Module,
    model_T: Optional[torch.nn.Module],
    sigmas,
    sigmas_T,
    lin_tfm,
    proximal,
    config: ALDConfig = ALDConfig(),
    lr_scaled: Union[float, torch.Tensor] = 1.0,
    mode_T: str = "diffusion1d",
    lamda_T: Union[float, torch.Tensor] = 1.0,
    if_random_shift: bool = False,
    win_size: int = 8,
    num_frames: Optional[int] = None,
    snapshot_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> Stepped2DTimePairReconstructor:
    """The cine reconstruction as a user calls it: the spatial NCSNv2
    `model_S` over `sigmas` and the 1-D temporal `model_T` (models/
    ncsn1d.py) over its RAW ladder `sigmas_T`, both moved to `device` in
    eval mode (model_T may be None where mode_T has no 'diffusion1d').
    Returns `recon(yr, yi, seed=0, noise=None, shift=None) -> (xr, xi)`;
    the JAX form takes both nets' params and a PRNG key instead.
    compute_dtype=torch.bfloat16 runs both nets in bf16."""
    device = resolve_device(device)
    score_S = make_score_fn(model_S.to(device).eval(), sigmas, compute_dtype)
    score_T = None
    if model_T is not None:
        score_T = make_score_fn(model_T.to(device).eval(), sigmas_T,
                                compute_dtype)
    return Stepped2DTimePairReconstructor(
        score_S, score_T, sigmas, sigmas_T, lin_tfm, proximal, config,
        lr_scaled, mode_T, lamda_T, if_random_shift, win_size, num_frames,
        snapshot_fn, device)

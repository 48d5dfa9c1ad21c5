"""ALD loop variants: inpainting, interpolation, class-conditioned, the
inverse problem with normalized likelihood mixing and its projection form,
and the classifier-guided inverse samplers.

Port of `_denoise` (:40), `ald_inpainting` (:46), `half_mask` (:91),
`ald_interpolation` (:101), `ald_cls_conditioned` (:145),
`ald_inverse_problem` (:182), `ald_inverse_problem_proj` (:230),
`ald_inverse_clf` (:281) and `ald_inverse_clf_proximal` (:327) from
inverseproblemwithdiffusionmodel_tpu/samplers/ald_variants.py (reference:
ncsn/models/__init__.py:41-393; the classifier-guided samplers are the JAX
package's, re-grown from `compute_clf_grad` and the proximal Re/Im pattern
of ALD_optimizers.py:161-327).

Each sampler is a host loop over the levels and config.n_steps_each inner
steps, as `ald.ald_unconditional_sampler` is. One torch.Generator on
`device`, seeded with `seed`, draws the start (U(0, 1) where the sampler
has one and `x_init` is not given) and then the noise; `noise(shape)`
overrides the noise, drawn in the order of the JAX key schedule, so that a
test can feed JAX's own draws. The measurement, operator and proximal move
to `device`; score_fn and clf_fn must run there. The samplers with a
classifier run under torch.no_grad (its gradient needs autograd), the
others under torch.inference_mode.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .ald import (ALDConfig, ScoreFn, _labels, _langevin_update,
                  compute_clf_grad)
from .sigmas import get_lh_weights
from ..utils.device import Noise, resolve_device
from ..utils.misc import stack_parts, unstack_parts

ClfFn = Callable[[torch.Tensor], torch.Tensor]


def _setup(sigmas, seed: int, noise: Optional[Noise], device
           ) -> Tuple[torch.device, torch.Generator, Noise, torch.Tensor]:
    """The device, the call's generator, the noise source (the generator's
    normals unless `noise` is given) and the float32 ladder on the
    device."""
    device = resolve_device(device)
    gen = torch.Generator(device).manual_seed(seed)
    if noise is None:
        noise = lambda s: torch.randn(tuple(s), generator=gen, device=device)
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32).to(device)
    return device, gen, noise, sigmas


def _start(x_init, shape, gen: torch.Generator, device) -> torch.Tensor:
    """x_init on the device, else U(0, 1) of `shape` from the generator."""
    if x_init is not None:
        return torch.as_tensor(x_init, dtype=torch.float32).to(device)
    return torch.rand(tuple(shape), generator=gen, device=device)


def _lamdas(lamdas, num: int, device) -> torch.Tensor:
    """A float or one weight per level, broadcast to the ladder, float32."""
    return torch.as_tensor(lamdas, dtype=torch.float32).broadcast_to(
        (num,)).to(device)


def _step_size(config: ALDConfig, sigma: torch.Tensor,
               sigma_last: torch.Tensor) -> torch.Tensor:
    return config.step_lr * (sigma / sigma_last) ** 2


def _denoise(score_fn: ScoreFn, x: torch.Tensor, sigmas: torch.Tensor
             ) -> torch.Tensor:
    """One denoising step at the last level: x + sigma_L^2 score(x)."""
    L = sigmas.shape[0]
    return x + sigmas[-1] ** 2 * score_fn(x, _labels(x, L - 1))


def _denoise_parts(score_fn: ScoreFn, x_re: torch.Tensor,
                   x_im: torch.Tensor, sigmas: torch.Tensor
                   ) -> torch.Tensor:
    """The denoising step of a complex state, Re and Im interleaved through
    one score evaluation; returns complex64."""
    stacked = stack_parts(x_re, x_im)
    g_re, g_im = unstack_parts(score_fn(stacked, _labels(
        stacked, sigmas.shape[0] - 1)))
    return torch.complex(x_re + sigmas[-1] ** 2 * g_re,
                         x_im + sigmas[-1] ** 2 * g_im)


def ald_inpainting(
    score_fn: ScoreFn,
    sigmas,
    refer_image: torch.Tensor,
    known_mask: torch.Tensor,
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    x_init: Optional[torch.Tensor] = None,
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """Mask-generalized inpainting ALD (reference: ncsn/models/__init__.py:
    86, which hardcodes "right half missing"; `known_mask` is 1 where
    pixels are observed). Each inner step first re-injects the known pixels
    noised at the level's sigma, then takes the Langevin step. x starts at
    U(0, 1) of refer_image's shape. As in the reference there is no final
    denoising step (config.denoise is ignored; call `_denoise` after it if
    wanted). Draws per inner step: the known pixels' noise, then the
    Langevin noise."""
    device, gen, noise, sigmas = _setup(sigmas, seed, noise, device)
    refer = torch.as_tensor(refer_image, dtype=torch.float32).to(device)
    with torch.inference_mode():
        x = _start(x_init, refer.shape, gen, device)
        mask = torch.as_tensor(known_mask).to(device, x.dtype)
        for c in range(sigmas.shape[0]):
            sigma = sigmas[c]
            step_size = _step_size(config, sigma, sigmas[-1])
            for _ in range(config.n_steps_each):
                corrupted = refer + noise(refer.shape) * sigma
                x = mask * corrupted + (1.0 - mask) * x
                grad = score_fn(x, _labels(x, c))
                x = _langevin_update(x, grad, step_size, noise(x.shape))
        return x


def half_mask(shape: Sequence[int], axis: int = -2) -> torch.Tensor:
    """Known-left-half mask (the reference's fixed inpainting pattern):
    float32 ones on the first shape[axis] // 2 entries along `axis`, on the
    CPU."""
    m = np.zeros(tuple(shape), np.float32)
    sl = [slice(None)] * len(shape)
    sl[axis] = slice(0, shape[axis] // 2)
    m[tuple(sl)] = 1.0
    return torch.from_numpy(m)


def ald_interpolation(
    score_fn: ScoreFn,
    sigmas,
    x_init: torch.Tensor,
    n_interpolations: int,
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """Noise-interpolated ALD (reference: ncsn/models/__init__.py:118-165):
    each of the B rows of x_init spawns `n_interpolations` chains (rows r n
    to r n + n - 1), whose Langevin noise at every inner step slerps two
    draws of B rows, noise_p cos(a_k) + noise_q sin(a_k) with a_k evenly
    spaced over [0, pi / 2]. No denoising step, as in the JAX package.
    Returns (B n_interpolations, ...)."""
    device, _, noise, sigmas = _setup(sigmas, seed, noise, device)
    x_init = torch.as_tensor(x_init, dtype=torch.float32).to(device)
    n_rows, feat = x_init.shape[0], tuple(x_init.shape[1:])
    angles = torch.as_tensor(np.linspace(0.0, np.pi / 2.0, n_interpolations),
                             dtype=torch.float32).to(device)
    fshape = (1, n_interpolations) + (1,) * len(feat)
    cosf, sinf = torch.cos(angles).reshape(fshape), torch.sin(
        angles).reshape(fshape)
    with torch.inference_mode():
        x = torch.repeat_interleave(x_init, n_interpolations, dim=0)
        for c in range(sigmas.shape[0]):
            step_size = _step_size(config, sigmas[c], sigmas[-1])
            for _ in range(config.n_steps_each):
                grad = score_fn(x, _labels(x, c))
                noise_p = noise((n_rows,) + feat)
                noise_q = noise((n_rows,) + feat)
                z = (noise_p[:, None] * cosf + noise_q[:, None] * sinf
                     ).reshape((-1,) + feat)
                x = _langevin_update(x, grad, step_size, z)
        return x


def ald_cls_conditioned(
    score_fn: ScoreFn,
    clf_fn: ClfFn,
    cls: torch.Tensor,
    sigmas,
    shape: Tuple[int, ...],
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    x_init: Optional[torch.Tensor] = None,
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """Classifier-guided prior sampling (reference: ncsn/models/__init__.py:
    219-266): the score plus grad_x log p(cls | x) of the frozen
    classifier at every inner step; x starts at U(0, 1) of `shape`; a
    denoising step where config.denoise."""
    device, gen, noise, sigmas = _setup(sigmas, seed, noise, device)
    cls = torch.as_tensor(cls).to(device)
    with torch.no_grad():
        x = _start(x_init, shape, gen, device)
        for c in range(sigmas.shape[0]):
            step_size = _step_size(config, sigmas[c], sigmas[-1])
            for _ in range(config.n_steps_each):
                grad = score_fn(x, _labels(x, c)) + compute_clf_grad(
                    clf_fn, x, cls)
                x = _langevin_update(x, grad, step_size, noise(x.shape))
        if config.denoise:
            x = _denoise(score_fn, x, sigmas)
        return x


def ald_inverse_problem(
    score_fn: ScoreFn,
    sigmas,
    measurement: torch.Tensor,
    lin_tfm,
    lamdas: Union[float, Sequence[float], torch.Tensor],
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    x_init: Optional[torch.Tensor] = None,
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """ALD with the likelihood gradient g_lh = Re(lin_tfm.log_lh_grad(x,
    y, lamda_c)) renormalized to the prior score's norm (reference:
    ncsn/models/__init__.py:269-328): grad + g_lh / max(|g_lh|, 1e-20) *
    |grad|, both norms over the whole batch tensor (not per chain), as in
    the JAX package. Real-valued state, starting at U(0, 1) of Re(A^H y)'s
    shape; `lamdas` a float or one per level; a denoising step where
    config.denoise."""
    device, gen, noise, sigmas = _setup(sigmas, seed, noise, device)
    lamdas = _lamdas(lamdas, sigmas.shape[0], device)
    lin_tfm, measurement = lin_tfm.to(device), measurement.to(device)
    with torch.inference_mode():
        x = _start(x_init, lin_tfm.conj_op(measurement).shape, gen, device)
        for c in range(sigmas.shape[0]):
            step_size = _step_size(config, sigmas[c], sigmas[-1])
            for _ in range(config.n_steps_each):
                grad = score_fn(x, _labels(x, c))
                g_lh = lin_tfm.log_lh_grad(x.to(torch.complex64),
                                           measurement, lamdas[c]).real
                g_norm = torch.linalg.vector_norm(grad)
                lh_norm = torch.clamp(torch.linalg.vector_norm(g_lh),
                                      min=1e-20)
                grad = grad + g_lh / lh_norm * g_norm
                x = _langevin_update(x, grad, step_size, noise(x.shape))
        if config.denoise:
            x = _denoise(score_fn, x, sigmas)
        return x


def ald_inverse_problem_proj(
    score_fn: ScoreFn,
    sigmas,
    measurement: torch.Tensor,
    lin_tfm,
    lamdas: Union[float, Sequence[float], torch.Tensor],
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    x_init: Optional[torch.Tensor] = None,
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """The projection variant (reference: ncsn/models/__init__.py:331-393):
    a complex state, projected onto the data with lin_tfm.projection(x, y,
    lamda_c) before each level's inner steps; each inner step evaluates the
    score on the interleaved [Re, Im] batch and takes the Langevin step of
    Re, then Im. x starts at U(0, 1) (imaginary part 0) of A^H y's shape;
    a denoising step where config.denoise. Draws per inner step: Re's
    noise, then Im's. Returns complex64."""
    device, gen, noise, sigmas = _setup(sigmas, seed, noise, device)
    lamdas = _lamdas(lamdas, sigmas.shape[0], device)
    lin_tfm, measurement = lin_tfm.to(device), measurement.to(device)
    with torch.inference_mode():
        x0 = lin_tfm.conj_op(measurement)
        x = _start(x_init, x0.shape, gen, device).to(torch.complex64)
        for c in range(sigmas.shape[0]):
            step_size = _step_size(config, sigmas[c], sigmas[-1])
            x = lin_tfm.projection(x, measurement, lamdas[c])
            x_re, x_im = x.real, x.imag
            for _ in range(config.n_steps_each):
                stacked = stack_parts(x_re, x_im)
                g_re, g_im = unstack_parts(score_fn(stacked,
                                                    _labels(stacked, c)))
                x_re = _langevin_update(x_re, g_re, step_size,
                                        noise(x_re.shape))
                x_im = _langevin_update(x_im, g_im, step_size,
                                        noise(x_im.shape))
            x = torch.complex(x_re, x_im)
        if config.denoise:
            x = _denoise_parts(score_fn, x.real, x.imag, sigmas)
        return x


def ald_inverse_clf(
    score_fn: ScoreFn,
    clf_fn: ClfFn,
    cls: torch.Tensor,
    sigmas,
    measurement: torch.Tensor,
    lin_tfm,
    lamdas: Union[float, Sequence[float], torch.Tensor],
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    clf_lamda: float = 1.0,
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """Class-conditional inverse sampling (the JAX package's re-grown
    `ALDInvClf`): per inner step the prior score, plus clf_lamda times the
    classifier guidance gradient, plus the data-consistency gradient
    Re(lin_tfm.log_lh_grad(x, y, lamda_c)), unnormalized. Real-valued
    state starting at Re(A^H y) (no start draw; JAX's key is fold_in(key,
    0)); a denoising step where config.denoise."""
    device, _, noise, sigmas = _setup(sigmas, seed, noise, device)
    lamdas = _lamdas(lamdas, sigmas.shape[0], device)
    lin_tfm, measurement = lin_tfm.to(device), measurement.to(device)
    cls = torch.as_tensor(cls).to(device)
    with torch.no_grad():
        x = lin_tfm.conj_op(measurement).real
        for c in range(sigmas.shape[0]):
            step_size = _step_size(config, sigmas[c], sigmas[-1])
            for _ in range(config.n_steps_each):
                grad = score_fn(x, _labels(x, c))
                grad = grad + compute_clf_grad(clf_fn, x, cls) * clf_lamda
                grad = grad + lin_tfm.log_lh_grad(
                    x.to(torch.complex64), measurement, lamdas[c]).real
                x = _langevin_update(x, grad, step_size, noise(x.shape))
        if config.denoise:
            x = _denoise(score_fn, x, sigmas)
        return x


def ald_inverse_clf_proximal(
    score_fn: ScoreFn,
    clf_fn: ClfFn,
    cls: torch.Tensor,
    sigmas,
    measurement: torch.Tensor,
    lin_tfm,
    proximal,
    seed: int = 0,
    config: ALDConfig = ALDConfig(),
    lr_scaled: float = 1.0,
    clf_lamda: float = 1.0,
    clf_start_time: Optional[float] = None,
    clf_step_type: str = "linear",
    noise: Optional[Noise] = None,
    device="cuda",
) -> torch.Tensor:
    """Classifier guidance with proximal data consistency on the Re/Im split
    (the JAX package's re-grown `ALDInvClfProximal`, the pattern of
    ALD_optimizers.py:161-327 with the classifier's gradient in place of
    the seg net's). It starts at A^H y. Each inner step evaluates the score
    and the classifier's gradient on the interleaved [Re, Im] batch (the
    class target interleaved alike, stack_parts(cls, cls)) and adds the
    gradient times clf_lamda, or, where `clf_start_time` is given, the ramp
    g_clf / sigma * (get_lh_weights(sigmas, clf_start_time,
    clf_step_type)[c] * clf_lamda) (the reference prox script's form,
    mnist_inv_clf_prox_sampling.py:32-33); then the Langevin steps of Re
    and Im and the proximal step on x_re + i x_im with alpha = step_lr *
    lr_scaled and lamda 1. A denoising step where config.denoise. Draws per
    inner step: Re's noise, then Im's. Returns complex64."""
    device, _, noise, sigmas = _setup(sigmas, seed, noise, device)
    lin_tfm, proximal = lin_tfm.to(device), proximal.to(device)
    measurement = measurement.to(device)
    cls = torch.as_tensor(cls).to(device)
    cls2 = stack_parts(cls, cls)
    ramped = clf_start_time is not None
    if ramped:
        lh_weights = get_lh_weights(sigmas, clf_start_time,
                                    clf_step_type).to(device)
    alpha = config.step_lr * lr_scaled
    with torch.no_grad():
        x0 = lin_tfm.conj_op(measurement)
        x_re, x_im = x0.real, x0.imag
        for c in range(sigmas.shape[0]):
            sigma = sigmas[c]
            step_size = _step_size(config, sigma, sigmas[-1])
            for _ in range(config.n_steps_each):
                stacked = stack_parts(x_re, x_im)
                grads = score_fn(stacked, _labels(stacked, c))
                g_clf = compute_clf_grad(clf_fn, stacked, cls2)
                if ramped:
                    grads = grads + g_clf / sigma * (lh_weights[c]
                                                     * clf_lamda)
                else:
                    grads = grads + g_clf * clf_lamda
                g_re, g_im = unstack_parts(grads)
                x_re = _langevin_update(x_re, g_re, step_size,
                                        noise(x_re.shape))
                x_im = _langevin_update(x_im, g_im, step_size,
                                        noise(x_im.shape))
                z = proximal(torch.complex(x_re, x_im), measurement, alpha,
                             1.0)
                x_re, x_im = z.real, z.imag
        if config.denoise:
            return _denoise_parts(score_fn, x_re, x_im, sigmas)
        return torch.complex(x_re, x_im)

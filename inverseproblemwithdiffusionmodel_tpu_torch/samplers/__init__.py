"""Noise-level ladders and the annealed Langevin (ALD) samplers with their
variants; the MAP and TV baselines, exported as the JAX package exports
them."""
from .sigmas import (get_sigmas, get_lh_weights, sigma_ladder,
                     check_ladder_stability)
from .ald import (
    ALDConfig,
    ald_unconditional_sampler,
    ald_inverse_seg_proximal_real_imag,
    ald_2d_time,
    interp_sigmas_T,
    compute_clf_grad,
    compute_seg_grad,
)
from .ald_variants import (
    ald_inpainting,
    half_mask,
    ald_interpolation,
    ald_cls_conditioned,
    ald_inverse_problem,
    ald_inverse_problem_proj,
    ald_inverse_clf,
    ald_inverse_clf_proximal,
)
from .map_opt import (
    MAPConfig,
    map_optimizer,
    map_optimizer_2d_time,
    tv_reconstruction,
)
from .map_pair import (
    map_optimizer_pair,
    map_optimizer_2d_time_pair,
    tv_reconstruction_pair,
)

# ald_pair imports models/, whose DDPM imports samplers.sigmas: its four
# names load on first use (PEP 562), so that importing models first does
# not meet a half-initialised ald_pair
_ALD_PAIR = ("ald_inverse_proximal_pair", "ald_2d_time_pair",
             "make_stepped_pair_reconstructor",
             "make_stepped_2d_time_pair_reconstructor")


def __getattr__(name):
    if name in _ALD_PAIR:
        from . import ald_pair
        return getattr(ald_pair, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_ALD_PAIR))

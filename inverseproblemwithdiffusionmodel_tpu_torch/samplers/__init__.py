"""Noise-level ladders and the annealed Langevin (ALD) samplers with their
variants; the MAP and TV baselines, exported as the JAX package exports
them."""
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

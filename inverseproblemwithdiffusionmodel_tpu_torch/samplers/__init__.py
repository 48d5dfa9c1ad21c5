"""Noise-level ladders and the annealed Langevin (ALD) samplers; the MAP
and TV baselines, exported as the JAX package exports them."""
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

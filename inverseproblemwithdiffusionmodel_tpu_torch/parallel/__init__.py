"""Reconstruction ensembles: the host half of the JAX package's
parallel/ (chain sharding over devices is not ported yet; ROADMAP Slice
P)."""
from .ensemble import ensemble_mean_std, repeat_measurement

__all__ = ["ensemble_mean_std", "repeat_measurement"]

"""Nested attribute-access config and the dataset config loader.

Port of `Config`, `load_config` and `load_general_config` of
inverseproblemwithdiffusionmodel_tpu/config.py. The YAML files stay behind:
the port's configs are built in code (configs_continuous.py,
configs_discrete.py).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class Config:
    """Nested attribute-access config. Dicts become child Configs."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        if data:
            for key, value in data.items():
                setattr(self, key, Config(value) if isinstance(value, dict) else value)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self.__dict__.items():
            out[key] = value.to_dict() if isinstance(value, Config) else value
        return out

    def replace(self, **updates: Any) -> "Config":
        """Return a deep copy with dotted-key updates applied.

        cfg.replace(**{"model.nf": 32, "data.image_size": 64})
        """
        new = copy.deepcopy(self)
        for dotted, value in updates.items():
            node = new
            parts = dotted.split(".")
            for part in parts[:-1]:
                child = getattr(node, part, None)
                if not isinstance(child, Config):
                    child = Config()
                    setattr(node, part, child)
                node = child
            setattr(node, parts[-1], value)
        return new

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and self.to_dict() == other.to_dict()


DATA_MODES = ("real-valued", "mag", "complex", "real-imag", "real-imag-random")


def load_config(ds_name: str, mode: str = "real-valued", **overrides: Any
                ) -> Config:
    """A dataset config, as the JAX package's `load_config` reads it from
    its YAML file. mode == "complex" sets two input channels (real and
    imaginary stacked). Extra keyword args are dotted-key overrides, e.g.
    ``**{"model.ngf": 32}``. Ported: ACDC, CINE127, CINE127_1D, CINE64 and
    CINE64_1D (configs_discrete.DATASETS); others raise."""
    from .configs_discrete import DATASETS
    if mode not in DATA_MODES:
        raise ValueError(f"unknown data mode {mode!r}; one of {DATA_MODES}")
    if ds_name not in DATASETS:
        raise NotImplementedError(
            f"dataset config {ds_name!r} is not ported yet; ported: "
            f"{sorted(DATASETS)}")
    config = Config(copy.deepcopy(DATASETS[ds_name]))
    if mode == "complex":
        config.data.channels = 2
    if overrides:
        config = config.replace(**overrides)
    return config


def load_general_config() -> Config:
    """The Seg / Clf architecture and trainer constants, as the JAX
    package's `load_general_config` reads them from general_config.yml."""
    from .configs_discrete import GENERAL
    return Config(copy.deepcopy(GENERAL))

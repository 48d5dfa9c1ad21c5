"""The repository's trained priors and the JAX package's training
checkpoints, read and written by the port.

A prior artifact is a Flax parameter tree saved by
`flax.serialization.to_bytes` / `msgpack_serialize` (the cine priors
`artifacts/cine_priors_128/{spatial,temporal}.msgpack`, the NCSN++ of
`artifacts/continuous_demo/ncsnpp.msgpack`, the ACDC prior
`artifacts/acdc_prior/{raw,ema}_bf16.msgpack`, the examples'
`prior.msgpack`). `load_prior` reads one through `utils/flax_msgpack` and
maps it onto a port model with `utils/convert`'s layouts; `save_prior`
writes a port model back in the Flax layout (`utils/torch_import.
flax_layout`), so the JAX package's `serialization.from_bytes` reads it.
`read_train_state` reads the JAX examples' rolling `train_state.ckpt`
({step, state: {params, ema: {params, ...}, opt_state, ...}}).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from . import convert, flax_msgpack
from .torch_import import _unflatten, flax_layout

DType = Union[None, str, torch.dtype, np.dtype]


def float32_tree(tree):
    """The tree with every floating leaf as a float32 numpy array (bfloat16
    torch leaves included); other leaves as they are."""
    if isinstance(tree, Mapping):
        return {k: float32_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    if isinstance(tree, np.ndarray) and np.issubdtype(tree.dtype,
                                                      np.floating):
        return tree.astype(np.float32)
    return tree


def cast_tree(tree, dtype: DType):
    """The tree with every floating leaf cast to `dtype` (bfloat16 as a
    torch.bfloat16 tensor, as the reader gives it); None keeps it."""
    if dtype is None:
        return tree
    if isinstance(tree, Mapping):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    is_float = (tree.is_floating_point() if isinstance(tree, torch.Tensor)
                else isinstance(tree, np.ndarray)
                and np.issubdtype(tree.dtype, np.floating))
    if not is_float:
        return tree
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.as_tensor(np.asarray(float32_tree(tree))).to(
            torch.bfloat16)
    return np.asarray(float32_tree(tree)).astype(np.dtype(dtype))


def state_dict_from_tree(params: Mapping[str, Any], model: torch.nn.Module,
                         what: Optional[str] = None
                         ) -> Dict[str, torch.Tensor]:
    """The port state dict for `model` from a Flax params tree, held name
    by name and shape by shape to it (utils/convert; raises on a
    difference). A ScoreNet takes utils/convert's kernel flips."""
    from ..models.simple import ScoreNet
    params = float32_tree(params)
    if isinstance(model, ScoreNet):
        return convert.flax_to_torch_scorenet(params)
    return convert.flax_to_torch_model(params, lambda: model,
                                       what or type(model).__name__)


def load_prior(path: str, model: torch.nn.Module, key: Optional[str] = None
               ) -> torch.nn.Module:
    """Load the Flax prior at `path` (the params tree, or the subtree
    `key` of it, e.g. "params") into `model` in place; bfloat16 files are
    widened to float32. Returns the model."""
    tree = flax_msgpack.read(path)
    if key is not None:
        tree = tree[key]
    model.load_state_dict(state_dict_from_tree(tree, model))
    return model


def prior_tree(model: torch.nn.Module, dtype: DType = None
               ) -> Dict[str, Any]:
    """The model's parameters as the JAX package's Flax params tree, float
    leaves cast to `dtype` (None: as they are)."""
    return cast_tree(_unflatten(flax_layout(model)), dtype)


def save_prior(model: torch.nn.Module, path: str, dtype: DType = None
               ) -> None:
    """Write the model's parameters to `path` as the JAX package's
    `serialization.to_bytes(params)` would (dtype: e.g. "bfloat16" for the
    committed artifacts' form)."""
    flax_msgpack.save(path, prior_tree(model, dtype))


def read_train_state(path: str) -> Dict[str, Any]:
    """The JAX examples' `train_state.ckpt`: {"step": int, "params": the
    raw params tree, "ema": the EMA params tree or None, "state": the
    whole state dict as stored}."""
    blob = flax_msgpack.read(path)
    state = blob["state"]
    ema = state.get("ema")
    return {"step": int(blob["step"]), "params": state["params"],
            "ema": ema.get("params") if isinstance(ema, Mapping) else None,
            "state": state}

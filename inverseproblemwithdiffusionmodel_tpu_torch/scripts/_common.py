"""Shared CLI machinery: artifact layout, model reload and config
overrides.

Port of `save_artifacts`, `reload_model`, `add_common_args` and
`apply_overrides` from inverseproblemwithdiffusionmodel_tpu/scripts/
_common.py. Override values are parsed as Python literals, falling back to
the raw string. Checkpoints are the port's own (training/checkpoint.py);
a JAX orbax checkpoint is converted to one first, on a host with orbax
(convert_orbax_checkpoint.py at the repository's root).
"""
from __future__ import annotations

import ast
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.registry import load_model
from ..training.checkpoint import Checkpointer
from ..utils.misc import get_timestamp


def save_artifacts(save_dir: str, args: Optional[Dict[str, Any]] = None,
                   **arrays: Any) -> str:
    """Save numpy arrays as .npy + args.json in a new timestamped directory
    under save_dir; returns that directory. args.json also records the
    datasets this process loaded (`data_provenance`), as in the JAX
    package."""
    run_dir = os.path.join(save_dir, get_timestamp())
    os.makedirs(run_dir, exist_ok=True)
    for name, arr in arrays.items():
        if arr is not None:
            np.save(os.path.join(run_dir, f"{name}.npy"), np.asarray(arr))
    if args is not None:
        payload = {k: (v if isinstance(v, (int, float, str, bool, list,
                                           type(None))) else str(v))
                   for k, v in args.items()}
        # which datasets this process loaded, and whether each came from
        # files or the synthetic stand-in
        from ..data.datasets import data_provenance
        prov = data_provenance()
        if prov:
            payload["data_provenance"] = prov
        with open(os.path.join(run_dir, "args.json"), "w") as f:
            json.dump(payload, f, indent=2, default=str)
    return run_dir


def reload_model(config: Config, task_name: str,
                 ckpt_dir: Optional[str] = None, use_ema: bool = True,
                 seed: int = 0) -> Tuple[torch.nn.Module, None]:
    """Construct a task's model (models/registry.load_model, on the CPU)
    and load its weights from the latest checkpoint in `ckpt_dir`, the EMA
    shadow where `use_ema` and the checkpoint has one. Without a checkpoint
    directory it warns loudly and keeps weights drawn from `seed`, so
    pipelines stay runnable end to end. A directory of the JAX package's
    orbax checkpoints raises (Checkpointer.all_steps). Returns
    (module, None), as load_model does."""
    module, _ = load_model(config, task_name, seed=seed)
    if ckpt_dir and os.path.isdir(ckpt_dir):
        ckpt = Checkpointer(ckpt_dir, track_best=False)
        params, step = ckpt.restore_params(use_ema=use_ema)
        ckpt.close()
        module.load_state_dict(params, strict=True)
        print(f"[reload_model] {task_name}: restored step {step} from "
              f"{ckpt_dir}")
    else:
        print(f"[reload_model] WARNING: no checkpoint for {task_name} "
              f"(ckpt_dir={ckpt_dir!r}); using RANDOM weights drawn from "
              f"seed {seed}")
    return module, None


def add_common_args(parser, num_samples: bool = True, ckpt: bool = True):
    """Shared CLI flags, with the port's --device (default cuda). Scripts
    that cannot honor a flag must not advertise it: deterministic
    single-chain optimizers pass num_samples=False; prior-free baselines
    pass ckpt=False."""
    parser.add_argument("--save_dir", default="outputs")
    if ckpt:
        parser.add_argument("--ckpt_dir", default=None,
                            help="checkpoint dir of the trained score model "
                                 "(training/checkpoint.Checkpointer)")
    parser.add_argument("--seed", type=int, default=0)
    if num_samples:
        parser.add_argument("--num_samples", type=int, default=1,
                            help="ensemble chains (batch rows)")
    parser.add_argument("--override", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="dotted config override, e.g. model.ngf=16")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def _parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(config: Config, overrides) -> Config:
    """Apply repeated --override key=value flags."""
    if not overrides:
        return config
    updates = {}
    for item in overrides:
        key, _, value = item.partition("=")
        updates[key] = _parse_value(value)
    return config.replace(**updates)


def script_mesh(device: torch.device):
    """--use_mesh's mesh: every card torch sees on the data axis, or the
    one CPU device for --device cpu."""
    from ..parallel import make_mesh
    return make_mesh(devices=None if device.type == "cuda" else [device])

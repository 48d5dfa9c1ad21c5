"""Convert a JAX package checkpoint (orbax) into a checkpoint of the
PyTorch port, which every port CLI then reads through --ckpt_dir:

  python convert_orbax_checkpoint.py --jax_ckpt_dir runs/ACDC_Diffusion_real-imag/ckpts \\
      --ds_name ACDC --task_name Diffusion --mode real-imag \\
      --out_dir runs/port/ACDC_Diffusion_real-imag/ckpts

or, for the continuous stack (NCSN++, DDPM), --continuous <config path>
in place of --ds_name / --task_name / --mode. --override takes the
config overrides the checkpoint was trained with.

This is a host tool of the repository, outside the port package: it
imports orbax (and, through it, JAX) to read the step directories that
inverseproblemwithdiffusionmodel_tpu/training/checkpoint.Checkpointer
writes (StandardSave of {params, ema, opt_state, step}, the val_loss
metrics beside them). The port itself imports neither, and a machine
with only the port (the GPU machine has no orbax) runs the conversion
elsewhere first. The read is the template-free one of the JAX
`restore_params`, so any optimizer wrapping reads.

Every step in --jax_ckpt_dir is converted:
- params and the EMA shadow go through utils/convert.flax_to_torch_model
  onto the port's model (conv kernels (*k, I, O) -> (O, I, *k), Dense
  kernels transposed, ...); the EMA decay is the config's
  model.ema_rate, since the JAX state does not save it;
- Adam's state (optax's ScaleByAdamState count, mu, nu, found anywhere in
  the opt_state, so under a weight-decay mask or a clip too) becomes
  torch Adam's step, exp_avg and exp_avg_sq, the moments through the
  same conversion as the parameters they shadow; under optax.MultiSteps
  the accumulated gradients, mini_step and gradient_step become the
  port's MultiSteps state (then pass --grad_accum to the trainer as
  before);
- the step count and the val_loss (best-tracking) are kept.
Another optimizer's state raises, naming the optimizer.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import orbax.checkpoint as ocp
import torch

from inverseproblemwithdiffusionmodel_tpu_torch.config import load_config
from inverseproblemwithdiffusionmodel_tpu_torch.models.ema import EmaState
from inverseproblemwithdiffusionmodel_tpu_torch.models.registry import (
    create_model, load_model)
from inverseproblemwithdiffusionmodel_tpu_torch.scripts._common import (
    apply_overrides)
from inverseproblemwithdiffusionmodel_tpu_torch.training import (
    Checkpointer, MultiSteps, TrainState, get_optimizer)
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_model)

_ADAM = {"count", "mu", "nu"}
_MULTI = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads"}


def _numpy(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def _find(tree: Any, keys: set) -> Optional[dict]:
    """The first dict of `tree` (depth first) holding all of `keys`."""
    if isinstance(tree, Mapping):
        if keys <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, keys)
        if found is not None:
            return found
    return None


def _states(tree: Any):
    """The optax state names a tree holds, for the error message."""
    if isinstance(tree, Mapping):
        yield "{" + ", ".join(sorted(map(str, tree))) + "}"
        for v in tree.values():
            yield from _states(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _states(v)


def _optimizer_state(opt_state: Any, state: TrainState, convert,
                     optimizer_name: str) -> dict:
    """The port optimizer's state_dict holding `opt_state`'s Adam
    moments (and MultiSteps' accumulator where it wraps Adam)."""
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    multi = _find(opt_state, _MULTI)
    adam = _find(multi["inner_opt_state"] if multi else opt_state, _ADAM)
    if adam is None:
        raise ValueError(
            f"cannot map the optimizer state of {optimizer_name!r} "
            f"(config optim.optimizer): no Adam count / mu / nu in "
            f"{sorted(set(_states(opt_state)))[:8]}; the port converts "
            "Adam, also under optax.MultiSteps")
    mu, nu = convert(adam["mu"]), convert(adam["nu"])
    count = float(np.asarray(adam["count"]))
    if isinstance(state.optimizer, MultiSteps):
        inner_sd = state.optimizer.inner.state_dict()
    else:
        inner_sd = state.optimizer.state_dict()
    inner_sd["state"] = {
        i: {"step": torch.tensor(count), "exp_avg": mu[n],
            "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    if not isinstance(state.optimizer, MultiSteps):
        if multi is not None:
            raise ValueError("the checkpoint's optimizer is optax.MultiSteps;"
                             " pass --grad_accum with its every_k")
        return inner_sd
    if multi is None:
        raise ValueError("--grad_accum given, but the checkpoint's optimizer "
                         "is not optax.MultiSteps")
    acc = convert(multi["acc_grads"])
    return {"inner": inner_sd, "acc": [acc[n] for n in names],
            "mini_step": int(np.asarray(multi["mini_step"])),
            "gradient_step": int(np.asarray(multi["gradient_step"]))}


def _build(args):
    """(config, a factory of the port's model)."""
    if args.continuous:
        from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous \
            import get_continuous_config
        config = apply_overrides(get_continuous_config(args.continuous),
                                 args.override)
        return config, lambda: create_model(config)
    config = apply_overrides(load_config(args.ds_name, args.mode),
                             args.override)
    return config, lambda: load_model(config, args.task_name)[0]


def convert_step(raw: Mapping, config, build, grad_accum: int = 1,
                 ema_decay: Optional[float] = None) -> TrainState:
    """The port's TrainState (on the CPU) holding a JAX checkpoint's raw
    {params, ema, opt_state, step} tree."""
    raw = _numpy(raw)
    reference = []

    def meta_model():         # built once, on the meta device
        if not reference:
            reference.append(build())
        return reference[0]

    convert = lambda tree: flax_to_torch_model(tree, meta_model, "model")
    model = build()
    model.load_state_dict(convert(raw["params"]), strict=True)
    tx = get_optimizer(config)
    if grad_accum > 1:
        tx = MultiSteps.wrap(tx, grad_accum)
    ema = raw.get("ema")
    decay = ema_decay if ema_decay is not None else config.model.get(
        "ema_rate", 0.999)
    state = TrainState.create(model, tx,
                              ema_decay=decay if ema is not None else None)
    if ema is not None:
        n = ema.get("num_updates")
        state.ema = EmaState(decay, convert(ema["params"]),
                             None if n is None else int(n))
    state.optimizer.load_state_dict(_optimizer_state(
        raw["opt_state"], state, convert,
        config.optim.get("optimizer", "Adam")))
    state.step = int(raw["step"])
    return state


def main(argv=None) -> Dict[int, TrainState]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--jax_ckpt_dir", required=True,
                   help="the JAX Checkpointer's directory of step dirs")
    p.add_argument("--out_dir", required=True,
                   help="the port checkpoint directory to write")
    p.add_argument("--ds_name", help="discrete-stack dataset config")
    p.add_argument("--task_name", default="Diffusion",
                   choices=["Diffusion", "Diffusion1D", "Diffusion3D"])
    p.add_argument("--mode", default="real-imag")
    p.add_argument("--continuous",
                   help="continuous-stack config path, e.g. "
                        "ve/cifar10_ncsnpp_continuous")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="the every_k of an optax.MultiSteps optimizer")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE")
    args = p.parse_args(argv)
    if bool(args.ds_name) == bool(args.continuous):
        p.error("exactly one of --ds_name / --continuous is required")
    config, build = _build(args)
    manager = ocp.CheckpointManager(os.path.abspath(args.jax_ckpt_dir))
    steps = list(manager.all_steps())
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {args.jax_ckpt_dir}")
    out = Checkpointer(args.out_dir, max_to_keep=None)
    states = {}
    for step in steps:
        state = convert_step(manager.restore(step), config, build,
                             args.grad_accum)
        metrics = manager.metrics(step) or {}
        out.save(step, state, val_loss=metrics.get("val_loss"))
        states[step] = state
        print(f"[convert] step {step} (state step {state.step}"
              + (f", val_loss {metrics['val_loss']}" if "val_loss" in metrics
                 else "") + f") -> {out.directory}")
    manager.close()
    return states


if __name__ == "__main__":
    main()

"""Tensor parallelism over a mesh's model axis: the parameters JAX's rule
(`mesh.tp_sharding`) shards, each cut along its output channels into one
slice per entry of the model axis, and the column-parallel convolutions
that compute with them.

In the JAX package `shard_tp` commits the TrainState's leaves to a
`NamedSharding` and GSPMD derives the collectives. Here a process drives
its row of the mesh (`mesh.model_row`), every entry from one thread.
`shard_state` takes every parameter the rule splits out of its module
(the name stays registered, holding None) and hangs its slices on the
module as `module.tp`, a `Split`: slice j an nn.Parameter on entry j.
The parameters the rule replicates stay whole in the module, on the
row's first entry (the lead), which runs every layer the model axis does
not split: one thread drives the row, so a copy on the other entries
would be read by no one.

A split layers.Conv or layers.ConvTranspose computes its slice of output
channels on each entry from the whole input, copied there, and the slices
are gathered on the lead before the next layer (`Split.forward`);
autograd brings each slice's gradient back to its entry and sums the
slices' contributions to the input's gradient. This is the column-
parallel form GSPMD derives from JAX's sharding, with whole activations
between layers (InstanceNorm++'s mean of per-channel means spans every
channel). Only those two layers are split; a model whose other leaves
the rule would shard raises.

The optimizer, the EMA shadow and MultiSteps' accumulators hold one
tensor per slice, so each entry holds its slice of every copy of a split
leaf, and weight decay and the frozen-parameter mask act on each slice as
on the whole. `TrainState.params`, `eval_params` and `state_dict` gather
the slices into the plain state-dict names and layout: a checkpoint of a
sharded state is the one of the plain state (`plain_opt_state`,
`split_opt_state` convert the optimizer's).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .mesh import Mesh, model_row, tp_sharding


class Split:
    """The slices of one split weight: `shards[j]` an nn.Parameter on
    `devices[j]`, cut along `axis` (the output channels)."""

    def __init__(self, axis: int, shards: List[nn.Parameter],
                 devices: Sequence[torch.device]):
        self.axis = axis
        self.shards = shards
        self.devices = list(devices)

    def whole(self, parts: Optional[Sequence[torch.Tensor]] = None
              ) -> torch.Tensor:
        """`parts` (by default the slices), detached and joined on the
        lead."""
        parts = self.shards if parts is None else parts
        return torch.cat([p.detach().to(self.devices[0]) for p in parts],
                         self.axis)

    def cut(self, whole: torch.Tensor) -> List[torch.Tensor]:
        """`whole` cut into the slices' pieces, each a copy on its entry."""
        return [c.to(d, copy=True) for c, d in
                zip(whole.chunk(len(self.shards), self.axis), self.devices)]

    def forward(self, x: torch.Tensor, conv: Callable,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The column-parallel layer: conv(x, slice j, bias rows of slice
        j) on entry j, x copied there, and the outputs (channels on axis
        1) gathered on x's device. The slices are cast to x's dtype, as
        the mixed-precision step casts the whole weight."""
        outs, start = [], 0
        for w, dev in zip(self.shards, self.devices):
            rows = w.shape[self.axis]
            b = None if bias is None else bias[start:start + rows].to(dev)
            start += rows
            outs.append(conv(x.to(dev), w.to(x.dtype), b).to(x.device))
        return torch.cat(outs, 1)


def output_axis(module: nn.Module, name: str, p: torch.Tensor) -> int:
    """The axis of `module`'s parameter `name` that holds JAX's last axis
    (utils/convert.py): a kernel became a `weight` with the output
    channels first, (I, O, *k) for a transposed convolution; every other
    leaf kept the Flax layout."""
    from ..models.layers import ConvTranspose
    from ..models.simple import FlaxConvTranspose
    if name != "weight" or p.ndim < 2:
        return -1
    return 1 if isinstance(module, (ConvTranspose, FlaxConvTranspose)) else 0


def _splittable(module: nn.Module) -> bool:
    from ..models.layers import Conv, ConvTranspose
    return isinstance(module, (Conv, ConvTranspose))


Entry = Tuple[str, Optional[Split], List[torch.Tensor]]


def entries(model: nn.Module) -> List[Entry]:
    """(state-dict name, its Split or None, its tensors: the slices or the
    one whole parameter) for every parameter of the model, in the plain
    model's `named_parameters` order."""
    out = []
    for prefix, module in model.named_modules():
        for name, p in module._parameters.items():
            full = f"{prefix}.{name}" if prefix else name
            split = getattr(module, "tp", None) if name == "weight" else None
            if p is None and split is not None:
                out.append((full, split, list(split.shards)))
            elif p is not None:
                out.append((full, None, [p]))
    return out


def tensors(model: nn.Module, trainable: bool = False
            ) -> List[torch.Tensor]:
    """Every slice and whole parameter, in order (those that require a
    gradient with `trainable`): what the optimizer steps and the data
    axis sums."""
    return [t for _, _, ts in entries(model) for t in ts
            if t.requires_grad or not trainable]


def _key(name: str, j: int, split: Optional[Split]) -> str:
    return name if split is None else f"{name}[{j}]"


def slice_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The live tensors by slice key: the state-dict name of a whole
    parameter, `name[j]` for slice j of a split one (the EMA's keys)."""
    return {_key(name, j, split): t for name, split, ts in entries(model)
            for j, t in enumerate(ts)}


def gather(model: nn.Module, by_key: Optional[Dict[str, torch.Tensor]]
           = None) -> Dict[str, torch.Tensor]:
    """By plain state-dict name: `by_key` (slice keys; by default the live
    tensors, whole parameters as they are) with every split parameter's
    slices joined on the lead."""
    out = {}
    for name, split, ts in entries(model):
        if by_key is None:
            out[name] = ts[0] if split is None else split.whole()
        elif split is None:
            out[name] = by_key[name]
        else:
            out[name] = split.whole([by_key[_key(name, j, split)]
                                     for j in range(len(ts))])
    return out


def cut(model: nn.Module, plain: Dict[str, torch.Tensor]
        ) -> Dict[str, torch.Tensor]:
    """The inverse of `gather`: a dict by plain name (a checkpoint's params
    or EMA) by slice key, each slice on its entry. Raises on a missing or
    an unexpected name, as a strict load_state_dict does."""
    names = [name for name, _, _ in entries(model)]
    missing = sorted(set(names) - set(plain))
    extra = sorted(set(plain) - set(names))
    if missing or extra:
        raise KeyError(f"tensor-parallel load: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for name, split, ts in entries(model):
        if split is None:
            out[name] = plain[name]
        else:
            for j, piece in enumerate(split.cut(plain[name])):
                out[_key(name, j, split)] = piece
    return out


@torch.no_grad()
def load_params(model: nn.Module, plain: Dict[str, torch.Tensor]) -> None:
    """Copy a dict by plain name into the model's slices and parameters."""
    live = slice_dict(model)
    for key, value in cut(model, plain).items():
        live[key].copy_(value)


# -- the optimizer's state ---------------------------------------------------

def _groups(model: nn.Module) -> List[Tuple[Optional[Split], List[int],
                                            torch.Size]]:
    """For each trainable parameter in order: its Split, the indices of
    its tensors among `tensors(model, trainable=True)`, its whole
    shape."""
    out, k = [], 0
    for _, split, ts in entries(model):
        if not ts[0].requires_grad:
            continue
        shape = list(ts[0].shape)
        if split is not None:
            shape[split.axis] = sum(t.shape[split.axis] for t in ts)
        out.append((split, list(range(k, k + len(ts))), torch.Size(shape)))
        k += len(ts)
    return out


def _join(split: Optional[Split], values: list):
    """A state entry of each slice (a moment: slice-shaped; a step count:
    a scalar) as the whole parameter's."""
    first = values[0]
    if split is None or not torch.is_tensor(first) or \
            first.shape != split.shards[0].shape:
        return first
    return split.whole(values)


def _part(split: Optional[Split], value, shape: torch.Size, j: int):
    """Slice j's share of a whole parameter's state entry."""
    if split is None or not torch.is_tensor(value):
        return value
    if value.shape != shape:
        return value.clone()
    return split.cut(value)[j]


def _one_group(sd: dict) -> list:
    if len(sd["param_groups"]) != 1:
        raise NotImplementedError("a tensor-parallel optimizer state holds "
                                  "one parameter group")
    return sd["param_groups"]


def plain_opt_state(model: nn.Module, sd: dict) -> dict:
    """The state_dict of an optimizer over `tensors(model, True)` (a
    training.state.Optimizer's, or a MultiSteps' with its accumulators) as
    the plain model's optimizer would hold it."""
    groups = _groups(model)
    if "inner" in sd:
        return {**sd, "inner": plain_opt_state(model, sd["inner"]),
                "acc": [_join(split, [sd["acc"][k] for k in ks])
                        for split, ks, _ in groups]}
    state = {}
    for i, (split, ks, _) in enumerate(groups):
        parts = [sd["state"][k] for k in ks if k in sd["state"]]
        if parts:
            state[i] = {name: _join(split, [p[name] for p in parts])
                        for name in parts[0]}
    return {"state": state, "param_groups": [
        {**g, "params": list(range(len(groups)))}
        for g in _one_group(sd)]}


def split_opt_state(model: nn.Module, sd: dict) -> dict:
    """The inverse of `plain_opt_state`: a plain optimizer's state_dict
    for the optimizer over `tensors(model, True)`."""
    groups = _groups(model)
    if "inner" in sd:
        acc = [_part(split, a, shape, j) for (split, ks, shape), a in
               zip(groups, sd["acc"]) for j in range(len(ks))]
        return {**sd, "inner": split_opt_state(model, sd["inner"]),
                "acc": acc}
    state = {}
    for i, (split, ks, shape) in enumerate(groups):
        if i in sd["state"]:
            for j, k in enumerate(ks):
                state[k] = {name: _part(split, v, shape, j)
                            for name, v in sd["state"][i].items()}
    n = sum(len(ks) for _, ks, _ in groups)
    return {"state": state, "param_groups": [
        {**g, "params": list(range(n))} for g in _one_group(sd)]}


# -- placing a TrainState ----------------------------------------------------

def split_model(model: nn.Module, mesh: Mesh, min_size: int) -> None:
    """Split in place, over this process's row of the mesh, every
    parameter `tp_sharding` shards; the model moves to the row's lead
    first."""
    row = model_row(mesh)
    model.to(row[0])
    for prefix, module in model.named_modules():
        for name, p in list(module._parameters.items()):
            if p is None:
                continue
            sh = tp_sharding(mesh, p, min_size, output_axis(module, name, p))
            if sh.axis is None:
                continue
            full = f"{prefix}.{name}" if prefix else name
            if name != "weight" or not _splittable(module):
                raise NotImplementedError(
                    f"tensor parallelism shards {full} {tuple(p.shape)}, "
                    f"of a {type(module).__name__}; only the weights of "
                    "layers.Conv and layers.ConvTranspose compute on slices")
            shards = [nn.Parameter(c.detach().to(d, copy=True),
                                   requires_grad=p.requires_grad)
                      for c, d in zip(p.chunk(len(row), sh.axis), row)]
            module._parameters[name] = None
            module.tp = Split(sh.axis, shards, row)


def shard_state(state, mesh: Mesh, min_size: int = 4096):
    """mesh.shard_tp on a TrainState: its model split (`split_model`), its
    optimizer (Optimizer or MultiSteps, `rebind`) and EMA rebuilt over the
    slices, and its plain state loaded into them. In place; returns the
    state."""
    from ..models.ema import EmaState
    if state.tp:
        raise ValueError("the state is tensor-parallel already")
    payload = state.state_dict()
    split_model(state.model, mesh, min_size)
    state.optimizer = state.optimizer.rebind(
        tensors(state.model, trainable=True))
    if state.ema is not None:
        state.ema = EmaState(state.ema.decay, {
            k: v.detach().clone() for k, v in slice_dict(state.model).items()},
            state.ema.num_updates)
    state.tp = True
    state.load_state_dict(payload)
    return state

"""The device mesh and the helpers that place a batch on it.

Port of `DATA_AXIS`, `MODEL_AXIS`, `make_mesh`, `data_sharding`,
`replicated`, `shard_batch`, `replicate` and `pad_to_multiple` from
inverseproblemwithdiffusionmodel_tpu/parallel/mesh.py. The reference
has no distributed execution (its only parallelism is
`torch.nn.DataParallel`, reference: models/utils.py:93, and ensembles as
batch rows). In the JAX package a mesh is a `jax.sharding.Mesh` and XLA
places the work; here it is a small grid of `torch.device`s with the
axis names ("data", "model"), and a sharded batch is a list of chunks of
axis 0, one on each data-axis device, that one host thread advances in
step (samplers/ald_pair.ShardedReconstructor, under the serving engines
and the scripts' --use_mesh) or that the ranks of a process group take
(training/train.py).

Tensor parallelism over the `model` axis (`tp_sharding`, `shard_tp`) is
not ported yet: it raises (ROADMAP, Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TP = ("tensor parallelism over the mesh's model axis is not ported yet "
       "(ROADMAP, Queue 1 item 4: tensor parallelism)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`devices`: an (n_data, n_model) grid of torch.device, rows along
    the data axis. A device may appear more than once (a test's mesh of
    CPU entries, as the JAX tests' 8 virtual CPU devices)."""
    devices: np.ndarray
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> List[torch.device]:
        """The devices along the data axis (the first of each row)."""
        return [row[0] for row in self.devices]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor goes on a mesh: axis 0 split over the data axis
    (`data_sharding`) or whole on every data-axis device (`replicated`)."""
    mesh: Mesh
    split: bool

    def place(self, x: torch.Tensor) -> List[torch.Tensor]:
        devices = self.mesh.data_devices
        if not self.split:
            return [x.to(d) for d in devices]
        if x.shape[0] % len(devices):
            raise ValueError(f"axis 0 of size {x.shape[0]} does not split "
                             f"over the {len(devices)} devices of the data "
                             "axis; pad it (pad_to_multiple)")
        return [c.to(d) for c, d in zip(x.chunk(len(devices)), devices)]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A ("data", "model") mesh over `devices`, by default every CUDA
    device (cuda:0 ... cuda:{n-1}); with none, it raises rather than fall
    back to the CPU (pass devices=[torch.device("cpu")] * k for a mesh of
    CPU entries). By default all devices go on the data axis."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices=[torch.device('cpu')] * k for a "
                               "mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        if len(devices) % n_model:
            raise ValueError(
                f"n_model={n_model} does not divide the {len(devices)} "
                f"available devices; pass n_data explicitly to use a "
                f"subset deliberately")
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"have {len(devices)}")
    grid = np.empty(n_data * n_model, dtype=object)
    grid[:] = devices[: n_data * n_model]
    return Mesh(grid.reshape(n_data, n_model))


def data_sharding(mesh: Mesh) -> Sharding:
    """Split axis 0 (batch / ensemble chains) over the data axis."""
    return Sharding(mesh, split=True)


def replicated(mesh: Mesh) -> Sharding:
    """Whole on every data-axis device (weights, ladders, masks)."""
    return Sharding(mesh, split=False)


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(x: Any, mesh: Mesh) -> Any:
    """A tensor, or a dict / list / tuple of them, with axis 0 split over
    the data axis: each tensor becomes the list of its chunks, one on
    each data-axis device."""
    sh = data_sharding(mesh)
    return _tree_map(lambda a: sh.place(torch.as_tensor(a)), x)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Each tensor of `tree` as a list of copies, one on each data-axis
    device."""
    sh = replicated(mesh)
    return _tree_map(lambda a: sh.place(torch.as_tensor(a)), tree)


def tp_sharding(mesh: Mesh, leaf, min_size: int = 4096):
    raise NotImplementedError(_TP)


def shard_tp(tree, mesh: Mesh, min_size: int = 4096):
    raise NotImplementedError(_TP)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad `axis` to a multiple of `multiple` with copies of its last
    entry (edge padding), so a batch splits evenly; returns (padded, n),
    n the original size. Takes a numpy array or a tensor, and returns the
    same kind."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, np.ndarray):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, rem)
        return np.pad(x, pad, mode="edge"), n
    last = x.narrow(axis, n - 1, 1)
    reps = [1] * x.ndim
    reps[axis] = rem
    return torch.cat([x, last.repeat(*reps)], dim=axis), n

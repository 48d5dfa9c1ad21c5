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

Tensor parallelism over the `model` axis: `tp_sharding` is JAX's rule
for one leaf, `shard_tp` places a TrainState by it (parallel/tp.py). A
process drives its row of the mesh (`model_row`): the model axis's
entries, from one thread; the data axis is the process group's ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


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


@dataclasses.dataclass(frozen=True)
class TPSharding:
    """Where a leaf goes on a mesh's model axis: `axis` split into one
    equal slice per model-axis entry of this process's row, or whole
    (axis None, replicated)."""
    mesh: Mesh
    axis: Optional[int]

    def place(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The leaf on each entry of the row: its slices, or copies."""
        row = model_row(self.mesh)
        if self.axis is None:
            return [x.to(d) for d in row]
        return [c.to(d) for c, d in zip(x.chunk(len(row), self.axis), row)]


def model_row(mesh: Mesh) -> List[torch.device]:
    """The devices of the mesh's model axis that this process drives: the
    row of its rank in the process group (row 0 without a group), or the
    one row of a mesh that has one (each process's mesh its own)."""
    rank = 0
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        rank = torch.distributed.get_rank()
    n_data = mesh.devices.shape[0]
    if n_data == 1:
        return list(mesh.devices[0])
    if rank >= n_data:
        raise ValueError(f"rank {rank} has no row in a mesh of {n_data} "
                         "rows: its data axis must be 1 or span the ranks")
    return list(mesh.devices[rank])


def tp_sharding(mesh: Mesh, leaf, min_size: int = 4096, axis: int = 0
                ) -> TPSharding:
    """JAX's tensor-parallel rule for one parameter or optimizer leaf: a
    leaf of ndim >= 2 with at least `min_size` elements whose output-
    channel axis divides by the model axis is split along that axis;
    everything else (biases, norm scales, scalars) is replicated. JAX's
    output axis is the last of its Flax layout; `axis` names it in the
    leaf's: 0 for a layers.Conv weight (O, I, *k) and an nn.Linear weight
    (out, in), the default; 1 for a layers.ConvTranspose weight (I, O,
    *k); -1 for a leaf in the Flax layout (parallel/tp.output_axis). The
    size test is the leaf's, which both layouts share, so the port splits
    the leaves JAX shards."""
    n_model = mesh.shape[MODEL_AXIS]
    shape = tuple(getattr(leaf, "shape", ()))
    if (n_model > 1 and len(shape) >= 2 and int(np.prod(shape)) >= min_size
            and shape[axis] % n_model == 0):
        return TPSharding(mesh, axis % len(shape))
    return TPSharding(mesh, None)


def shard_tp(tree, mesh: Mesh, min_size: int = 4096):
    """Place a TrainState tensor-parallel over the mesh's model axis, in
    place (parallel/tp.shard_state): every leaf `tp_sharding` splits, and
    its Adam moments, EMA shadow and accumulators, as one slice on each
    entry of this process's row; the rest whole on the row's first entry.
    Returns the state. Any other tree (a tensor, or a dict / list / tuple
    of them, conv and dense weights in the port's layout) comes back with
    each tensor a list, its `TPSharding.place` on the row."""
    from ..training.state import TrainState
    if isinstance(tree, TrainState):
        from .tp import shard_state
        return shard_state(tree, mesh, min_size)
    return _tree_map(lambda a: tp_sharding(mesh, a, min_size).place(
        torch.as_tensor(a)), tree)


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

"""Several processes, one device each: the process group of data-parallel
training.

Port of `initialize_distributed`, `is_primary` and `local_batch_slice`
from inverseproblemwithdiffusionmodel_tpu/parallel/distributed.py on
`torch.distributed`. Where the JAX package brings up `jax.distributed`
and one program spans every chip, here each process drives one device
and the train steps average their gradients over the group
(training/train.py). `all_reduce_sum_` is that average's collective.

    from inverseproblemwithdiffusionmodel_tpu_torch.parallel import (
        initialize_distributed, make_mesh, is_primary)
    initialize_distributed()       # no-op unless a launcher names a group
    ...
    if is_primary():               # logging, checkpoint writes
        ...

A group forms only on an explicit request: an address or a process count
from the caller, or torchrun's environment (MASTER_ADDR, WORLD_SIZE and
RANK together). Nothing else in the environment is read.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda",
                           timeout: Optional[float] = None) -> bool:
    """Join (or form) the process group. Returns True where a group is (or
    already was) active, False for a plain single process.

    coordinator_address: "host:port" of rank 0 (tcp://); without it the
    launcher's environment (MASTER_ADDR, MASTER_PORT). num_processes and
    process_id default to WORLD_SIZE and RANK. The backend is NCCL for a
    CUDA `device`, each process on cuda:LOCAL_RANK (or its rank modulo the
    visible cards), and gloo for device "cpu". timeout: seconds a
    collective may wait (torch's default otherwise)."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = all(os.environ.get(k) for k in _LAUNCHER_ENV)
    if not (coordinator_address or num_processes or env):
        return False
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kw)
    return True


def _rank_and_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the process that owns side effects (metrics streams,
    checkpoint writes, figures): rank 0, or the only process (the
    reference EMA callback's rank-zero convention, pl_callbacks.py:67,92)."""
    return _rank_and_size()[0] == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a global batch split evenly over the group;
    the global batch must divide by the number of processes."""
    rank, n = _rank_and_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return slice(rank * per, (rank + 1) * per)


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor over the group in place, in one collective per
    device over a flat copy of its tensors (one bucket a device, in the
    order the devices first appear: every rank must hold the same layout,
    as each rank's row of a tensor-parallel mesh does); with no group,
    nothing to do. The tensors share one dtype. Returns them."""
    tensors = list(tensors)
    if not tensors or not (dist.is_available() and dist.is_initialized()):
        return tensors
    buckets = {}
    for t in tensors:
        buckets.setdefault(t.device, []).append(t)
    for bucket in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        parts = flat.split([t.numel() for t in bucket])
        torch._foreach_copy_(bucket, [p.view_as(t) for p, t in
                                      zip(parts, bucket)])
    return tensors

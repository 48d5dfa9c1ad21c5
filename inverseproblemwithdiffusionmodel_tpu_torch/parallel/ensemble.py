"""Reconstruction ensembles as batch rows, and their chains split over the
devices of a mesh.

Port of `repeat_measurement`, `ensemble_keys`, `shard_chain_axis`,
`run_sharded_ensemble` and `ensemble_mean_std` from
inverseproblemwithdiffusionmodel_tpu/parallel/ensemble.py. Quality in the
reference comes from ensembles of independent ALD chains: `--num_samples`
repeats the measurement across the batch axis (reference:
scripts/acdc_SENSE_real_img.py:104) and the figures average their
magnitudes (reference: helpers/visualizations.py:117-120).

On a mesh the chains split over the data-axis devices, and a sharded run
must give what the unsharded run gives, so a chain's noise may not depend
on the shard it runs in: the samplers draw noise for the whole ensemble
from one stream and each shard takes its rows of every draw
(`scatter_noise`, and `scatter_shift` for the cine sampler's rolls). A
draw's axis 0 is chain-major (a chain's frames or pixel tubes are
consecutive rows), so a shard's rows are one block.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .mesh import DATA_AXIS, Mesh, pad_to_multiple
from ..utils.device import Noise, Shift

_M64 = (1 << 64) - 1


def repeat_measurement(measurement: torch.Tensor, num_samples: int,
                       batch_axis: int = 0) -> torch.Tensor:
    """Tile one measurement into `num_samples` ensemble rows along
    `batch_axis` (reference: acdc_SENSE_real_img.py:104
    `torch.cat([measurement] * N)`)."""
    reps = [1] * measurement.ndim
    reps[batch_axis] = num_samples
    return measurement.repeat(*reps)


def _mix64(z: int) -> int:
    """SplitMix64's finalizer: a bijection of 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def ensemble_keys(seed: int, num_samples: int) -> torch.Tensor:
    """Per-chain seeds (int64, shape (num_samples,)) for chains that each
    draw from a generator of their own: distinct, a function of (seed,
    index) alone, so a chain's seed does not depend on the ensemble's
    size or its split over a mesh. (The JAX package folds the index into
    a PRNG key; those keys are not reproduced.)"""
    base = _mix64(int(seed) & _M64)
    keys = [_mix64(base ^ i) for i in range(num_samples)]
    return torch.tensor([k - (1 << 64) if k >> 63 else k for k in keys],
                        dtype=torch.int64)


def shard_chain_axis(x: torch.Tensor, mesh: Mesh, axis: int = 0
                     ) -> Tuple[List[torch.Tensor], int]:
    """Pad the chain axis up to a multiple of the mesh's data axis with
    copies of the last chain (work sliced off after) and split it, one
    chunk on each data-axis device. Returns (chunks, original chain
    count)."""
    devices = mesh.data_devices
    padded, n = pad_to_multiple(x, mesh.shape[DATA_AXIS], axis)
    return [c.to(d) for c, d in zip(padded.chunk(len(devices), dim=axis),
                                    devices)], n


def scatter_noise(noise: Noise, devices: Sequence[torch.device]
                  ) -> List[Noise]:
    """One view of the stream `noise` for each shard: shard d's k-th draw
    of shape (r, ...) is rows [d r, (d + 1) r) of the stream's k-th draw of
    shape (n r, ...), on devices[d]. Each whole draw is made once and held
    until every shard has taken its rows, so shards should advance in step
    (a level at a time), from threads of their own or from one."""
    n = len(devices)
    held = {}
    taken = [0] * n
    lock = threading.Lock()

    def view(d: int) -> Noise:
        def draw(shape):
            r, rest = int(shape[0]), tuple(shape[1:])
            with lock:
                k = taken[d]
                taken[d] += 1
                if k not in held:
                    held[k] = [noise((r * n,) + rest), n]
                entry = held[k]
                if tuple(entry[0].shape) != (r * n,) + rest:
                    raise ValueError(
                        f"shard {d} draws {tuple(shape)}, the others drew "
                        f"{tuple(entry[0].shape)} in all")
                entry[1] -= 1
                if entry[1] == 0:
                    del held[k]
            return entry[0][d * r:(d + 1) * r].to(devices[d])
        return draw

    return [view(d) for d in range(n)]


def scatter_shift(shift: Shift, n: int) -> List[Shift]:
    """One view of the roll stream `shift` for each of n shards: every
    shard sees the same k-th roll, as the unsharded chain does (one roll
    per temporal step for all chains), from any thread."""
    drawn = []
    taken = [0] * n
    lock = threading.Lock()

    def view(d: int) -> Shift:
        def draw(win: int):
            with lock:
                k = taken[d]
                taken[d] += 1
                if k == len(drawn):
                    drawn.append(tuple(shift(win)))
                return drawn[k]
        return draw

    return [view(d) for d in range(n)]


def run_sharded_ensemble(
    sampler: Callable[[torch.Tensor, int], torch.Tensor],
    measurement: torch.Tensor,
    num_samples: int,
    key: int,
    mesh: Optional[Mesh] = None,
    measurement_batch_axis: int = 0,
    output_batch_axis: int = 0,
) -> torch.Tensor:
    """Run `num_samples` chains of `sampler(measurement_batch, key)`, the
    chain axis padded for the mesh's data axis.

    sampler: (measurement rows, seed) -> reconstructions. As in the JAX
    package, where the sampler is one program over the sharded ensemble,
    it takes the whole ensemble and splits it over the mesh itself: built
    over the mesh (samplers/ald_pair.make_stepped_pair_reconstructor's
    `mesh`), it advances every device's block of chains in step, with the
    noise and the CG's dot products of the whole ensemble. On a mesh the
    chain axis (`measurement_batch_axis`, 1 for SENSE's coil-leading
    layout) is padded to a multiple of the data axis with copies of the
    last chain (pad_to_multiple), and the padding chains are sliced off
    the output's `output_batch_axis`."""
    y = repeat_measurement(measurement, num_samples, measurement_batch_axis)
    if mesh is None:
        return sampler(y, key)
    y, n = pad_to_multiple(y, mesh.shape[DATA_AXIS], measurement_batch_axis)
    return sampler(y, key).narrow(output_batch_axis, 0, n)


def ensemble_mean_std(recons: torch.Tensor, axis: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude-domain ensemble mean and population std (ddof 0, as
    jnp.std) over `axis`."""
    mag = torch.abs(recons) if recons.is_complex() else recons
    return mag.mean(dim=axis), mag.std(dim=axis, correction=0)

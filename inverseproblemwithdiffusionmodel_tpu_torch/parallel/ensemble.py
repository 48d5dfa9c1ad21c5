"""Reconstruction ensembles as batch rows.

Port of `repeat_measurement` and `ensemble_mean_std` from
inverseproblemwithdiffusionmodel_tpu/parallel/ensemble.py. Quality in the
reference comes from ensembles of independent ALD chains: `--num_samples`
repeats the measurement across the batch axis (reference:
scripts/acdc_SENSE_real_img.py:104) and the figures average their
magnitudes (reference: helpers/visualizations.py:117-120).
"""
from __future__ import annotations

from typing import Tuple

import torch


def repeat_measurement(measurement: torch.Tensor, num_samples: int,
                       batch_axis: int = 0) -> torch.Tensor:
    """Tile one measurement into `num_samples` ensemble rows along
    `batch_axis` (reference: acdc_SENSE_real_img.py:104
    `torch.cat([measurement] * N)`)."""
    reps = [1] * measurement.ndim
    reps[batch_axis] = num_samples
    return measurement.repeat(*reps)


def ensemble_mean_std(recons: torch.Tensor, axis: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude-domain ensemble mean and population std (ddof 0, as
    jnp.std) over `axis`."""
    mag = torch.abs(recons) if recons.is_complex() else recons
    return mag.mean(dim=axis), mag.std(dim=axis, correction=0)

"""The continuous-time DSM train step.

Port of `make_continuous_score_train_step` from
inverseproblemwithdiffusionmodel_tpu/training/train.py:136 for float32 on
one device. PyTorch runs eagerly, so the step has no `jax.jit`
counterpart; a CUDA graph of it is later work.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn

from .state import TrainState
from ..losses.dsm import continuous_dsm_loss
from ..sde.sampling import get_score_fn
from ..utils.misc import collate_batch

TrainStep = Callable[..., Tuple[TrainState, torch.Tensor]]


def make_continuous_score_train_step(
    model: nn.Module,
    sde,
    mesh=None,
    continuous: bool = True,
    eps: float = 1e-5,
    reduce_mean: bool = True,
    data_mode: str = "real-valued",
    compute_dtype=None,
) -> TrainStep:
    """Continuous-time DSM train step against the SDE's marginal
    (reference: helpers/pl_helpers.py:31-96 and helpers/losses.py:7-24).

    Returns `step(state, batch, generator=None, t=None, z=None) -> (state,
    loss)`. `state` is a TrainState of this `model`; `batch` is an array or
    tensor (B, H, W, C), moved to the model's device. The loss draws t and
    z from `generator` (a torch.Generator on that device) unless they are
    given. The network runs in train() mode, as the reference trains;
    dropout draws from torch's global generator.
    """
    if mesh is not None:
        raise NotImplementedError("a device mesh (data-parallel training) is "
                                  "not ported yet (ROADMAP: Slice E)")
    if compute_dtype is not None:
        raise NotImplementedError("mixed-precision training (compute_dtype) "
                                  "is not ported yet (ROADMAP: Slice E)")
    score_fn = get_score_fn(sde, model, continuous=continuous)

    def step(state: TrainState, batch, generator: Optional[
            torch.Generator] = None, t: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("the state holds another model than this step "
                             "trains")
        device = next(model.parameters()).device
        x = collate_batch(torch.as_tensor(batch, device=device), data_mode)
        model.train()
        state.optimizer.zero_grad()
        loss = continuous_dsm_loss(score_fn, sde, x, eps=eps,
                                   reduce_mean=reduce_mean,
                                   generator=generator, t=t, z=z)
        loss.backward()
        return state.apply_gradients(), loss.detach()

    return step

"""The DSM train steps (discrete and continuous), the guidance nets'
train steps (classifier and segmentation) and the discrete eval step.

Port of `make_score_train_step` (:60), `make_continuous_score_train_step`
(:136), `make_clf_train_step` (:185), `make_seg_train_step` (:216),
`make_score_eval_step` (:256) and `_mixed_precision_apply` (:43) from
inverseproblemwithdiffusionmodel_tpu/training/train.py. PyTorch runs
eagerly, so a step has no `jax.jit` counterpart; a CUDA graph of it is
later work.

With a `mesh`, the JAX step is one program over the global batch, sharded
over the mesh's data axis. Here the step is data-parallel over the ranks
of the default torch.distributed process group (parallel/distributed.py;
a world of 1 without one), each rank one process on one device
(`DataParallel`): every rank is handed the same global batch and the
same generator state, makes the step's draws for the global batch, and
runs the net on its rows (`local_batch_slice`); its loss is its share of
the global loss, whose normaliser (the batch, or the foreground weight's
sum under `filter_th`) is summed over the ranks; the gradients are summed
over the ranks before the optimizer step, so every rank takes the step
the one-process step takes.

With `tp=True` (`make_score_train_step`) the state is tensor-parallel
over the mesh's model axis (parallel.shard_tp, parallel/tp.py): each
split convolution computes its slice of output channels on its entry of
this process's mesh row and the slices are gathered before the next
layer, all from this thread. The data axis composes with it unchanged:
each rank holds the same layout, its loss is counted once (not once per
model entry), and the gradients are summed over the ranks slice by slice.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from .state import TrainState
from ..losses.dsm import (anneal_dsm_score_estimation, continuous_draws,
                          continuous_dsm_loss, dsm_draws)
from ..losses.guidance import (_perturb, clf_loss_with_perturbation,
                               dice_ce_terms, dice_term, perturb_draws,
                               seg_draws, seg_loss_with_perturbation)
from ..models.registry import takes_nchw, to_nchw
from ..parallel.distributed import all_reduce_sum_, local_batch_slice
from ..parallel.mesh import DATA_AXIS
from ..parallel.tp import tensors as model_tensors
from ..sde.sampling import get_score_fn
from ..utils.misc import collate_batch, filter_batch, stack_parts

TrainStep = Callable[..., Tuple[TrainState, torch.Tensor]]


class DataParallel:
    """The data axis of a train step: the ranks of the default process
    group, or a world of 1 without one. At construction every rank takes
    rank 0's parameters (as DistributedDataParallel does). The parameters
    are the model's tensors (parallel/tp.tensors: a split weight's slices
    where parallel.shard_tp split it), read at each step."""

    def __init__(self, mesh, model: nn.Module):
        if DATA_AXIS not in getattr(mesh, "axis_names", ()):
            raise ValueError(f"a train step's mesh needs a {DATA_AXIS!r} "
                             f"axis, got {mesh!r}")
        self.model = model
        self.group = dist.is_available() and dist.is_initialized()
        if self.group:
            with torch.no_grad():
                for p in model_tensors(model):
                    dist.broadcast(p.data, src=0)

    def rows(self, batch: int, rows: int) -> slice:
        """This rank's rows of a tensor of `rows` rows that is a global
        batch of `batch` samples, each sample rows // batch consecutive
        rows (the interleaved [Re, Im] rows of `stack_parts`)."""
        mine = local_batch_slice(batch)
        k = rows // batch
        return slice(mine.start * k, mine.stop * k)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, its gradient reaching this rank's t."""
        other = all_reduce_sum_([t.detach().clone()])[0] - t.detach()
        return t + other

    def share(self, loss: torch.Tensor, local) -> torch.Tensor:
        """This rank's share of a loss normalised over the global batch:
        `loss`, normalised over this rank's `local` (a row count or a
        weight sum), times local / (local summed over the ranks)."""
        local = torch.as_tensor(local, dtype=torch.float32,
                                device=loss.device)
        total = all_reduce_sum_([local.clone()])[0]
        return loss * (local / torch.clamp_min(total, 1e-12))

    def counted_once(self, value: torch.Tensor) -> torch.Tensor:
        """A term every rank computes whole: its value divided over the
        ranks, its gradient whole."""
        n = dist.get_world_size() if self.group else 1
        return value - (1.0 - 1.0 / n) * value.detach()

    def finish(self, loss: torch.Tensor) -> torch.Tensor:
        """Sum the gradients and the loss over the ranks; returns the
        global loss."""
        grads = [p.grad for p in model_tensors(self.model, trainable=True)
                 if p.grad is not None]
        all_reduce_sum_(grads)
        return all_reduce_sum_([loss.detach().clone()])[0]


def _data_parallel(mesh, model: nn.Module) -> Optional[DataParallel]:
    return None if mesh is None else DataParallel(mesh, model)


def _mixed_precision_apply(model: nn.Module, compute_dtype=None,
                           nchw: bool = True
                           ) -> Callable[..., torch.Tensor]:
    """`net(x, cond)` on channel-last x, output channel-last float32 (the
    guidance nets take no cond: `net(x)`, the classifier's (B, K) logits
    come back as they are): for
    an NCHW net of the NCSNv2 family (`nchw`) x goes in as to_nchw(x) and
    the output comes back channel-last; NCSN++ and DDPM (nchw=False) take
    channel-last x as it is. With `compute_dtype` (bf16) it is the JAX
    package's mixed-precision cast, not autocast: the parameters, x and a
    floating cond (sigma, or t * 999 for VP) are cast to compute_dtype, an
    integer cond stays as it is, the net runs on the casts through
    torch.func.functional_call, and the output is cast back, so the
    gradients reach the float32 master parameters through the casts.
    (Autocast would keep norms and reductions in float32: another function
    than the JAX package's.) The net then runs in bf16 throughout; in the
    JAX package Flax promotes a bf16 activation to float32 wherever it
    meets a float32 operand (a numpy scalar such as NCSN++'s
    np.sqrt(2.0) skip rescale, a float32 time embedding), so its bf16
    NCSN++ runs in float32 after the first residual block (PERF.md)."""

    def apply(x: torch.Tensor, cond: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        h = to_nchw(x) if nchw else x
        if compute_dtype is None:
            out = model(h) if cond is None else model(h, cond)
        else:
            params = {k: p.to(compute_dtype)
                      for k, p in model.named_parameters()}
            args = (h.to(compute_dtype),)
            if cond is not None:
                args += (cond.to(compute_dtype) if cond.is_floating_point()
                         else cond,)
            out = functional_call(model, params, args)
        return (out.movedim(1, -1) if nchw else out).float()

    return apply


def _discrete_loss(score_fn, batch, sigmas, data_mode, anneal_power,
                   filter_th, if_centering, generator, phi, labels,
                   noise, dp: Optional[DataParallel] = None
                   ) -> torch.Tensor:
    """The loss of JAX's discrete step (train.py:97-127): centering to
    [-1, 1], the foreground weight, collation, one forward over the
    interleaved [Re, Im] rows (`stack_parts`, the weight interleaved
    alike), the annealed DSM loss. Draws, in order: phi (or the phase
    patch of 'real-imag-random'), labels, noise. With `dp`, this rank's
    share of it on its rows of the global draws."""
    if if_centering:
        batch = 2.0 * batch - 1.0
    weight = None if filter_th is None else filter_batch(batch, filter_th)
    parts = collate_batch(batch, data_mode, generator, phi=phi)
    if isinstance(parts, list):
        x = stack_parts(*parts)
        if weight is not None:
            weight = stack_parts(weight, weight)
    else:
        x = parts
    if dp is not None:
        labels, noise = dsm_draws(x, sigmas.shape[0], generator, labels,
                                  noise)
        rows = dp.rows(batch.shape[0], x.shape[0])
        x, labels, noise = x[rows], labels[rows], noise[rows]
        weight = None if weight is None else weight[rows]
    loss = anneal_dsm_score_estimation(
        score_fn, x, sigmas, generator, labels=labels,
        anneal_power=anneal_power, sample_weight=weight, noise=noise)
    if dp is None:
        return loss
    return dp.share(loss, x.shape[0] if weight is None else weight.sum())


def _device_of(model: nn.Module, state: TrainState,
               tp_step: Optional[bool] = False) -> torch.device:
    """The device of the model's first tensor (the lead entry of a
    tensor-parallel model), after checking that `state` holds `model`,
    tensor-parallel where the step is (either, with tp_step None)."""
    if state.model is not model:
        raise ValueError("the state holds another model than this step "
                         "trains")
    if tp_step is not None and state.tp != tp_step:
        raise ValueError(
            "a tp=True step takes a state placed by parallel.shard_tp"
            if tp_step else "a tensor-parallel state (parallel.shard_tp) "
            "needs make_score_train_step(..., mesh=mesh, tp=True)")
    return model_tensors(model)[0].device


def make_score_train_step(
    model: nn.Module,
    sigmas,
    data_mode: str = "real-valued",
    anneal_power: float = 2.0,
    mesh=None,
    filter_th: Optional[float] = None,
    remat: bool = False,
    tp: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    if_centering: bool = False,
) -> TrainStep:
    """Discrete annealed DSM train step of an NCSNv2-family net (reference:
    helpers/pl_helpers.py:99-143).

    Returns `step(state, batch, generator=None, *, phi=None, labels=None,
    noise=None) -> (state, loss)`. `batch` (B, H, W, C) or (B, T, C), an
    array or tensor, moves to the model's device; the draws
    (`collate_batch`'s phase, then the loss's labels and noise) come from
    `generator` on that device unless given.
    filter_th: the TV foreground weight of 1-D tubes (`filter_batch`).
    remat: recompute the net's forward in the backward
    (torch.utils.checkpoint around the whole net call, as jax.checkpoint
    wraps it).
    compute_dtype=torch.bfloat16: the net in bf16 on casts of the float32
    master parameters (`_mixed_precision_apply`); the loss, gradients,
    Adam state and EMA stay float32.
    mesh: data-parallel over the process group's ranks (the module's
    docstring); the batch divides by the ranks, and the returned loss is
    the global one.
    tp: the state is tensor-parallel over the mesh's model axis: place it
    with parallel.shard_tp(state, mesh) first. Every other option
    composes with it; the clipping norm spans every slice.
    """
    if tp and mesh is None:
        raise ValueError("tp=True needs the mesh whose model axis "
                         "parallel.shard_tp split the state over")
    dp = _data_parallel(mesh, model)
    device = model_tensors(model)[0].device
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=device)
    net = _mixed_precision_apply(model, compute_dtype)

    def raw_score(x, labels):
        return net(x, sigmas[labels])

    def score_fn(x, labels):
        if remat:
            return checkpoint(raw_score, x, labels, use_reentrant=False)
        return raw_score(x, labels)

    def step(state: TrainState, batch, generator: Optional[
            torch.Generator] = None, *, phi=None, labels=None, noise=None):
        batch = torch.as_tensor(batch, device=_device_of(model, state, tp))
        model.train()
        state.optimizer.zero_grad()
        loss = _discrete_loss(score_fn, batch, sigmas, data_mode,
                              anneal_power, filter_th, if_centering,
                              generator, phi, labels, noise, dp)
        loss.backward()
        loss = loss.detach() if dp is None else dp.finish(loss)
        return state.apply_gradients(), loss

    return step


def make_score_eval_step(model: nn.Module, sigmas,
                         data_mode: str = "real-valued",
                         anneal_power: float = 2.0, use_ema: bool = True,
                         if_centering: bool = False) -> Callable:
    """The validation DSM loss on the EMA parameters (the reference swaps
    them in around validation, helpers/pl_callbacks.py:87-108), float32,
    no foreground weight. Returns `step(state, batch, generator=None, *,
    phi=None, labels=None, noise=None) -> loss`, with the draws of the
    train step. A tensor-parallel state (parallel.shard_tp) hands it its
    parameters gathered, and the net runs them unsplit."""
    device = model_tensors(model)[0].device
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=device)

    @torch.no_grad()
    def step(state: TrainState, batch, generator: Optional[
            torch.Generator] = None, *, phi=None, labels=None, noise=None):
        batch = torch.as_tensor(batch, device=_device_of(model, state,
                                                         None))
        params = state.eval_params if use_ema else state.params

        def score_fn(x, labels):
            out = functional_call(model, params, (to_nchw(x),
                                                  sigmas[labels]))
            return out.movedim(1, -1)

        return _discrete_loss(score_fn, batch, sigmas, data_mode,
                              anneal_power, None, if_centering, generator,
                              phi, labels, noise)

    return step


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
    (reference: helpers/pl_helpers.py:31-96 and helpers/losses.py:7-24):
    NCSN++, DDPM and ScoreNet take channel-last x, the NCSN families NCHW
    (`takes_nchw`); with continuous=False on a VE SDE an NCSN v1 net takes
    the integer ladder labels, as in the JAX step.

    Returns `step(state, batch, generator=None, t=None, z=None, *,
    phi=None, patch=None) -> (state, loss)`. `state` is a TrainState of this `model`;
    `batch` is an array or tensor (B, H, W, C), moved to the model's
    device. The complex data modes collate the batch first (`collate_batch`)
    and the net sees the interleaved [Re, Im] rows (`stack_parts`), as in
    the JAX step. The draws, in order: the collation's (phi of
    'real-imag', the phase patch of 'real-imag-random'), then t and z; each comes from
    `generator` (a torch.Generator on that device) unless given.
    compute_dtype=torch.bfloat16: the net in bf16 on casts of the float32
    master parameters (`_mixed_precision_apply`); the loss, gradients, Adam
    state and EMA stay float32.
    The network runs in train() mode, as the reference trains; dropout
    draws from torch's global generator. mesh: data-parallel, as
    `make_score_train_step`'s.
    """
    dp = _data_parallel(mesh, model)
    score_fn = get_score_fn(sde, _mixed_precision_apply(
        model, compute_dtype, nchw=takes_nchw(model)),
        continuous=continuous)

    def step(state: TrainState, batch, generator: Optional[
            torch.Generator] = None, t: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None, *,
             phi: Optional[torch.Tensor] = None,
             patch: Optional[torch.Tensor] = None):
        batch = torch.as_tensor(batch, device=_device_of(model, state))
        parts = collate_batch(batch, data_mode, generator, phi=phi,
                              patch=patch)
        x = stack_parts(*parts) if isinstance(parts, list) else parts
        if dp is not None:
            t, z = continuous_draws(x, sde.T, eps, generator, t, z)
            rows = dp.rows(batch.shape[0], x.shape[0])
            x, t, z = x[rows], t[rows], z[rows]
        model.train()
        state.optimizer.zero_grad()
        loss = continuous_dsm_loss(score_fn, sde, x, eps=eps,
                                   reduce_mean=reduce_mean,
                                   generator=generator, t=t, z=z)
        if dp is not None:
            loss = dp.share(loss, x.shape[0])
        loss.backward()
        loss = loss.detach() if dp is None else dp.finish(loss)
        return state.apply_gradients(), loss

    return step


def _guidance_step(model: nn.Module, loss_fn,
                   dp: Optional[DataParallel]) -> TrainStep:
    """The train step of a guidance net around `loss_fn(X, y, generator,
    draws) -> loss`: the batch (X, y), arrays or tensors, moves to the
    model's device; one backward and the optimizer update. `draws` are the
    step's keyword arguments, the injected draws. With `dp` the loss is
    this rank's share, and the gradients and loss are summed over the
    ranks."""

    def step(state: TrainState, batch, generator: Optional[
            torch.Generator] = None, **draws):
        device = _device_of(model, state)
        X, y = (torch.as_tensor(v, device=device) for v in batch)
        model.train()
        state.optimizer.zero_grad()
        loss = loss_fn(X, y, generator, draws)
        loss.backward()
        loss = loss.detach() if dp is None else dp.finish(loss)
        return state.apply_gradients(), loss

    return step


def make_clf_train_step(model: nn.Module, sigmas, mesh=None,
                        compute_dtype: Optional[torch.dtype] = None,
                        data_mode: str = "real-valued") -> TrainStep:
    """Noise-robust classifier step (reference: helpers/pl_helpers.py:
    190-246, ncsn/losses/clf_loss.py): cross-entropy of the classifier on
    X perturbed at a random sigma of the ladder per sample.

    Returns `step(state, batch, generator=None, *, labels=None,
    noise=None) -> (state, loss)`; batch = (X, y), X (B, H, W, C) images
    and y (B,) classes. X is collated for `data_mode` first, as TrainClf
    does (pl_helpers.py:212): single-tensor modes only (a Re/Im pair has
    no single class target; JAX asserts it, here it raises ValueError).
    The draws, in order: the noise labels, then the noise; each comes from
    `generator` on the model's device unless given. compute_dtype: the net
    on casts of the float32 master parameters (`_mixed_precision_apply`).
    mesh: data-parallel, as `make_score_train_step`'s.
    """
    dp = _data_parallel(mesh, model)
    device = next(model.parameters()).device
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=device)
    net = _mixed_precision_apply(model, compute_dtype)

    def loss_fn(X, y, generator, draws):
        X = collate_batch(X, data_mode, generator)
        if isinstance(X, list):
            raise ValueError(f"clf training needs a single-tensor data_mode, "
                             f"not {data_mode!r}")
        if dp is None:
            loss, _ = clf_loss_with_perturbation(net, X, y, sigmas,
                                                 generator, **draws)
            return loss
        labels, noise = perturb_draws(X, sigmas.shape[0], generator,
                                      **draws)
        rows = dp.rows(X.shape[0], X.shape[0])
        loss, _ = clf_loss_with_perturbation(
            net, X[rows], y[rows], sigmas, labels=labels[rows],
            noise=noise[rows])
        return dp.share(loss, rows.stop - rows.start)

    return _guidance_step(model, loss_fn, dp)


def make_seg_train_step(model: nn.Module, sigmas, perturb: bool = False,
                        mesh=None,
                        compute_dtype: Optional[torch.dtype] = None,
                        if_centering: bool = False,
                        data_mode: str = "real-valued") -> TrainStep:
    """Segmentation (DiceCE) step (reference: helpers/pl_helpers.py:
    264-352, ncsn/losses/seg_loss.py).

    Returns `step(state, batch, generator=None, *, phi=None, patch=None,
    labels=None, noise=None) -> (state, loss)`; batch = (X, y), X (B, H,
    W, C) images and y (B, H, W) int masks. if_centering maps X to 2 X - 1
    (train_seg.py:26), then X is collated for `data_mode`; the Re/Im modes
    average the two parts' losses under the shared mask (pl_helpers.py:
    290-296). The draws, in order: the collation's (phi or the phase patch),
    then with `perturb` the shared noise label and the noise, per part in
    the Re/Im modes (`labels` and `noise` then take a (Re, Im) pair). Each
    comes from `generator` on the model's device unless given. mesh:
    data-parallel, as `make_score_train_step`'s; the Dice term's sums span
    the ranks."""
    dp = _data_parallel(mesh, model)
    device = next(model.parameters()).device
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32, device=device)
    net = _mixed_precision_apply(model, compute_dtype)

    def part_loss(X, y, generator, draws):
        if dp is None:
            return seg_loss_with_perturbation(net, X, y, sigmas, generator,
                                              perturb=perturb, **draws)[0]
        rows = dp.rows(X.shape[0], X.shape[0])
        if perturb:
            # the global batch's draws, this rank's rows of them
            labels, noise = seg_draws(X, sigmas.shape[0], generator, **draws)
            X = _perturb(X[rows], sigmas, labels[rows], noise[rows])
        else:
            X = X[rows]
        # dice_ce_loss over the global batch: the cross-entropy's share of
        # the global mean, the Dice term on the per-class sums of every
        # rank, counted once over the ranks
        ce, intersection, denom = dice_ce_terms(net(X), y[rows])
        dice = dice_term(dp.total(intersection), dp.total(denom))
        return (0.5 * dp.share(ce, y[rows].numel())
                + 0.5 * dp.counted_once(dice))

    def loss_fn(X, y, generator, draws):
        if if_centering:
            X = 2.0 * X - 1.0
        parts = collate_batch(X, data_mode, generator,
                              phi=draws.pop("phi", None),
                              patch=draws.pop("patch", None))
        if not isinstance(parts, list):
            return part_loss(parts, y, generator, draws)
        losses = []
        for i, part in enumerate(parts):
            mine = {k: v[i] for k, v in draws.items() if v is not None}
            losses.append(part_loss(part, y, generator, mine))
        return 0.5 * (losses[0] + losses[1])

    return _guidance_step(model, loss_fn, dp)

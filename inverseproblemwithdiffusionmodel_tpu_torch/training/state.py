"""Train state: the model, its optimizer, the EMA shadow and the step count.

Port of `TrainState` (:24) and `get_optimizer` (:71) from
inverseproblemwithdiffusionmodel_tpu/training/state.py, and of the
gradient accumulation the JAX `train_ncsn --grad_accum` wraps around the
optimizer (`optax.MultiSteps`, scripts/train_ncsn.py:127-129). The JAX
state is an immutable pytree that each step replaces; here the state holds
the model and updates it in place, and `apply_gradients` returns the same
object.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from ..models.ema import EmaState
from ..parallel import tp


class Optimizer:
    """optax's chain on torch tensors: clip by global norm (optax's
    formula), then L2 weight decay, then Adam / RMSProp / SGD.

    It updates the parameters that require a gradient. Frozen ones, the
    GaussianFourierProjection's W, are left out, so weight decay never
    shrinks them: the mask of the JAX package (state.py:58). The decay is
    the torch optimizers' `weight_decay`, which adds wd * p to the gradient
    before the moments, as optax's `add_decayed_weights` ahead of the
    optimizer does.
    """

    def __init__(self, params: List[torch.Tensor], make_opt: Callable,
                 grad_clip: float = 0.0):
        self.params = params
        self.grad_clip = grad_clip
        self.make_opt = make_opt
        self.opt = make_opt(params)

    def rebind(self, params: List[torch.Tensor]) -> "Optimizer":
        """A fresh optimizer of the same kind over `params`."""
        return Optimizer(params, self.make_opt, self.grad_clip)

    @torch.no_grad()
    def clip_(self) -> None:
        """Scale the gradients in place by optax's clip_by_global_norm:
        g * max_norm / norm where norm >= max_norm, else g (no epsilon in
        the norm, unlike torch.nn.utils.clip_grad_norm_). The norm is the
        whole gradient's, over every device the parameters lie on (the
        slices of a tensor-parallel state): the per-tensor norms are
        gathered on the first gradient's device. Runs on the devices,
        without reading the norm back to the host."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return
        lead = grads[0].device
        norm = torch.linalg.vector_norm(torch.stack(
            [n.to(lead) for n in torch._foreach_norm(grads)]))
        keep = norm < self.grad_clip
        div = torch.where(keep, 1.0, norm)
        mul = torch.where(keep, 1.0, self.grad_clip)
        by_device = {}
        for g in grads:
            by_device.setdefault(g.device, []).append(g)
        for device, gs in by_device.items():
            torch._foreach_div_(gs, div.to(device))
            torch._foreach_mul_(gs, mul.to(device))

    def step(self) -> None:
        if self.grad_clip > 0:
            self.clip_()
        self.opt.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state)


def get_optimizer(config) -> Callable[[List[torch.Tensor]], Optimizer]:
    """Adam / RMSProp / SGD from config.optim (reference:
    ncsn/losses/__init__.py:3-13, helpers/utils.py:194-209). Returns a
    factory that binds the optimizer to a list of parameters, as an optax
    transformation is bound by `init`. `optim.warmup` is not read, as in
    the JAX package: the learning rate is constant."""
    opt = config.optim
    name = opt.get("optimizer", "Adam")
    lr = opt.lr
    wd = opt.get("weight_decay", 0.0) or 0.0
    if name == "Adam":
        def make(params):
            return torch.optim.Adam(params, lr=lr, betas=(
                opt.get("beta1", 0.9), 0.999), eps=opt.get("eps", 1e-8),
                weight_decay=wd)
    elif name == "RMSProp":
        # torch's RMSprop: alpha 0.99, eps outside the sqrt, as optax's
        # rmsprop(decay=0.99, eps_in_sqrt=False) in the JAX package.
        def make(params):
            return torch.optim.RMSprop(params, lr=lr, alpha=0.99,
                                       eps=opt.get("eps", 1e-8),
                                       weight_decay=wd)
    elif name == "SGD":
        def make(params):
            return torch.optim.SGD(params, lr=lr, momentum=0.9,
                                   weight_decay=wd)
    else:
        raise NotImplementedError(f"optimizer {name} not supported")
    # reference configs disable clipping with grad_clip = -1 or 0
    grad_clip = max(opt.get("grad_clip", 0.0), 0.0)
    return lambda params: Optimizer(params, make, grad_clip)


class MultiSteps:
    """optax.MultiSteps(tx, every_k_schedule=k) with optax's default mean:
    each `step` folds the parameters' gradients into a running mean (acc +=
    (g - acc) / (n + 1), optax's formula, n the micro-step), and every k-th
    hands the mean to the inner optimizer (clipping included) and steps it;
    the other micro-steps leave the parameters as they are. A parameter
    without a gradient counts as a zero gradient. `gradient_step` counts
    the inner optimizer's steps, `mini_step` the micro-steps since."""

    def __init__(self, inner: Optimizer, every_k_schedule: int):
        if every_k_schedule < 1:
            raise ValueError(f"every_k_schedule {every_k_schedule} < 1")
        self.inner = inner
        self.every_k = every_k_schedule
        self.params = inner.params
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0
        self.gradient_step = 0

    @classmethod
    def wrap(cls, tx: Callable[[List[torch.Tensor]], Optimizer],
             every_k_schedule: int):
        """The factory of `tx` (get_optimizer's) with accumulation."""
        return lambda params: cls(tx(params), every_k_schedule)

    def rebind(self, params: List[torch.Tensor]) -> "MultiSteps":
        """A fresh MultiSteps of the same kind over `params`."""
        return MultiSteps(self.inner.rebind(params), self.every_k)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, acc in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (n + 1))
        if n < self.every_k - 1:
            self.mini_step += 1
            return
        for p, acc in zip(self.params, self.acc):
            p.grad = acc.clone()
        self.inner.step()
        for acc in self.acc:
            acc.zero_()
        self.mini_step = 0
        self.gradient_step += 1

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "acc": self.acc,
                "mini_step": self.mini_step,
                "gradient_step": self.gradient_step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        for acc, saved in zip(self.acc, state["acc"]):
            acc.copy_(saved)
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])


class TrainState:
    """step, the model, its optimizer and the EMA shadow of its parameters.

    `params` are the model's parameters by state-dict name (live tensors);
    `eval_params` the EMA shadow if one is tracked, else `params`: what
    sampling should use (the reference reloads EMA weights,
    helpers/load_model.py:181-184). `state_dict` is a checkpoint's
    payload, {step, params, ema, opt_state}.

    `tp` is set by parallel.shard_tp, which splits the model's largest
    weights over a mesh's model axis (parallel/tp.py): the optimizer and
    the EMA then hold one tensor per slice, and `params`, `eval_params`
    and `state_dict` gather the slices (copies, not live tensors) into the
    plain names and layout.
    """

    def __init__(self, step: int, model: nn.Module, optimizer,
                 ema: Optional[EmaState]):
        self.step = step
        self.model = model
        self.optimizer = optimizer
        self.ema = ema
        self.tp = False

    @classmethod
    def create(cls, model: nn.Module,
               tx: Callable[[List[torch.Tensor]], Optimizer],
               ema_decay: Optional[float] = 0.999,
               ema_warmup: bool = False) -> "TrainState":
        trainable = [p for p in model.parameters() if p.requires_grad]
        params = dict(model.named_parameters())
        return cls(step=0, model=model, optimizer=tx(trainable),
                   ema=(EmaState.create(params, ema_decay, ema_warmup)
                        if ema_decay is not None else None))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        if self.tp:
            return tp.gather(self.model)
        return dict(self.model.named_parameters())

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        if self.ema is None:
            return self.params
        return tp.gather(self.model, self.ema.params) if self.tp \
            else self.ema.params

    def state_dict(self) -> dict:
        """{step, params, ema, opt_state}: the parameters detached, the EMA
        and the optimizer's state_dicts, all in the plain layout."""
        ema = self.ema.state_dict() if self.ema is not None else None
        opt = self.optimizer.state_dict()
        if self.tp:
            opt = tp.plain_opt_state(self.model, opt)
            if ema is not None:
                ema = {**ema, "params": tp.gather(self.model, ema["params"])}
        return {"step": int(self.step),
                "params": {k: v.detach() for k, v in self.params.items()},
                "ema": ema, "opt_state": opt}

    def load_state_dict(self, raw: dict) -> None:
        """Load a `state_dict` payload in place (a tensor-parallel state
        cuts it into its slices)."""
        ema, opt = raw["ema"], raw["opt_state"]
        if self.ema is not None and ema is None:
            raise ValueError("the checkpoint tracks no EMA, the state does")
        if self.tp:
            tp.load_params(self.model, raw["params"])
            opt = tp.split_opt_state(self.model, opt)
            if ema is not None:
                ema = {**ema, "params": tp.cut(self.model, ema["params"])}
        else:
            self.model.load_state_dict(raw["params"], strict=True)
        self.optimizer.load_state_dict(opt)
        if self.ema is not None:
            self.ema.load_state_dict(ema)
        self.step = int(raw["step"])

    def apply_gradients(self) -> "TrainState":
        """One optimizer step on the gradients in each parameter's .grad
        (afterwards they hold the clipped gradients it consumed), then the
        EMA update and the step count. Under MultiSteps this is one
        micro-step: the EMA updates and the step counts at every one, as in
        the JAX state (so the EMA's decay per optimizer update is
        ema_rate ** k)."""
        self.optimizer.step()
        if self.ema is not None:
            self.ema.update(tp.slice_dict(self.model) if self.tp
                            else self.params)
        self.step += 1
        return self

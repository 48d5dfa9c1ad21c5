"""Train state: the model, its optimizer, the EMA shadow and the step count.

Port of `TrainState` (:24) and `get_optimizer` (:71) from
inverseproblemwithdiffusionmodel_tpu/training/state.py. The JAX state is an
immutable pytree that each step replaces; here the state holds the model
and updates it in place, and `apply_gradients` returns the same object.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn

from ..models.ema import EmaState


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
        self.opt = make_opt(params)

    @torch.no_grad()
    def clip_(self) -> None:
        """Scale the gradients in place by optax's clip_by_global_norm:
        g * max_norm / norm where norm >= max_norm, else g (no epsilon in
        the norm, unlike torch.nn.utils.clip_grad_norm_). Runs on the
        device, without reading the norm back to the host."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not grads:
            return
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.grad_clip))

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


class TrainState:
    """step, the model, its optimizer and the EMA shadow of its parameters.

    `params` are the model's parameters by state-dict name (live tensors);
    `eval_params` the EMA shadow if one is tracked, else `params`: what
    sampling should use (the reference reloads EMA weights,
    helpers/load_model.py:181-184).
    """

    def __init__(self, step: int, model: nn.Module, optimizer: Optimizer,
                 ema: Optional[EmaState]):
        self.step = step
        self.model = model
        self.optimizer = optimizer
        self.ema = ema

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
        return dict(self.model.named_parameters())

    @property
    def eval_params(self) -> Dict[str, torch.Tensor]:
        return self.ema.params if self.ema is not None else self.params

    def apply_gradients(self) -> "TrainState":
        """One optimizer step on the gradients in each parameter's .grad
        (afterwards they hold the clipped gradients it consumed), then the
        EMA update and the step count."""
        self.optimizer.step()
        if self.ema is not None:
            self.ema.update(self.params)
        self.step += 1
        return self

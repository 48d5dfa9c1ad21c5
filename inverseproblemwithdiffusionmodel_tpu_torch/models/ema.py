"""Exponential moving average of parameters.

Port of `EmaState` from inverseproblemwithdiffusionmodel_tpu/models/ema.py:18
(reference: helpers/pl_callbacks.py:79-84, shadow <- d * shadow + (1 - d) *
w, and models/ema.py:15-95's warm-up, d <- min(d, (1 + n) / (10 + n))).

The shadow is a dict of tensors keyed like the model's `state_dict()`.
Unlike the JAX state, which returns a new pytree, `update` works in place
with `torch._foreach_*` on the shadow tensors and returns the same object.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


class EmaState:
    def __init__(self, decay: float, params: Dict[str, torch.Tensor],
                 num_updates: Optional[int] = None):
        self.decay = decay
        self.params = params
        self.num_updates = num_updates   # None disables the warm-up

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor], decay: float,
               use_warmup: bool = False) -> "EmaState":
        """A shadow that copies (does not alias) `params`."""
        return cls(decay=decay,
                   params={k: v.detach().clone() for k, v in params.items()},
                   num_updates=0 if use_warmup else None)

    @torch.no_grad()
    def update(self, new_params: Mapping[str, torch.Tensor]) -> "EmaState":
        """shadow <- decay * shadow + (1 - decay) * new, in place."""
        decay = self.decay
        if self.num_updates is not None:
            self.num_updates += 1
            n = self.num_updates
            decay = min(decay, (1.0 + n) / (10.0 + n))
        shadow = list(self.params.values())
        new = [new_params[k].detach() for k in self.params]
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, torch._foreach_mul(new, 1.0 - decay))
        return self

    def state_dict(self) -> dict:
        return {"decay": self.decay, "params": self.params,
                "num_updates": self.num_updates}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        self.decay = state["decay"]
        self.num_updates = state["num_updates"]
        for k, v in self.params.items():
            v.copy_(state["params"][k])

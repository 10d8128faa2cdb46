"""Optimizers that compute what the JAX package's optax chains compute.

`OptaxOptimizer` is `optax.chain(optax.clip_by_global_norm(max_norm),
optax.adam(lr) | optax.rmsprop(lr))`, with the learning rate a float32
hyperparameter as `optax.inject_hyperparams` keeps it.  torch's own
optimizers differ from optax on each point below, so none is used:

* one step count shared by every parameter (optax's `count`), not one per
  parameter;
* a parameter without a gradient takes a zero gradient: its moments decay
  and the count moves, where torch's optimizers skip it;
* `clip_by_global_norm`: the gradients unchanged while their global norm
  is below `max_norm`, else g * max_norm / norm, with no epsilon
  (`clip_grad_norm_` divides by norm + 1e-6 and scales at any norm);
  `max_norm=None` leaves the clip out of the chain;
* Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, eps_root 0,
  both moments bias-corrected with the float32 b**count;
* RMSprop: decay 0.9, eps 1e-8 inside the square root, nu starting at 0,
  no bias correction (torch's RMSprop: alpha 0.99, eps outside);
* the update p - lr * u, with lr stored as a float32 value.

The moments live in `state[p]` from construction on, as optax's `init`
makes them, so they can be read and written by name (`named_state`,
`load_named_state`) for the JAX package's train-state layout.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1e-8


def f32(x: float) -> float:
    """x rounded to float32, as a Python float (exactly that value)."""
    return float(np.float32(x))


class OptaxOptimizer(torch.optim.Optimizer):
    """named_params: (name, parameter) pairs; kind: 'adam' | 'rmsprop'."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 lr: float, kind: str = "adam",
                 max_norm: Optional[float] = 2.0):
        if kind not in ("adam", "rmsprop"):
            raise ValueError(f"unknown optimizer {kind!r}")
        named = list(named_params)
        self.names = [n for n, _ in named]
        super().__init__([p for _, p in named], {"lr": f32(lr)})
        self.kind = kind
        self.max_norm = max_norm
        self.count = 0
        moments = ("mu", "nu") if kind == "adam" else ("nu",)
        for p in self.params:
            self.state[p] = {m: torch.zeros_like(p, memory_format=
                                                 torch.preserve_format)
                             for m in moments}

    @property
    def params(self):
        return self.param_groups[0]["params"]

    @property
    def lr(self) -> float:
        return self.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        self.param_groups[0]["lr"] = f32(value)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxOptimizer.step takes no closure")
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.max_norm is not None:
            # clip_by_global_norm, with no host sync: a factor of exactly 1
            # below the bound
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            factor = torch.where(norm < self.max_norm, 1.0,
                                 self.max_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        self.count += 1
        if self.kind == "adam":
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mus, ADAM_B1)
            torch._foreach_add_(mus, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nus, ADAM_B2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - ADAM_B2)
            # bias corrections as optax computes them: float32 b**count
            bc1 = f32(1 - np.float32(ADAM_B1) ** self.count)
            bc2 = f32(1 - np.float32(ADAM_B2) ** self.count)
            updates = torch._foreach_div(mus, bc1)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            torch._foreach_div_(updates, denom)
        else:
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nus, RMS_DECAY)
            torch._foreach_addcmul_(nus, grads, grads,
                                    value=1.0 - RMS_DECAY)
            scale = torch._foreach_add(nus, RMS_EPS)
            torch._foreach_rsqrt_(scale)
            updates = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(updates, -self.lr)
        torch._foreach_add_(params, updates)
        return None

    def named_state(self) -> Dict[str, object]:
        """{"count", "learning_rate", and per moment {name: tensor}}."""
        out: Dict[str, object] = {"count": self.count,
                                  "learning_rate": self.lr}
        for m in self.state[self.params[0]]:
            out[m] = {n: self.state[p][m]
                      for n, p in zip(self.names, self.params)}
        return out

    def load_named_state(self, state: Dict[str, object]) -> None:
        """The inverse of `named_state`: moments are copied into place (a
        state without "learning_rate" keeps the optimizer's own)."""
        self.count = int(state["count"])
        if "learning_rate" in state:
            self.lr = float(state["learning_rate"])
        for m in self.state[self.params[0]]:
            given = state[m]
            missing = set(self.names) - set(given)
            if missing:
                raise KeyError(f"no {m} for {sorted(missing)[:5]}")
            with torch.no_grad():
                for n, p in zip(self.names, self.params):
                    self.state[p][m].copy_(given[n])

"""Optimizers that compute what the JAX package's optax chains compute.

`OptaxOptimizer` is one of four optax chains, each after an optional
`optax.clip_by_global_norm(max_norm)`:

* 'adam' | 'rmsprop': `optax.adam(lr)` | `optax.rmsprop(lr)` with the
  learning rate a float32 hyperparameter as `optax.inject_hyperparams`
  keeps it (the LINAS and Combiner trainers);
* 'sgd': `chain(add_decayed_weights(wd), sgd(lr, momentum))` and
  'adamw': `adamw(lr, weight_decay=wd)`, the two chains of
  `make_rec_optimizer` (recognition_trainer.py:47-61), with the learning
  rate a constant or `warmup_cosine_decay_schedule(0, lr, warmup_steps,
  total_steps)`.

torch's own optimizers differ from optax on each point below, so none is
used:

* one step count shared by every parameter (optax's `count`), not one per
  parameter;
* a parameter without a gradient takes a zero gradient: its moments decay
  and the count moves, where torch's optimizers skip it;
* `clip_by_global_norm`: the gradients unchanged while their global norm
  is below `max_norm`, else g * max_norm / norm, with no epsilon
  (`clip_grad_norm_` divides by norm + 1e-6 and scales at any norm);
  `max_norm=None` leaves the clip out of the chain.  The clip comes first,
  on the raw gradient;
* Adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, eps_root 0,
  both moments bias-corrected with the float32 b**count;
* RMSprop: decay 0.9, eps 1e-8 inside the square root, nu starting at 0,
  no bias correction (torch's RMSprop: alpha 0.99, eps outside);
* SGD: weight decay `g + wd * p` on every parameter (no mask: LayerNorms,
  biases and tokens too) before the momentum trace `t = g + momentum * t`
  (optax's `trace`: the first step's t is g, no dampening); AdamW adds
  `wd * p` to Adam's update, after the moments;
* the update p - lr * u, with lr a float32 value; a schedule is evaluated
  in float32 at the count before the step, so with `warmup_steps > 0` the
  first update has a learning rate of 0 (the momentum trace and Adam's
  moments still take that step's gradient);
* `step(update_scale=s)` multiplies the whole update -lr * u by the
  float32 s before it is applied, as the JAX multigrid step scales
  optax's updates (weight decay included): one more rounding, not a
  changed lr.

The moments live in `state[p]` from construction on, as optax's `init`
makes them, so they can be read and written by name (`named_state`,
`load_named_state`) for the JAX package's train-state layouts.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RMS_DECAY, RMS_EPS = 0.9, 1e-8
KINDS = ("adam", "rmsprop", "sgd", "adamw")


def f32(x: float) -> float:
    """x rounded to float32, as a Python float (exactly that value)."""
    return float(np.float32(x))


def warmup_cosine(count: int, peak: float, warmup_steps: int,
                  total_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    total_steps) at `count`, in float32 as optax evaluates it: a linear
    ramp from 0 over warmup_steps, then a cosine from peak to 0 over the
    remaining total_steps - warmup_steps."""
    f = np.float32
    peak = f(peak)
    if count < warmup_steps:
        frac = f(1) - f(min(max(count, 0), warmup_steps)) / f(warmup_steps)
        return float(-peak * frac + peak)
    decay = f(total_steps - warmup_steps)
    c = min(f(count - warmup_steps), decay)
    cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * c / decay))
    return float(peak * cosine)


class OptaxOptimizer(torch.optim.Optimizer):
    """named_params: (name, parameter) pairs; kind: one of KINDS.
    weight_decay and momentum (None: no trace) act in 'sgd' and 'adamw';
    warmup_steps > 0 puts the warmup-cosine schedule over total_steps in
    place of the constant lr of those two."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 lr: float, kind: str = "adam",
                 max_norm: Optional[float] = 2.0, *,
                 weight_decay: float = 0.0, momentum: Optional[float] = None,
                 warmup_steps: int = 0, total_steps: Optional[int] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown optimizer {kind!r}")
        if kind in ("adam", "rmsprop") and (weight_decay or warmup_steps
                                            or momentum is not None):
            raise ValueError(f"{kind!r} takes no weight decay, momentum or "
                             f"schedule")
        if warmup_steps > 0 and not (total_steps or 0) > warmup_steps:
            # optax's cosine_decay_schedule refuses decay_steps <= 0
            raise ValueError(f"a warmup of {warmup_steps} steps needs more "
                             f"total steps, got {total_steps}")
        named = list(named_params)
        self.names = [n for n, _ in named]
        super().__init__([p for _, p in named], {"lr": f32(lr)})
        self.kind = kind
        self.max_norm = max_norm
        self.weight_decay = weight_decay
        self.momentum = momentum if kind == "sgd" else None
        self.warmup_steps, self.total_steps = warmup_steps, total_steps
        self.count = 0
        moments = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"),
                   "rmsprop": ("nu",),
                   "sgd": ("trace",) if self.momentum is not None else ()}
        for p in self.params:
            self.state[p] = {m: torch.zeros_like(p, memory_format=
                                                 torch.preserve_format)
                             for m in moments[kind]}

    @property
    def params(self):
        return self.param_groups[0]["params"]

    @property
    def lr(self) -> float:
        return self.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        self.param_groups[0]["lr"] = f32(value)

    @property
    def scheduled(self) -> bool:
        return self.warmup_steps > 0

    def lr_at(self, count: int) -> float:
        """The learning rate of the update taken at `count`."""
        if self.scheduled:
            return warmup_cosine(count, self.lr, self.warmup_steps,
                                 self.total_steps)
        return self.lr

    @torch.no_grad()
    def step(self, closure=None, update_scale: Optional[float] = None):
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
        lr = self.lr_at(self.count)
        self.count += 1
        if self.kind == "sgd":
            if self.weight_decay:
                decay = torch._foreach_mul(params, self.weight_decay)
                torch._foreach_add_(decay, grads)
                grads = decay
            if self.momentum is not None:
                traces = [self.state[p]["trace"] for p in params]
                torch._foreach_mul_(traces, self.momentum)
                torch._foreach_add_(traces, grads)
                grads = traces
            updates = torch._foreach_mul(grads, -lr)
            if update_scale is not None:
                torch._foreach_mul_(updates, f32(update_scale))
            torch._foreach_add_(params, updates)
            return None
        if self.kind in ("adam", "adamw"):
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
            if self.kind == "adamw" and self.weight_decay:
                torch._foreach_add_(updates, torch._foreach_mul(
                    params, self.weight_decay))
        else:
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(nus, RMS_DECAY)
            torch._foreach_addcmul_(nus, grads, grads,
                                    value=1.0 - RMS_DECAY)
            scale = torch._foreach_add(nus, RMS_EPS)
            torch._foreach_rsqrt_(scale)
            updates = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(updates, -lr)
        if update_scale is not None:
            torch._foreach_mul_(updates, f32(update_scale))
        torch._foreach_add_(params, updates)
        return None

    def named_state(self) -> Dict[str, object]:
        """{"count", per moment {name: tensor}, and for 'adam' and
        'rmsprop' the injected "learning_rate"}."""
        out: Dict[str, object] = {"count": self.count}
        if self.kind in ("adam", "rmsprop"):
            out["learning_rate"] = self.lr
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

"""Timing helpers.

Counterpart of cross_modal_video_engine_tpu/utils/profiling.py:

* `device_time(fn, *args, steps=10)`: seconds per call of `fn(*args)`.
  On the card: CUDA events around `steps` calls after a warm-up, then one
  synchronize.  PyTorch runs eagerly, so nothing can hoist the loop's body
  and the JAX version's carried dependency has no counterpart here.  Where
  no argument lies on a card, the host clock; without arguments the caller
  names the device.
* `host_time(fn, calls=100)`: host seconds per call of `fn()` when calls are
  enqueued back to back on the card: what a launch costs the host.
* `StageTimer`: per-stage host timing that synchronizes the card before
  stamping.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch


def _cuda_device(args):
    """The CUDA device of the first tensor, or module parameter, among
    args that lies on one, else None."""
    for a in args:
        tensors = a.parameters() if isinstance(a, torch.nn.Module) else (a,)
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                return t.device
    return None


def device_time(fn: Callable, *args, steps: int = 10, warmup: int = 2,
                device=None) -> float:
    """Seconds per call of `fn(*args)`: by CUDA events on `device` (default:
    the card an argument lies on), by `time.perf_counter` on the CPU.  A
    `fn` that takes no argument names no device, so the caller must: a
    closure over card tensors timed on the host clock would be launch
    time."""
    if device is None and not args:
        raise TypeError("device_time: fn takes no arguments, so pass "
                        "device= (the card its tensors lie on, or 'cpu')")
    dev = torch.device(device) if device is not None else _cuda_device(args)
    for _ in range(warmup):
        fn(*args)
    if dev is None or dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(*args)
        return (time.perf_counter() - t0) / steps
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) * 1e-3 / steps


def host_time(fn: Callable, calls: int = 100, warmup: int = 10) -> float:
    """Host seconds per call of `fn()`: the card is waited for before the
    first call and after the clock is read, so the time is that of
    enqueueing.  Keep `calls` times the kernels a call launches below the
    launch queue's depth (about a thousand), or the card's pace is what
    is timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls


class StageTimer:
    """Accumulates host seconds per named stage; `sync_value`, a tensor on
    a card, makes the stage wait for that card before it is stamped."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if (isinstance(sync_value, torch.Tensor)
                    and sync_value.device.type == "cuda"):
                torch.cuda.synchronize(sync_value.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_s": v / self.counts[k]}
                for k, v in self.totals.items()}

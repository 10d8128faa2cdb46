"""Training observability: meters, collectors, progress bar.

Counterpart of cross_modal_video_engine_tpu/utils/logging.py (a copy).

Parity with LINAS-engine/basic/util.py:20-93 (AverageMeter, LogCollector)
and a minimal Keras-style progress bar (basic/generic_utils.py:285-439).
tb-style scalar emission is pluggable (callable sink) instead of binding
to tensorboard_logger.
"""

from __future__ import annotations

import sys
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.val:.4f} ({self.avg:.4f})"


class LogCollector:
    """Named AverageMeters + optional scalar sink (tensorboard-like)."""

    def __init__(self, sink: Optional[Callable[[str, float, int], None]] = None):
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict()
        self.sink = sink

    def update(self, k: str, v, n: int = 1):
        if k not in self.meters:
            self.meters[k] = AverageMeter()
        self.meters[k].update(v, n)

    def __str__(self):
        return "  ".join(f"{k} {m}" for k, m in self.meters.items())

    def tb_log(self, step: int, prefix: str = ""):
        if self.sink is None:
            return
        for k, m in self.meters.items():
            self.sink(prefix + k, m.val, step)


class Progbar:
    """Minimal progress bar (generic_utils.py:285-439 flavor)."""

    def __init__(self, target: int, width: int = 30, stream=None):
        self.target = target
        self.width = width
        self.stream = stream
        self.seen = 0
        self.start = time.time()

    def add(self, n: int, values: Optional[Dict[str, float]] = None):
        stream = self.stream or sys.stdout
        self.seen = min(self.seen + n, self.target)
        frac = self.seen / max(self.target, 1)
        bar = ("=" * int(frac * self.width)).ljust(self.width)
        msg = f"\r{self.seen}/{self.target} [{bar}]"
        if values:
            msg += " " + " ".join(f"{k}={v:.4f}" for k, v in values.items())
        if self.seen >= self.target:
            msg += f" ({time.time() - self.start:.1f}s)\n"
        stream.write(msg)
        stream.flush()

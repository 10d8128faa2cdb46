"""Precise BatchNorm: running statistics recomputed after training.

Counterpart of cross_modal_video_engine_tpu/train/precise_bn.py (MCT
mmaction/utils/precise_bn.py): up to `num_iters` batches run through the
model with its BatchNorms in train mode; each forward's batch statistic
is recovered from its EMA step, new = (1 - m) old + m batch, with each
BatchNorm's own momentum m (torch's convention: flax's 0.9 is 0.1 here,
YOLO's 0.97 is 0.03), and the running mean and variance become the
average of those batch statistics.  The variances averaged are the biased
ones the flax-style BatchNorms of the port move their running variance
by (models/layers.FlaxBatchNorm, FlaxBatchNorm1d, models/yolo.BatchNorm);
torch's own `momentum=None` cumulative average, which averages unbiased
variances, is not used.  Every forward starts from the statistics the
model had on entry, as the JAX fold applies each batch to the same
variables.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
from torch import nn


def update_bn_stats(model: nn.Module, batches: Iterable,
                    num_iters: int = 200,
                    forward: Optional[Callable] = None) -> nn.Module:
    """Replace the running statistics of every BatchNorm of `model` by the
    average of its batch statistics over the first `num_iters` batches.
    forward(model, batch) runs one train-mode forward (default:
    model(batch)); the model runs without a graph, in train mode, and is
    left in the mode it had.  Returns the model."""
    bns = [m for m in model.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)
           and m.running_mean is not None]
    if not bns:
        return model
    start = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    sums = [(torch.zeros_like(a), torch.zeros_like(b)) for a, b in start]
    count = 0
    was_training = model.training
    model.train()
    try:
        with torch.no_grad():
            for i, batch in enumerate(batches):
                if i >= num_iters:
                    break
                for m, (mean, var) in zip(bns, start):
                    m.running_mean.copy_(mean)
                    m.running_var.copy_(var)
                if forward is None:
                    model(batch)
                else:
                    forward(model, batch)
                for m, (mean, var), (sm, sv) in zip(bns, start, sums):
                    k = m.momentum
                    sm.add_((m.running_mean - (1 - k) * mean) / k)
                    sv.add_((m.running_var - (1 - k) * var) / k)
                count += 1
            for m, (mean, var), (sm, sv) in zip(bns, start, sums):
                if count:
                    m.running_mean.copy_(sm / count)
                    m.running_var.copy_(sv / count)
                else:
                    m.running_mean.copy_(mean)
                    m.running_var.copy_(var)
    finally:
        model.train(was_training)
    return model

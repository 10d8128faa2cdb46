"""Combiner (composed retrieval) training.

Counterpart of cross_modal_video_engine_tpu/train/combiner_trainer.py
(MultiFusion/src/combiner_train.py:242-438): the CLIP towers stay frozen
(video features precomputed, text encoded by the frozen text tower), only
the Combiner trains, with the in-batch contrastive CE over the target
features.

A step runs the Combiner in train mode (its dropouts draw from the
`torch.Generator` given to `make_combiner_train_step`), backpropagates and
takes one step of `train/optim.OptaxOptimizer`: optax's Adam, after
`clip_by_global_norm` when `grad_clip > 0`.  `CombinerTrainState` is the
model with its optimizer; a step updates both in place and hands the state
back, as the JAX step returns its new state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ..losses.contrastive import clip_contrastive_loss
from ..models.combiner import Combiner, random_state_dict
from .linas_trainer import set_dropout_generator
from .optim import OptaxOptimizer


@dataclasses.dataclass(frozen=True)
class CombinerTrainConfig:
    learning_rate: float = 2e-5
    grad_clip: float = 0.0
    num_epochs: int = 300
    validation_frequency: int = 3     # epochs (combiner_train.py:392)


class CombinerTrainState(NamedTuple):
    model: Combiner                  # the parameters
    optimizer: OptaxOptimizer        # count, moments, learning rate


def make_combiner_optimizer(cfg: CombinerTrainConfig
                            ) -> Callable[..., OptaxOptimizer]:
    """The optimizer's factory, called on (name, parameter) pairs: Adam,
    with the global-norm clip only when grad_clip > 0."""
    return functools.partial(
        OptaxOptimizer, lr=cfg.learning_rate, kind="adam",
        max_norm=cfg.grad_clip if cfg.grad_clip > 0 else None)


def make_combiner_train_step(model: Combiner,
                             generator: torch.Generator = None):
    """step(state, ref_feats, text_feats, target_feats) -> (state, loss):
    one forward in train mode, backward and optimizer step.  Features are
    tensors on the model's device: ref_feats and target_feats (high
    (B, F, D), middle (B, F, L, D)), text_feats (B, D).  loss: a detached
    0-d tensor."""
    set_dropout_generator(model, generator)

    def step(state: CombinerTrainState, ref_feats, text_feats,
             target_feats):
        net, opt = state
        if net is not model:
            raise ValueError("the state's model is not the one the step "
                             "was made for")
        net.train()
        opt.zero_grad(set_to_none=True)
        loss = clip_contrastive_loss(net(ref_feats, text_feats,
                                         target_feats))
        loss.backward()
        opt.step()
        return state, loss.detach()

    return step


def init_combiner_state(model: Combiner, tx, seed: int = 0
                        ) -> CombinerTrainState:
    """The model's weights drawn by `random_state_dict(model.cfg, seed)`
    (a numpy seed; the JAX package draws flax's init), and a fresh
    optimizer over its parameters."""
    model.load_state_dict(random_state_dict(model.cfg, seed))
    return CombinerTrainState(model, tx(list(model.named_parameters())))


@torch.no_grad()
def composed_rank_eval(model: Combiner, ref_feats, text_feats,
                       index_high: torch.Tensor,
                       reference_rows: torch.Tensor, gt_rows: torch.Tensor,
                       top_k: int = 50) -> Tuple[np.ndarray, dict]:
    """Reference-video-masked recall (MultiFusion validate.py:76-138): the
    query's own reference video is removed from the ranking (its distance
    set to +inf) before R@K is computed.  Returns the top-`top_k` ranking
    columns as a numpy array and the recalls.  The top-k is exact
    (`torch.topk`), as both of the JAX function's branches are (lax.top_k,
    and approx_max_k at recall_target=1.0 past 4096 rows); rows at equal
    distance may come in another order."""
    model.eval()
    pred = model.combine_features(ref_feats, text_feats)
    index = index_high.mean(dim=1)
    index = index / torch.linalg.norm(index, dim=-1, keepdim=True)
    dists = 1.0 - pred.float() @ index.float().t()
    q = torch.arange(dists.shape[0], device=dists.device)
    dists[q, reference_rows.to(dists.device)] = float("inf")
    kk = min(top_k, dists.shape[1])
    order = torch.topk(-dists, kk, dim=1).indices.cpu().numpy()
    h = order == np.asarray(gt_rows.cpu())[:, None]
    metrics = {f"recall_at{k}": float(h[:, : min(k, kk)].any(axis=1).mean()
                                      * 100)
               for k in (1, 5, 10, 50)}
    return order, metrics

"""Bidirectional max-margin triplet ranking loss.

Counterpart of cross_modal_video_engine_tpu/losses/triplet.py (the
reference LINAS-engine/loss.py:83-153, TripletLoss.forward): the score
matrix sim(im, s) with the positives on its diagonal, the margin hinge
against the row and column diagonals, the diagonal masked to 0, optional
hardest-negative reduction, sum/mean cost style, and the t2v / v2t / all
directions.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.similarity import get_sim


@dataclasses.dataclass(frozen=True)
class TripletLossConfig:
    margin: float = 0.2
    measure: str = "cosine"
    max_violation: bool = False
    cost_style: str = "sum"      # 'sum' | 'mean'
    direction: str = "all"       # 'all' | 't2v' | 'v2t'


def triplet_loss(s: torch.Tensor, im: torch.Tensor,
                 cfg: TripletLossConfig = TripletLossConfig()
                 ) -> torch.Tensor:
    """s: caption embeddings (B, d); im: video embeddings (B, d)."""
    scores = get_sim(cfg.measure)(im, s)     # (B, B): rows=videos, cols=captions
    diagonal = torch.diagonal(scores)[:, None]
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    reduce = torch.sum if cfg.cost_style == "sum" else torch.mean

    total = torch.zeros((), dtype=scores.dtype, device=scores.device)
    # (cost against the row (video) positive, axis of the hardest negative)
    sides = []
    if cfg.direction in ("v2t", "all"):
        sides.append((diagonal, 1))
    if cfg.direction in ("t2v", "all"):
        sides.append((diagonal.t(), 0))
    for positive, axis in sides:
        cost = torch.clamp_min(cfg.margin + scores - positive, 0.0)
        cost = cost.masked_fill(eye, 0.0)
        if cfg.max_violation:
            # amax splits the gradient between ties, as jnp.max does
            cost = torch.amax(cost, dim=axis)
        total = total + reduce(cost)
    return total

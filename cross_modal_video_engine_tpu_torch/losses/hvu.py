"""The HVU multi-category tag loss, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/losses/hvu.py (MCT
mmaction/models/losses/hvu_loss.py:10-160): sigmoid binary cross entropy
over the concatenated tag vocabulary of the Holistic Video Understanding
categories, as one flat loss ('all') or category by category
('individual', normalized category weights); `with_mask` leaves out the
tags (per-tag `mask`) or categories (`category_mask`) a clip has no
labels for.  It takes the (label, mask, category_mask) triple of
data/datasets_extra.HVUDataset.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

DEFAULT_CATEGORIES = ("action", "attribute", "concept", "event", "object",
                      "scene")
DEFAULT_CATEGORY_NUMS = (739, 117, 291, 69, 1678, 248)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, elementwise:
    -labels·log σ(x) - (1 - labels)·log(1 - σ(x))."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


def hvu_loss(cls_score: torch.Tensor, label: torch.Tensor,
             mask: Optional[torch.Tensor] = None,
             category_mask: Optional[torch.Tensor] = None,
             categories: Sequence[str] = DEFAULT_CATEGORIES,
             category_nums: Sequence[int] = DEFAULT_CATEGORY_NUMS,
             category_loss_weights: Optional[Sequence[float]] = None,
             loss_type: str = "all", with_mask: bool = False,
             reduction: str = "mean") -> Dict[str, torch.Tensor]:
    """cls_score, label: (B, sum(category_nums)) logits and many-hot tags;
    mask: (B, total) per-tag validity; category_mask: (B, n_categories).
    Returns {"loss_cls"} and, for 'individual', "<name>_LOSS" and
    "<name>_LOSS_weight" for each category."""
    if loss_type not in ("all", "individual"):
        raise ValueError(f"loss_type {loss_type!r}")
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction {reduction!r}")
    if category_loss_weights is None:
        category_loss_weights = (1.0,) * len(categories)
    bce = _bce(cls_score.float(), label.float())

    if loss_type == "all":
        if with_mask:
            if mask is None:
                raise ValueError("with_mask needs the per-tag mask")
            w = (mask * bce).sum(1)
            if reduction == "mean":
                w = w / mask.sum(1).clamp_min(1e-6)
            return {"loss_cls": w.mean()}
        per = bce.sum(-1) if reduction == "sum" else bce
        return {"loss_cls": per.mean()}

    if with_mask and category_mask is None:
        raise ValueError("with_mask needs the category mask")
    losses: Dict[str, torch.Tensor] = {}
    weights: Dict[str, torch.Tensor] = {}
    start = 0
    for idx, (name, num) in enumerate(zip(categories, category_nums)):
        cat = bce[:, start:start + num]
        start += num
        per = cat.mean(1) if reduction == "mean" else cat.sum(1)
        key = f"{name}_LOSS"
        if with_mask:
            cm = category_mask[:, idx].reshape(-1).float()
            n_labeled = cm.sum()
            labeled = n_labeled >= 0.5
            losses[key] = torch.where(
                labeled, (per * cm).sum() / n_labeled.clamp_min(1e-6),
                torch.zeros_like(n_labeled))
            weights[key] = torch.where(
                labeled, torch.tensor(float(category_loss_weights[idx]),
                                      device=bce.device),
                torch.zeros_like(n_labeled))
        else:
            losses[key] = per.mean()
            weights[key] = torch.tensor(float(category_loss_weights[idx]),
                                        device=bce.device)
    total_w = sum(weights.values())
    norm = {k: v / total_w.clamp_min(1e-6) for k, v in weights.items()}
    losses["loss_cls"] = sum(losses[k] * norm[k] for k in norm)
    losses.update({k + "_weight": v for k, v in norm.items()})
    return losses

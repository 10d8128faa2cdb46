"""Temporal-shuffle contrast losses, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/losses/shuffle.py (MCT
recognizer_shuffle.py), used by the shuffle recognizers of
models/recognizer.py:

* `cosine_away_loss`: torch's CosineEmbeddingLoss at target -1, the
  shuffled clip's embedding pushed away from the ordered clip's
  (ce_cos_loss.py:39, 55-64);
* `soft_label_smooth` and `soft_cross_entropy`: the shuffled clip
  supervised with a softened one-hot (ce_soft_loss.py:56-61, 110-140).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cosine_away_loss(x: torch.Tensor, y: torch.Tensor,
                     margin: float = 0.5) -> torch.Tensor:
    """mean(max(0, cos(x_i, y_i) - margin)), each row normalized by
    max(|row|, 1e-12)."""
    xn = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    yn = y / y.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return (xn * yn).sum(-1).sub(margin).clamp_min(0.0).mean()


def soft_label_smooth(labels: torch.Tensor, num_classes: int,
                      margin: float = 0.5) -> torch.Tensor:
    """(B,) int labels -> (B, C) fp32: `margin` at the true class,
    (1 - margin) / C elsewhere."""
    onehot = F.one_hot(labels.long(), num_classes)
    rest = torch.full(onehot.shape, (1.0 - margin) / num_classes,
                      device=labels.device)
    return torch.where(onehot == 0, rest, torch.full_like(rest, margin))


def soft_cross_entropy(scores: torch.Tensor,
                       soft_labels: torch.Tensor) -> torch.Tensor:
    return -(soft_labels * torch.log_softmax(scores, -1)).sum(-1).mean()

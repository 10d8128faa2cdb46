"""In-batch contrastive losses.

Counterpart of cross_modal_video_engine_tpu/losses/contrastive.py:
`info_nce_logits` + `clip_contrastive_loss`, the batch-contrastive CE the
MultiFusion combiner trains with (combiner_train.py:368-370: logits from
Combiner.forward, target = arange(B)).  The mesh-sharded variant
(`sharded_contrastive_loss`, targets all-gathered over the data axis) is
not ported yet and raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NO_MESH = ("the mesh-sharded contrastive loss is not ported yet (ROADMAP "
           "queue 1 item 11)")


def info_nce_logits(pred: torch.Tensor, target: torch.Tensor,
                    logit_scale: float = 100.0) -> torch.Tensor:
    """pred, target: L2-normalized (B, d) -> (B, B) scaled f32 logits."""
    return logit_scale * (pred.float() @ target.float().t())


def clip_contrastive_loss(logits: torch.Tensor) -> torch.Tensor:
    """CE against the diagonal, the mean over rows."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits.float(), labels)


def sharded_contrastive_loss(pred, target, axis_name, logit_scale=100.0):
    raise NotImplementedError(NO_MESH)

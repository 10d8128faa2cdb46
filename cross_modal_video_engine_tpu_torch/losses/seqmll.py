"""Multi-label sequence loss for label-sequence (caption) training.

Counterpart of cross_modal_video_engine_tpu/losses/seqmll.py (reference
MCT/mmaction/models/losses/seqmll_loss.py:10-78):
`multilabel_categorical_crossentropy` is the logsumexp-margin multi-label
cross entropy (https://kexue.fm/archives/7359), with a zero column
appended before each logsumexp and the 1e12 margins in float32;
`seq_mll_loss` applies it per decoder step, truncates the labels and the
mask to the decoder's steps, masks padded steps and divides by the batch
size (not by the number of valid steps).

`Recognizer3DRelseq.forward_train` feeds it the decoder's sigmoid
probabilities, not logits, as the reference does.
"""

from __future__ import annotations

import torch


def multilabel_categorical_crossentropy(y_true: torch.Tensor,
                                        y_pred: torch.Tensor
                                        ) -> torch.Tensor:
    """y_true in {0, 1}, y_pred scores of the same shape (..., C) ->
    per-row loss (...)."""
    y_pred = (1.0 - 2.0 * y_true) * y_pred
    y_pred_neg = y_pred - y_true * 1e12
    y_pred_pos = y_pred - (1.0 - y_true) * 1e12
    zeros = torch.zeros_like(y_pred[..., :1])
    neg = torch.logsumexp(torch.cat([y_pred_neg, zeros], -1), -1)
    pos = torch.logsumexp(torch.cat([y_pred_pos, zeros], -1), -1)
    return neg + pos


def seq_mll_loss(cls_score: torch.Tensor, label: torch.Tensor,
                 mask: torch.Tensor, loss_weight: float = 1.0
                 ) -> torch.Tensor:
    """cls_score: (N, T, C); label: (N, T', C); mask: (N, T') with T' >= T.
    -> the masked sum of the per-step losses over the batch size."""
    t = cls_score.shape[1]
    label, mask = label[:, :t], mask[:, :t]
    loss = multilabel_categorical_crossentropy(
        label.reshape(-1, label.shape[-1]),
        cls_score.reshape(-1, cls_score.shape[-1]))
    return loss_weight * torch.sum(loss * mask.reshape(-1)) \
        / cls_score.shape[0]

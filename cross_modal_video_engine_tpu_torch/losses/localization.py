"""Temporal-action-localization losses (BMN, BSN, SSN).

Counterpart of cross_modal_video_engine_tpu/losses/localization.py (after
the reference's binary_logistic_regression_loss.py, bmn_loss.py,
localizers/bsn.py, ohem_hinge_loss.py and ssn_loss.py):
* binary logistic regression: positive-ratio reweighted BCE;
* BMN: TEM, PEM regression and PEM classification;
* BSN: TEM (weighted action/start/end BLR) and PEM (smooth-L1 on the
  temporal iou, plain or with the reference's balanced subsampling);
* SSN: activity cross entropy, OHEM hinge completeness and class-wise
  regression.

Two losses subsample at random: `bmn_pem_reg_loss` and
`bsn_pem_weighted_loss` take their two uniform draws (each of the target's
shape) handed in as `draws=(u_m, u_l)`, or draw them from `generator` on
the CPU.  optax's `huber_loss(delta=1)` is `F.smooth_l1_loss(beta=1)`,
`softmax_cross_entropy_with_integer_labels` is `F.cross_entropy`; the
OHEM top-k keeps `int(group_size * ohem_ratio)` entries per group and the
gradient reaches those only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _uniforms(shape, like: torch.Tensor, draws, generator
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (u_m, u_l) pair: handed in, or two float32 uniforms of `shape`
    drawn on the CPU from `generator` (u_m first), on like's device."""
    if draws is None:
        draws = tuple(torch.rand(tuple(shape), generator=generator)
                      for _ in range(2))
    return tuple((u if isinstance(u, torch.Tensor) else torch.from_numpy(
        np.array(u, np.float32))).to(like.device, like.dtype) for u in draws)


def binary_logistic_regression_loss(pred, label, threshold: float = 0.5,
                                    ratio_range: Tuple[float, float] = (1.05,
                                                                        21),
                                    eps: float = 1e-5):
    """Positive-ratio reweighted binary cross entropy over sigmoid scores."""
    pred = pred.reshape(-1)
    label = label.reshape(-1)
    pmask = (label > threshold).to(pred.dtype)
    num_positive = torch.clamp(pmask.sum(), min=1.0)
    ratio = torch.clamp(pred.shape[0] / num_positive, ratio_range[0],
                        ratio_range[1])
    coef_0 = 0.5 * ratio / (ratio - 1)
    coef_1 = 0.5 * ratio
    loss = (coef_1 * pmask * torch.log(pred + eps)
            + coef_0 * (1.0 - pmask) * torch.log(1.0 - pred + eps))
    return -loss.mean()


# -- BMN ----------------------------------------------------------------------

def bmn_tem_loss(pred_start, pred_end, gt_start, gt_end):
    return (binary_logistic_regression_loss(pred_start, gt_start)
            + binary_logistic_regression_loss(pred_end, gt_end))


def bmn_pem_reg_loss(pred_score, gt_iou_map, mask, draws=None,
                     generator: Optional[torch.Generator] = None,
                     high_threshold: float = 0.7,
                     low_threshold: float = 0.3):
    """MSE over high-iou anchors plus randomly subsampled mid/low anchors
    (subsample rate balances each band against the positives)."""
    f = pred_score.dtype
    u_hmask = (gt_iou_map > high_threshold).to(f)
    u_mmask = ((gt_iou_map <= high_threshold)
               & (gt_iou_map > low_threshold)).to(f)
    u_lmask = ((gt_iou_map <= low_threshold)
               & (gt_iou_map > 0.)).to(f) * mask
    u_m, u_l = _uniforms(gt_iou_map.shape, gt_iou_map, draws, generator)

    num_h = u_hmask.sum()
    r_m = num_h / torch.clamp(u_mmask.sum(), min=1e-6)
    u_smmask = ((u_mmask * u_m) > (1.0 - r_m)).to(f)
    r_l = num_h / torch.clamp(u_lmask.sum(), min=1e-6)
    u_slmask = ((u_lmask * u_l) > (1.0 - r_l)).to(f)

    weights = u_hmask + u_smmask + u_slmask
    mse = ((pred_score * weights - gt_iou_map * weights) ** 2).mean()
    return 0.5 * mse * weights.numel() / torch.clamp(weights.sum(),
                                                     min=1e-6)


def bmn_pem_cls_loss(pred_score, gt_iou_map, mask,
                     threshold: float = 0.9,
                     ratio_range: Tuple[float, float] = (1.05, 21),
                     eps: float = 1e-5):
    f = pred_score.dtype
    pmask = (gt_iou_map > threshold).to(f)
    nmask = (gt_iou_map <= threshold).to(f) * mask
    num_positive = torch.clamp(pmask.sum(), min=1.0)
    num_entries = num_positive + nmask.sum()
    ratio = torch.clamp(num_entries / num_positive, ratio_range[0],
                        ratio_range[1])
    loss_pos = 0.5 * ratio * torch.log(pred_score + eps) * pmask
    loss_neg = (0.5 * ratio / (ratio - 1)
                * torch.log(1.0 - pred_score + eps) * nmask)
    return -(loss_pos + loss_neg).sum() / num_entries


def bmn_loss(pred_reg, pred_cls, pred_start, pred_end, gt_iou_map, gt_start,
             gt_end, bm_mask, draws=None,
             generator: Optional[torch.Generator] = None,
             weight_tem: float = 1.0, weight_pem_reg: float = 10.0,
             weight_pem_cls: float = 1.0):
    """Weighted BMN loss -> (total, tem, pem_reg, pem_cls)."""
    gt_iou_map = gt_iou_map * bm_mask
    reg = bmn_pem_reg_loss(pred_reg, gt_iou_map, bm_mask, draws, generator)
    cls = bmn_pem_cls_loss(pred_cls, gt_iou_map, bm_mask)
    tem = bmn_tem_loss(pred_start, pred_end, gt_start, gt_end)
    total = weight_tem * tem + weight_pem_reg * reg + weight_pem_cls * cls
    return total, tem, reg, cls


# -- BSN ----------------------------------------------------------------------

def bsn_tem_loss(pred_action, pred_start, pred_end, gt_action, gt_start,
                 gt_end, action_loss_weight: float = 2.0) -> Dict:
    """Per-snippet BLR over action/start/end probability sequences."""
    loss_action = binary_logistic_regression_loss(pred_action, gt_action)
    loss_start = binary_logistic_regression_loss(pred_start, gt_start)
    loss_end = binary_logistic_regression_loss(pred_end, gt_end)
    return {
        "loss_action": loss_action * action_loss_weight,
        "loss_start": loss_start,
        "loss_end": loss_end,
        "loss": (loss_action * action_loss_weight + loss_start + loss_end),
    }


def _huber(pred, target):
    return F.smooth_l1_loss(pred, target, beta=1.0, reduction="none")


def bsn_pem_loss(pred_iou, gt_iou):
    """Smooth-L1 between predicted proposal confidence and temporal iou."""
    return _huber(pred_iou, gt_iou).mean()


def bsn_pem_weighted_loss(pred_iou, gt_iou, draws=None,
                          generator: Optional[torch.Generator] = None,
                          u_ratio_m: float = 1.0, u_ratio_l: float = 2.0,
                          high_thr: float = 0.6, low_thr: float = 0.2):
    """The reference PEM training loss (bsn.py:313-349): elementwise
    smooth-L1 kept for ALL high-iou rows plus randomly subsampled
    medium/low rows, balanced to `u_ratio_m`/`u_ratio_l` times the
    high count; the weighted sum is normalized by the kept count."""
    f = pred_iou.dtype
    h = (gt_iou > high_thr).to(f)
    m = ((gt_iou <= high_thr) & (gt_iou > low_thr)).to(f)
    low = (gt_iou <= low_thr).to(f)
    u_m, u_l = _uniforms(gt_iou.shape, gt_iou, draws, generator)
    num_h = h.sum()
    # rand*mask > 1-r keeps each masked row with probability min(r, 1)
    r_m = torch.clamp(u_ratio_m * num_h / torch.clamp(m.sum(), min=1e-6),
                      max=1.0)
    sm = ((u_m * m) > (1.0 - r_m)).to(f)
    r_l = torch.clamp(u_ratio_l * num_h / torch.clamp(low.sum(), min=1e-6),
                      max=1.0)
    sl = ((u_l * low) > (1.0 - r_l)).to(f)
    w = h + sm + sl
    return (_huber(pred_iou, gt_iou) * w).sum() / torch.clamp(w.sum(),
                                                              min=1.0)


# -- SSN (OHEM hinge completeness + activity CE + classwise regression) -------

def ohem_hinge_loss(pred, labels, is_positive: int, ohem_ratio: float,
                    group_size: int):
    """Class-wise hinge with online hard example mining.

    pred: (N, C); labels: (N,) 1-based class ids; is_positive: +1 for
    positive proposals, -1 for incomplete; per group of `group_size` rows
    only the `int(group_size * ohem_ratio)` largest losses contribute.
    Returns the SUM over kept entries (like the reference).
    """
    n = pred.shape[0]
    picked = pred[torch.arange(n, device=pred.device), labels.long() - 1]
    losses = torch.clamp(1.0 - is_positive * picked, min=0.0)
    # no floor: the reference's int(group_size * ohem_ratio) can be 0
    # (the group then contributes nothing), and the kept count must
    # match ssn_completeness_loss's int(N * ohem_ratio) denominator
    keep = int(group_size * ohem_ratio)
    if keep == 0:
        return torch.zeros((), dtype=losses.dtype, device=losses.device)
    top = torch.topk(losses.reshape(-1, group_size), keep, dim=-1).values
    return top.sum()


def ssn_activity_loss(activity_score, labels, activity_indexer):
    """CE over positive+background proposals (ssn_loss.py:14-29)."""
    return F.cross_entropy(activity_score[activity_indexer],
                           labels[activity_indexer].long())


def ssn_completeness_loss(completeness_score, labels, completeness_indexer,
                          positive_per_video: int,
                          incomplete_per_video: int,
                          ohem_ratio: float = 0.17):
    """OHEM hinge over positive (+1) and incomplete (-1) proposals,
    normalized by kept-count (ssn_loss.py:31-81)."""
    pred = completeness_score[completeness_indexer]
    gt = labels[completeness_indexer].long()
    dim = pred.shape[1]
    per_video = positive_per_video + incomplete_per_video
    pred = pred.reshape(-1, per_video, dim)
    gt = gt.reshape(-1, per_video)
    pos_pred = pred[:, :positive_per_video].reshape(-1, dim)
    inc_pred = pred[:, positive_per_video:].reshape(-1, dim)
    pos_loss = ohem_hinge_loss(pos_pred,
                               gt[:, :positive_per_video].reshape(-1),
                               1, 1.0, positive_per_video)
    inc_loss = ohem_hinge_loss(inc_pred,
                               gt[:, positive_per_video:].reshape(-1),
                               -1, ohem_ratio, incomplete_per_video)
    num_pos = pos_pred.shape[0]
    num_inc = int(inc_pred.shape[0] * ohem_ratio)
    return (pos_loss + inc_loss) / float(num_pos + num_inc)


def ssn_classwise_regression_loss(bbox_pred, labels, bbox_targets,
                                  regression_indexer):
    """Smooth-L1 x2 on the (center, span) offsets of each proposal's own
    class (ssn_loss.py:84-115)."""
    pred = bbox_pred[regression_indexer]           # (P, C, 2)
    gt = labels[regression_indexer].long()
    target = bbox_targets[regression_indexer]      # (P, 2)
    cls_pred = pred[torch.arange(pred.shape[0], device=pred.device),
                    gt - 1]                        # (P, 2)
    return 2.0 * _huber(cls_pred.reshape(-1), target.reshape(-1)).mean()


def _nonzero(mask: torch.Tensor, count: int) -> torch.Tensor:
    """jnp.nonzero(mask, size=mask.size, fill_value=0)[0][:count]: the
    ascending indices of the set entries, padded with 0, the first
    `count`."""
    idx = torch.nonzero(mask).reshape(-1)[:count]
    if idx.numel() < count:
        idx = F.pad(idx, (0, count - idx.numel()))
    return idx


def ssn_loss(activity_score, completeness_score, bbox_pred, proposal_type,
             labels, bbox_targets, positive_per_video: int,
             background_per_video: int, incomplete_per_video: int,
             comp_loss_weight: float = 0.1,
             reg_loss_weight: float = 0.1) -> Dict:
    """Full SSN loss dict (ssn_loss.py:117-185).  proposal_type: (N,) int
    codes 0=positive, 1=incomplete, 2=background; proposals MUST be laid
    out grouped per video as [positives..., incompletes..., backgrounds...]
    (the sampler's contract), so the indexers have fixed counts."""
    proposal_type = proposal_type.reshape(-1)
    labels = labels.reshape(-1)
    n_videos = proposal_type.shape[0] // (
        positive_per_video + background_per_video + incomplete_per_video)
    activity_indexer = _nonzero(
        (proposal_type == 0) | (proposal_type == 2),
        n_videos * (positive_per_video + background_per_video))
    completeness_indexer = _nonzero(
        (proposal_type == 0) | (proposal_type == 1),
        n_videos * (positive_per_video + incomplete_per_video))

    losses = {
        "loss_activity": ssn_activity_loss(activity_score, labels,
                                           activity_indexer),
        "loss_completeness": comp_loss_weight * ssn_completeness_loss(
            completeness_score, labels, completeness_indexer,
            positive_per_video, incomplete_per_video,
            ohem_ratio=positive_per_video / incomplete_per_video),
    }
    if bbox_pred is not None:
        regression_indexer = _nonzero(proposal_type == 0,
                                      n_videos * positive_per_video)
        losses["loss_reg"] = reg_loss_weight * ssn_classwise_regression_loss(
            bbox_pred, labels, bbox_targets, regression_indexer)
    losses["loss"] = sum(v for k, v in losses.items() if k != "loss")
    return losses

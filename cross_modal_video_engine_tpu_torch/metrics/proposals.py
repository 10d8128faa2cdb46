"""Temporal-proposal evaluation metrics, numpy only.

Counterpart of cross_modal_video_engine_tpu/metrics/proposals.py, with
the semantics of MCT/mmaction/core/evaluation/accuracy.py:
* pairwise_temporal_iou (:363-421), vectorized over both segment sets;
* average_recall_at_avg_proposals (:424-545): the AR@AN curve and its AUC;
* interpolated_precision_recall (:580-596): VOC-style interpolated AP;
* average_precision_at_temporal_iou (:599-683): ActivityNet detection AP
  per temporal-iou threshold, each gt locked to one prediction.

The AUC is the trapezoid rule (`np.trapezoid`, named `np.trapz` before
numpy 2.0).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def pairwise_temporal_iou(candidate_segments: np.ndarray,
                          target_segments: np.ndarray,
                          calculate_overlap_self: bool = False):
    """IoU between every target (rows) and candidate (cols) segment.

    candidate_segments: (m, 2) or (2,); target_segments: (n, 2).
    Returns (n, m) iou (squeezed to (n,) for a 1-d candidate), plus
    intersection/candidate_length when calculate_overlap_self.
    """
    cand_ndim = candidate_segments.ndim
    if target_segments.ndim != 2 or cand_ndim not in (1, 2):
        raise ValueError("Dimension of arguments is incorrect")
    cand = np.atleast_2d(candidate_segments).astype(float)   # (m, 2)
    tgt = target_segments.astype(float)                       # (n, 2)

    inter_lo = np.maximum(tgt[:, None, 0], cand[None, :, 0])
    inter_hi = np.minimum(tgt[:, None, 1], cand[None, :, 1])
    inter = np.clip(inter_hi - inter_lo, 0, None)
    union = ((tgt[:, 1] - tgt[:, 0])[:, None]
             + (cand[:, 1] - cand[:, 0])[None, :] - inter)
    t_iou = (inter / union).astype(np.float32)
    if calculate_overlap_self:
        overlap_self = (inter
                        / (cand[:, 1] - cand[:, 0])[None, :]).astype(
                            np.float32)
        if cand_ndim == 1:
            return t_iou[:, 0], overlap_self[:, 0]
        return t_iou, overlap_self
    return t_iou[:, 0] if cand_ndim == 1 else t_iou


def average_recall_at_avg_proposals(
        ground_truth: Dict[str, np.ndarray],
        proposals: Dict[str, np.ndarray],
        total_num_proposals: int,
        max_avg_proposals: Optional[int] = None,
        temporal_iou_thresholds: np.ndarray = np.linspace(0.5, 0.95, 10)):
    """AR@AN: recall vs average number of proposals per video.

    ground_truth[vid]: (n, 2) segments; proposals[vid]: (m, 3) rows
    (start, end, score).  Returns (recall (n_thr, 100), average_recall
    (100,), proposals_per_video (100,), auc %).
    """
    temporal_iou_thresholds = np.asarray(temporal_iou_thresholds)
    total_num_videos = len(ground_truth)
    if not max_avg_proposals:
        max_avg_proposals = float(total_num_proposals) / total_num_videos
    ratio = max_avg_proposals * float(total_num_videos) / total_num_proposals

    # per-video iou matrices over the score-sorted, ratio-truncated props
    score_list = []
    total_retrieved = 0
    for video_id, gt in ground_truth.items():
        props = proposals[video_id]
        gt = np.atleast_2d(gt[:, :2].astype(np.float32))
        if props.shape[0] == 0:
            score_list.append(np.zeros((gt.shape[0], 1)))
            continue
        order = props[:, 2].argsort()[::-1]
        segs = np.atleast_2d(props[order, :2].astype(np.float32))
        n_keep = min(int(segs.shape[0] * ratio), segs.shape[0])
        total_retrieved += n_keep
        score_list.append(pairwise_temporal_iou(segs[:n_keep], gt))

    pcn_list = np.arange(1, 101) / 100.0 * (
        max_avg_proposals * float(total_num_videos) / total_retrieved)
    matches = np.empty((total_num_videos, pcn_list.shape[0]))
    positives = np.empty(total_num_videos)
    recall = np.empty((temporal_iou_thresholds.shape[0],
                       pcn_list.shape[0]))
    for ridx, thr in enumerate(temporal_iou_thresholds):
        for i, score in enumerate(score_list):
            positives[i] = score.shape[0]
            tp = score >= thr
            pcn_proposals = np.minimum(
                (score.shape[1] * pcn_list).astype(int), score.shape[1])
            for j, n_at in enumerate(pcn_proposals):
                matches[i, j] = np.count_nonzero(tp[:, :n_at].sum(axis=1))
        recall[ridx, :] = matches.sum(axis=0) / positives.sum()

    avg_recall = recall.mean(axis=0)
    proposals_per_video = pcn_list * (
        float(total_retrieved) / total_num_videos)
    auc = 100.0 * float(_trapezoid(avg_recall, proposals_per_video)) / \
        proposals_per_video[-1]
    return recall, avg_recall, proposals_per_video, auc


def interpolated_precision_recall(precision: np.ndarray,
                                  recall: np.ndarray) -> float:
    """VOC-2011 interpolated average precision."""
    mprec = np.hstack([[0], precision, [0]])
    mrec = np.hstack([[0], recall, [1]])
    mprec = np.maximum.accumulate(mprec[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def average_precision_at_temporal_iou(
        ground_truth: Dict[str, np.ndarray],
        prediction: Sequence[Sequence],
        temporal_iou_thresholds: np.ndarray = np.linspace(0.5, 0.95, 10)
        ) -> np.ndarray:
    """ActivityNet-style detection AP per temporal-iou threshold.

    ground_truth[vid]: (n, 2) segments of ONE class; prediction rows:
    (video_id, class_id, t_start, t_end, score).  Each gt can match at
    most one prediction per threshold (highest score wins).
    """
    temporal_iou_thresholds = np.asarray(temporal_iou_thresholds)
    ap = np.zeros(len(temporal_iou_thresholds), np.float32)
    if len(prediction) < 1:
        return ap

    num_gts = 0
    lock_gt = {}
    for vid, gt in ground_truth.items():
        lock_gt[vid] = np.full((len(temporal_iou_thresholds), len(gt)), -1.0)
        num_gts += len(gt)

    prediction = np.array(prediction, dtype=object)
    scores = np.array([float(p[4]) for p in prediction])
    prediction = prediction[np.argsort(scores)[::-1]]

    tp = np.zeros((len(temporal_iou_thresholds), len(prediction)), np.int32)
    fp = np.zeros_like(tp)
    for idx, pred in enumerate(prediction):
        vid = pred[0]
        if vid not in ground_truth:
            fp[:, idx] = 1
            continue
        gt = np.asarray(ground_truth[vid], dtype=float)
        t_iou = pairwise_temporal_iou(
            np.asarray([float(pred[2]), float(pred[3])]), gt)
        order = t_iou.argsort()[::-1]
        for t_idx, thr in enumerate(temporal_iou_thresholds):
            for jdx in order:
                if t_iou[jdx] < thr:
                    fp[t_idx, idx] = 1
                    break
                if lock_gt[vid][t_idx, jdx] >= 0:
                    continue
                tp[t_idx, idx] = 1
                lock_gt[vid][t_idx, jdx] = idx
                break
            if fp[t_idx, idx] == 0 and tp[t_idx, idx] == 0:
                fp[t_idx, idx] = 1

    tp_cum = np.cumsum(tp, axis=1).astype(np.float32)
    fp_cum = np.cumsum(fp, axis=1).astype(np.float32)
    recall = tp_cum / num_gts
    precision = tp_cum / (tp_cum + fp_cum)
    for t_idx in range(len(temporal_iou_thresholds)):
        ap[t_idx] = interpolated_precision_recall(precision[t_idx],
                                                  recall[t_idx])
    return ap

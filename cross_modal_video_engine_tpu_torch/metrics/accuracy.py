"""Recognition metrics (MCT/mmaction parity), numpy only.

Counterpart of cross_modal_video_engine_tpu/metrics/accuracy.py, with the
semantics of MCT/mmaction/core/evaluation/accuracy.py:
  * top_k_accuracy (accuracy.py:154-172)
  * mean_class_accuracy (accuracy.py:73-91)
  * confusion_matrix (rows = ground truth, cols = prediction)
  * mean_average_precision / mmit mAP over multi-label scores via the
    binary precision-recall curve integral;
  * seq_average_precision, the caption (label-sequence) evaluation.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def confusion_matrix(y_pred: Sequence[int], y_real: Sequence[int],
                     normalize: str | None = None) -> np.ndarray:
    y_pred = np.asarray(y_pred, dtype=np.int64)
    y_real = np.asarray(y_real, dtype=np.int64)
    label_set = np.unique(np.concatenate((y_pred, y_real)))
    num_labels = len(label_set)
    max_label = int(label_set[-1]) if num_labels else 0
    label_map = np.zeros(max_label + 1, dtype=np.int64)
    for i, label in enumerate(label_set):
        label_map[label] = i
    mat = np.zeros((num_labels, num_labels), dtype=np.int64)
    np.add.at(mat, (label_map[y_real], label_map[y_pred]), 1)
    if normalize == "true":
        mat = mat / np.maximum(mat.sum(axis=1, keepdims=True), 1)
    elif normalize == "pred":
        mat = mat / np.maximum(mat.sum(axis=0, keepdims=True), 1)
    elif normalize == "all":
        mat = mat / max(mat.sum(), 1)
    return mat


def top_k_accuracy(scores: Sequence[np.ndarray], labels: Sequence[int],
                   topk: Tuple[int, ...] = (1,)) -> List[float]:
    scores = np.asarray(scores)
    labels = np.asarray(labels)[:, None]
    res = []
    for k in topk:
        max_k_preds = np.argsort(scores, axis=1)[:, -k:][:, ::-1]
        match = np.logical_or.reduce(max_k_preds == labels, axis=1)
        res.append(float(match.sum() / match.shape[0]))
    return res


def mean_class_accuracy(scores: Sequence[np.ndarray],
                        labels: Sequence[int]) -> float:
    pred = np.argmax(np.asarray(scores), axis=1)
    cf = confusion_matrix(pred, labels).astype(np.float64)
    cls_cnt = cf.sum(axis=1)
    cls_hit = np.diag(cf)
    per_class = np.where(cls_cnt > 0, cls_hit / np.maximum(cls_cnt, 1), 0.0)
    return float(per_class.mean())


def binary_precision_recall_curve(y_score: np.ndarray, y_true: np.ndarray
                                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    if y_score.shape != y_true.shape:
        raise ValueError(f"scores {y_score.shape} vs labels {y_true.shape}")
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    thresholds = y_score[threshold_idxs]
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = tps / (tps + fps)
    precision[np.isnan(precision)] = 0
    if tps[-1] == 0:
        recall = np.zeros_like(tps, dtype=np.float64)
    else:
        recall = tps / tps[-1]
    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    return np.r_[precision[sl], 1], np.r_[recall[sl], 0], thresholds[sl]


def _average_precision(y_score: np.ndarray, y_true: np.ndarray) -> float:
    if np.sum(y_true) == 0:
        return np.nan  # classes with no positives are filtered out of the mean
    precision, recall, _ = binary_precision_recall_curve(y_score, y_true)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def mean_average_precision(scores: Sequence[np.ndarray],
                           labels: Sequence[np.ndarray]) -> float:
    """Class-major mAP over multilabel ground truth."""
    scores_t = np.stack(scores).T
    labels_t = np.stack(labels).T
    results = [_average_precision(s, l) for s, l in zip(scores_t, labels_t)]
    results = [x for x in results if not np.isnan(x)]
    return float(np.mean(results)) if results else np.nan


def seq_average_precision(scores: Sequence[np.ndarray],
                          labels: Sequence[np.ndarray]) -> list:
    """Per-class AP over label-SEQUENCE steps, the caption evaluation
    (reference accuracy.py:268-317): per video, the steps after the first
    end-token step (last class hot) are dropped, keeping one; the
    remaining (video, step) rows pool together; AP per class, NaN -> 0.

    scores[i]: (seq_len * C,) or (seq_len, C); labels[i]: (seq_len, C)
    many-hot with the end token as class C-1.  Returns the per-class AP
    list (the reference's return shape)."""
    kept_scores, kept_labels = [], []
    for s, l in zip(scores, labels):
        l = np.asarray(l)
        s = np.asarray(s).reshape(l.shape)
        end_steps = int((l[:, -1] == 1).sum())
        keep = l.shape[0] - end_steps + 1
        kept_scores.append(s[:keep])
        kept_labels.append(l[:keep])
    s_cls = np.concatenate(kept_scores).T          # (C, total_steps)
    l_cls = np.concatenate(kept_labels).T
    results = []
    for sc, lb in zip(s_cls, l_cls):
        precision, recall, _ = binary_precision_recall_curve(sc, lb)
        ap = -np.sum(np.diff(recall) * np.asarray(precision)[:-1])
        results.append(0.0 if np.isnan(ap) else float(ap))
    return results


def mmit_mean_average_precision(scores: Sequence[np.ndarray],
                                labels: Sequence[np.ndarray]) -> float:
    """Sample-major (multi-moments-in-time style) mAP."""
    results = [_average_precision(np.asarray(s), np.asarray(l))
               for s, l in zip(scores, labels)]
    results = [x for x in results if not np.isnan(x)]
    return float(np.mean(results)) if results else np.nan

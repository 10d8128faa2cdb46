"""Cross-modal retrieval metrics.

A copy of cross_modal_video_engine_tpu/metrics/retrieval.py.

Parity with LINAS-engine/util/metrics.py (t2v/v2t R@K, medr, meanr, mAP,
eval_q2m, get_gt) — same rank conventions:
  * `t2v`/`v2t` return medr = floor(median(0-based ranks)) + 1 and
    meanr = mean + 1 (metrics.py:26-28, 54-56).
  * `eval_q2m` uses 1-based min-rank over multiple ground truths
    (metrics.py:124-157).
All loops are vectorized; rank extraction uses argsort with stable ordering
to match numpy's `np.where(inds == gt)` semantics of the reference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _inverse_perm(errors: np.ndarray) -> np.ndarray:
    """inv[i, j] = 0-based rank of column j when row i is argsorted
    ascending (one copy of the rank-inversion logic)."""
    order = np.argsort(errors, axis=1, kind="stable")
    inv = np.empty_like(order)
    rows = np.arange(order.shape[0])[:, None]
    inv[rows, order] = np.arange(order.shape[1])[None, :]
    return inv


def _ranks_of(errors: np.ndarray, gt_cols: np.ndarray) -> np.ndarray:
    """0-based rank of column gt_cols[i] when row i is argsorted ascending."""
    return _inverse_perm(errors)[np.arange(len(gt_cols)), gt_cols]


def t2v(c2i: np.ndarray, n_caption: int = 5) -> List[float]:
    """c2i: (n_caption*N, N) caption->video error matrix."""
    assert c2i.shape[0] // c2i.shape[1] == n_caption, c2i.shape
    gt = np.arange(c2i.shape[0]) // n_caption
    ranks = _ranks_of(c2i, gt).astype(np.float64)
    r1 = 100.0 * np.mean(ranks < 1)
    r5 = 100.0 * np.mean(ranks < 5)
    r10 = 100.0 * np.mean(ranks < 10)
    medr = float(np.floor(np.median(ranks)) + 1)
    meanr = float(ranks.mean() + 1)
    return [float(r1), float(r5), float(r10), medr, meanr]


def v2t(c2i: np.ndarray, n_caption: int = 5) -> List[float]:
    """Best (first-in-argsort) caption rank per video; caption block i*n..(i+1)*n
    belongs to video i (metrics.py:43-49)."""
    assert c2i.shape[0] // c2i.shape[1] == n_caption, c2i.shape
    i2c = c2i.T  # (N, n_caption*N)
    order = np.argsort(i2c, axis=1, kind="stable")
    hit = (order // n_caption) == np.arange(i2c.shape[0])[:, None]
    ranks = np.argmax(hit, axis=1).astype(np.float64)
    r1 = 100.0 * np.mean(ranks < 1)
    r5 = 100.0 * np.mean(ranks < 5)
    r10 = 100.0 * np.mean(ranks < 10)
    medr = float(np.floor(np.median(ranks)) + 1)
    meanr = float(ranks.mean() + 1)
    return [float(r1), float(r5), float(r10), medr, meanr]


def get_gt(video_ids: Sequence[str], caption_ids: Sequence[str]
           ) -> Tuple[List[List[int]], Dict[int, List[int]]]:
    """Ground truth from the `vid#cap` id scheme (metrics.py:106-120)."""
    v2t_gt: List[List[int]] = []
    for vid_id in video_ids:
        v2t_gt.append([
            i for i, cap_id in enumerate(caption_ids)
            if cap_id.split("#", 1)[0] == vid_id
        ])
    t2v_gt: Dict[int, List[int]] = {}
    for i, t_gts in enumerate(v2t_gt):
        for t_gt in t_gts:
            t2v_gt.setdefault(t_gt, []).append(i)
    return v2t_gt, t2v_gt


def t2v_map(c2i: np.ndarray, t2v_gts: Dict[int, List[int]]) -> float:
    """AP of the single first GT video per caption (metrics.py:61-80:
    only t2v_gts[i][0] is labeled relevant)."""
    gt = np.array([t2v_gts[i][0] for i in range(c2i.shape[0])])
    ranks = _ranks_of(c2i, gt)
    return float(np.mean(1.0 / (ranks + 1.0)))


def v2t_map(c2i: np.ndarray, v2t_gts: Sequence[List[int]]) -> float:
    """Mean AP over videos; all of the video's captions are relevant
    (metrics.py:84-102)."""
    aps = []
    for i in range(c2i.shape[1]):
        d_i = c2i[:, i]
        order = np.argsort(d_i, kind="stable")
        labels = np.zeros(len(d_i), dtype=bool)
        labels[v2t_gts[i]] = True
        sorted_hits = labels[order]
        nr_rel = int(sorted_hits.sum())
        if nr_rel == 0:
            aps.append(0.0)
            continue
        pos = np.nonzero(sorted_hits)[0]
        prec = np.arange(1, len(pos) + 1, dtype=np.float64) / (pos + 1.0)
        aps.append(float(prec.sum() / nr_rel))
    return float(np.mean(aps))


def eval_q2m(scores: np.ndarray, q2m_gts: Dict[int, List[int]]
             ) -> Tuple[float, float, float, float, float]:
    """(r1, r5, r10, medr, meanr) with 1-based min-rank over multiple GTs."""
    n_q, n_m = scores.shape
    inv = _inverse_perm(scores)
    gt_ranks = np.empty(n_q, dtype=np.int64)
    for i in range(n_q):
        gts = q2m_gts[i]
        # a query with no ground truth ranks past the gallery
        # (the reference leaves rank = n_m + 1 and continues)
        gt_ranks[i] = inv[i, gts].min() + 1 if len(gts) else n_m + 1
    r1 = 100.0 * np.mean(gt_ranks <= 1)
    r5 = 100.0 * np.mean(gt_ranks <= 5)
    r10 = 100.0 * np.mean(gt_ranks <= 10)
    return (float(r1), float(r5), float(r10),
            float(np.median(gt_ranks)), float(gt_ranks.mean()))


def cal_perf(t2v_all_errors: np.ndarray, v2t_gt: Sequence[List[int]],
             t2v_gt: Dict[int, List[int]], tb_logger=None, model=None
             ) -> Tuple[Tuple[float, ...], Tuple[float, ...], float, float]:
    """Full validation report like LINAS validate.py:15-54: R@K both
    directions + mAP both directions, on an error (lower-better) matrix."""
    t2v_r = eval_q2m(t2v_all_errors, t2v_gt)
    v2t_r = eval_q2m(t2v_all_errors.T, {i: g for i, g in enumerate(v2t_gt)})
    t2v_map_score = t2v_map(t2v_all_errors, t2v_gt)
    v2t_map_score = v2t_map(t2v_all_errors, list(v2t_gt))
    return t2v_r, v2t_r, t2v_map_score, v2t_map_score


def recall_at_k_from_labels(sorted_label_matrix: np.ndarray,
                            ks: Sequence[int] = (1, 5, 10, 50)) -> List[float]:
    """MultiFusion-style recall: fraction of queries whose GT appears in the
    top-k of the (already reference-masked) sorted label matrix
    (MultiFusion/src/validate.py:135-138)."""
    out = []
    for k in ks:
        out.append(float(np.mean(np.any(sorted_label_matrix[:, :k], axis=1)) * 100.0))
    return out

"""Object-detection evaluation: IoU matching + COCO-style mAP.

A numpy copy of cross_modal_video_engine_tpu/metrics/detection.py, the
yolov5 val.py metric stack (MCT/yolov5/val.py:72-100 `process_batch`,
utils/metrics.py:31-127 `ap_per_class`/`compute_ap`): predictions are
greedily matched to labels per IoU threshold (each label and each
prediction usable once, highest IoU first, classes must agree), true
positives accumulate down the confidence-sorted list into per-class
precision/recall curves, and AP integrates the 101-point COCO
interpolation of the precision envelope.  Host bookkeeping: the
detector's forward (models/yolo.py) is the device path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_IOUS = np.linspace(0.5, 0.95, 10)
# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes: (N, 4) x (M, 4) -> (N, M)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-7)


def mask_iou(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU of flattened binary masks: (N, HW) x (M, HW) -> (N, M)
    (utils/segment/general.py mask_iou :121-131)."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None] - inter
    return inter / (union + eps)


def match_predictions(pred_boxes: np.ndarray, pred_classes: np.ndarray,
                      gt_boxes: np.ndarray, gt_classes: np.ndarray,
                      iou_thresholds: np.ndarray = DEFAULT_IOUS,
                      pred_masks: np.ndarray = None,
                      gt_masks: np.ndarray = None) -> np.ndarray:
    """(N_pred, T) bool: prediction i is a true positive at threshold t.

    Greedy one-to-one assignment per threshold, highest IoU first, class
    must match (val.py:72-100).  Predictions should already be NMS'd and
    confidence-sorted by the caller (ap_per_class re-sorts anyway).
    With pred_masks/gt_masks given ((N|M, H, W) binary), the match runs
    on mask IoU instead of box IoU (segment/val.py process_batch
    :91-111, masks=True).
    """
    n, t = len(pred_boxes), len(iou_thresholds)
    correct = np.zeros((n, t), bool)
    if n == 0 or len(gt_boxes) == 0:
        return correct
    if pred_masks is not None:
        pred_masks = np.asarray(pred_masks)
        gt_masks = np.asarray(gt_masks)
        # a silently mismatched mask list would broadcast-crash (or
        # index out of bounds) deep in the sweep — fail with the cause
        if len(pred_masks) != n or len(gt_masks) != len(gt_boxes):
            raise ValueError(
                f"masks/boxes length mismatch: {len(pred_masks)} pred "
                f"masks for {n} boxes, {len(gt_masks)} gt masks for "
                f"{len(gt_boxes)} gt boxes")
        iou = mask_iou(gt_masks, pred_masks)
    else:
        iou = box_iou(np.asarray(gt_boxes), np.asarray(pred_boxes))
    same = (np.asarray(gt_classes)[:, None]
            == np.asarray(pred_classes)[None, :])
    iou = np.where(same, iou, 0.0)
    for ti, thr in enumerate(iou_thresholds):
        cand = np.argwhere(iou >= thr)
        if cand.size == 0:
            continue
        vals = iou[cand[:, 0], cand[:, 1]]
        order = np.argsort(-vals)
        used_gt, used_pred = set(), set()
        for gi, pi in cand[order]:
            if gi in used_gt or pi in used_pred:
                continue
            used_gt.add(gi)
            used_pred.add(pi)
            correct[pi, ti] = True
    return correct


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point COCO interpolation of the precision envelope
    (utils/metrics.py:98-127)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(_trapezoid(np.interp(x, mrec, mpre), x))


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, eps: float = 1e-16
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class AP over each IoU level (utils/metrics.py:31-96).

    Returns (classes, ap[C, T], precision[C], recall[C]) where
    precision/recall are read at the confidence that maximises the
    mean F1 across classes — the same operating point yolov5's
    val.py summary row reports (its curves are interpolated onto a
    1000-point confidence grid and ``f1.mean(0).argmax()`` picks the
    column; we skip yolov5's box-filter smoothing of the mean-F1
    curve, which only dithers the chosen column).
    """
    order = np.argsort(-np.asarray(conf))
    conf = np.asarray(conf, np.float64)[order]
    tp = np.asarray(tp, np.float64)[order]
    pred_cls = np.asarray(pred_cls)[order]
    classes, n_labels = np.unique(np.asarray(target_cls), return_counts=True)
    ap = np.zeros((len(classes), tp.shape[1]))
    px = np.linspace(0, 1, 1000)
    p_curve = np.zeros((len(classes), px.size))
    r_curve = np.zeros((len(classes), px.size))
    for ci, c in enumerate(classes):
        sel = pred_cls == c
        if not sel.any() or n_labels[ci] == 0:
            continue
        tpc = tp[sel].cumsum(0)
        fpc = (1 - tp[sel]).cumsum(0)
        recall = tpc / (n_labels[ci] + eps)
        precision = tpc / np.maximum(tpc + fpc, eps)
        for t in range(tp.shape[1]):
            ap[ci, t] = average_precision(recall[:, t], precision[:, t])
        # negated xs because np.interp needs increasing xs while conf
        # is sorted decreasing (yolov5 utils/metrics.py:52-54)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
    f1 = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    best = int(f1.mean(0).argmax())
    return classes.astype(int), ap, p_curve[:, best], r_curve[:, best]


def _summary_row(tps: Sequence[np.ndarray], confs: Sequence[np.ndarray],
                 pred_clss: Sequence[np.ndarray],
                 gt_clss: Sequence[np.ndarray],
                 iou_thresholds: np.ndarray) -> Dict:
    """Concatenate per-image sweep results and produce the val.py
    summary dict (shared by detection_map and both segmentation_map
    branches)."""
    tp = np.concatenate(tps) if tps else np.zeros((0, len(iou_thresholds)))
    conf = np.concatenate(confs) if confs else np.zeros(0)
    pred_cls = np.concatenate(pred_clss) if pred_clss else np.zeros(0)
    gt_cls = np.concatenate(gt_clss) if gt_clss else np.zeros(0)
    if gt_cls.size == 0:
        return dict(map50=0.0, map=0.0, ap_per_class={},
                    precision=0.0, recall=0.0)
    classes, ap, prec, rec = ap_per_class(tp, conf, pred_cls, gt_cls)
    return dict(
        map50=float(ap[:, 0].mean()) if ap.size else 0.0,
        map=float(ap.mean()) if ap.size else 0.0,
        ap_per_class={int(c): float(ap[i, 0]) for i, c in enumerate(classes)},
        precision=float(prec.mean()) if prec.size else 0.0,
        recall=float(rec.mean()) if rec.size else 0.0,
    )


def detection_map(predictions: Sequence[Dict], ground_truths: Sequence[Dict],
                  iou_thresholds: np.ndarray = DEFAULT_IOUS) -> Dict:
    """Corpus-level detection eval.

    Per image, `predictions[i]` has 'boxes' (N, 4 xyxy), 'scores' (N,),
    'classes' (N,); `ground_truths[i]` has 'boxes' (M, 4), 'classes' (M,).
    Returns {'map50', 'map', 'ap_per_class' {cls: ap50}, 'precision',
    'recall'} — the val.py summary row.
    """
    all_tp: List[np.ndarray] = []
    all_conf: List[np.ndarray] = []
    all_pred_cls: List[np.ndarray] = []
    all_gt_cls: List[np.ndarray] = []
    for pred, gt in zip(predictions, ground_truths):
        boxes = np.asarray(pred.get("boxes", np.zeros((0, 4))))
        all_tp.append(match_predictions(
            boxes, np.asarray(pred.get("classes", [])),
            np.asarray(gt.get("boxes", np.zeros((0, 4)))),
            np.asarray(gt.get("classes", [])), iou_thresholds))
        all_conf.append(np.asarray(pred.get("scores", np.ones(len(boxes)))))
        all_pred_cls.append(np.asarray(pred.get("classes", [])))
        all_gt_cls.append(np.asarray(gt.get("classes", [])))
    return _summary_row(all_tp, all_conf, all_pred_cls, all_gt_cls,
                        iou_thresholds)


def segmentation_map(predictions: Sequence[Dict],
                     ground_truths: Sequence[Dict],
                     iou_thresholds: np.ndarray = DEFAULT_IOUS) -> Dict:
    """Instance-segmentation eval: box AND mask mAP from one sweep
    (segment/val.py :288-310 + segment/metrics.py
    ap_per_class_box_and_mask :17-63).

    Per image, `predictions[i]` adds 'masks' (N, H, W) binary to the
    detection_map schema; `ground_truths[i]` adds 'masks' (M, H, W).
    Returns {'boxes': {...}, 'masks': {...}} with the detection_map
    summary dict in each branch.
    """
    tp_b: List[np.ndarray] = []
    tp_m: List[np.ndarray] = []
    all_conf: List[np.ndarray] = []
    all_pred_cls: List[np.ndarray] = []
    all_gt_cls: List[np.ndarray] = []
    for pred, gt in zip(predictions, ground_truths):
        boxes = np.asarray(pred.get("boxes", np.zeros((0, 4))))
        pc = np.asarray(pred.get("classes", []))
        gb = np.asarray(gt.get("boxes", np.zeros((0, 4))))
        gc = np.asarray(gt.get("classes", []))
        tp_b.append(match_predictions(boxes, pc, gb, gc, iou_thresholds))
        tp_m.append(match_predictions(
            boxes, pc, gb, gc, iou_thresholds,
            pred_masks=pred.get("masks", np.zeros((0, 1, 1))),
            gt_masks=gt.get("masks", np.zeros((0, 1, 1)))))
        all_conf.append(np.asarray(pred.get("scores", np.ones(len(boxes)))))
        all_pred_cls.append(pc)
        all_gt_cls.append(gc)

    def _summary(tps):
        return _summary_row(tps, all_conf, all_pred_cls, all_gt_cls,
                            iou_thresholds)

    return {"boxes": _summary(tp_b), "masks": _summary(tp_m)}

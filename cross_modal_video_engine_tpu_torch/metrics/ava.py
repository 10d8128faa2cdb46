"""AVA-protocol spatio-temporal detection evaluation (frame-mAP@0.5),
numpy only.

Counterpart of cross_modal_video_engine_tpu/metrics/ava.py, function for
function: the reference's AVA eval stack
(MCT/mmaction/core/evaluation/ava_utils.py:37-240: results2csv /
read_csv / read_labelmap / read_exclusions / ava_eval) and the vendored
TF object-detection Pascal evaluator it drives, with the same protocol:

* image key = ``f"{video_id},{int(timestamp):04d}"``;
* CSV rows are ``video,timestamp,x1,y1,x2,y2,action_id[,score]``; boxes
  are stored internally as [y1, x1, y2, x2] and each image's detections
  are sorted by descending score; `results2csv` prints floats as %.3f, so
  both packages write the same bytes;
* per image and class a detection matches its argmax-IoU ground-truth
  box and is a true positive iff that IoU >= 0.5 and the box was not yet
  detected: argmax matching, not greedy (a lower-scored detection does
  NOT fall back to the second-best box);
* per class, the VOC "all points" AP over the descending-score sweep
  against the class's total GT count; classes with no GT are skipped;
  frame-mAP is the mean over the rest;
* ``custom_classes`` whitelisting as ava_eval does it;
* the excluded-timestamp list applies unconditionally (the reference
  applies it only when ``verbose``, its default).
"""

from __future__ import annotations

import csv
from collections import defaultdict
from typing import Dict, IO, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = [
    "make_image_key", "read_csv", "read_labelmap", "read_exclusions",
    "results2csv", "det2csv", "ava_frame_map", "ava_eval",
]


def make_image_key(video_id: str, timestamp) -> str:
    """ava_utils.py:57-59 (int(float(..)) so csv strings and fractional
    test timestamps both key on the whole second)."""
    return f"{video_id},{int(float(timestamp)):04d}"


def read_csv(csv_file: IO, class_whitelist: Optional[Set[int]] = None
             ) -> Tuple[Dict, Dict, Dict]:
    """AVA-format CSV -> ({key: [[y1,x1,y2,x2],..]}, {key: [label,..]},
    {key: [score,..]}), rows per key sorted by descending score
    (ava_utils.py:62-109)."""
    entries = defaultdict(list)
    for row in csv.reader(csv_file):
        if not row:
            continue
        assert len(row) in (7, 8), f"Wrong number of columns: {row}"
        key = make_image_key(row[0], row[1])
        x1, y1, x2, y2 = (float(v) for v in row[2:6])
        action_id = int(row[6])
        if class_whitelist and action_id not in class_whitelist:
            continue
        score = float(row[7]) if len(row) == 8 else 1.0
        entries[key].append((score, action_id, y1, x1, y2, x2))
    boxes: Dict[str, List] = {}
    labels: Dict[str, List] = {}
    scores: Dict[str, List] = {}
    for key, entry in entries.items():
        entry.sort(key=lambda t: -t[0])
        boxes[key] = [list(e[2:]) for e in entry]
        labels[key] = [e[1] for e in entry]
        scores[key] = [e[0] for e in entry]
    return boxes, labels, scores


def read_exclusions(exclusions_file: Optional[IO]) -> Set[str]:
    """csv of video_id,timestamp -> set of image keys
    (ava_utils.py:111-130)."""
    excluded: Set[str] = set()
    if exclusions_file:
        for row in csv.reader(exclusions_file):
            assert len(row) == 2, f"Expected only 2 columns, got: {row}"
            excluded.add(make_image_key(row[0], row[1]))
    return excluded


def read_labelmap(labelmap_file: IO) -> Tuple[List[Dict], Set[int]]:
    """pbtxt label map (no protobuf dependency) -> ([{id, name}], ids)
    (ava_utils.py:133-155)."""
    labelmap: List[Dict] = []
    class_ids: Set[int] = set()
    name = ""
    for line in labelmap_file:
        if line.startswith("  name:"):
            name = line.split('"')[1]
        elif line.startswith("  id:") or line.startswith("  label_id:"):
            class_id = int(line.strip().split(" ")[-1])
            labelmap.append({"id": class_id, "name": name})
            class_ids.add(class_id)
    return labelmap, class_ids


def det2csv(dataset, results: Sequence[List[np.ndarray]],
            custom_classes: Optional[Sequence[int]] = None) -> List[Tuple]:
    """Per-dataset-index, per-class box lists -> flat csv tuples
    (ava_utils.py:16-33).  ``results[idx][label]`` is an (n, 5+) array
    of [x1, y1, x2, y2, score, ...]; label 0 here means action id 1
    (class 0 is reserved)."""
    csv_results: List[Tuple] = []
    for idx in range(len(dataset)):
        info = dataset[idx]
        video_id = info.get("video_id") or info.get("filename")
        timestamp = info["timestamp"]
        for label, bboxes in enumerate(results[idx]):
            arr = np.asarray(bboxes, dtype=float)
            if arr.size == 0:
                continue
            if arr.ndim == 1:
                arr = arr[None]
            for bbox in arr:
                bbox_ = tuple(float(v) for v in bbox)
                actual = (custom_classes[label + 1] if custom_classes
                          is not None else label + 1)
                csv_results.append((video_id, timestamp) + bbox_[:4]
                                   + (actual,) + bbox_[4:])
    return csv_results


def results2csv(dataset, results, out_file: str,
                custom_classes: Optional[Sequence[int]] = None) -> None:
    """ava_utils.py:36-49 (floats printed %.3f)."""
    csv_results = det2csv(dataset, results, custom_classes)

    def to_str(item):
        if isinstance(item, float):
            return f"{item:.3f}"
        return str(item)

    with open(out_file, "w") as f:
        for row in csv_results:
            f.write(",".join(map(to_str, row)))
            f.write("\n")


def _box_iou(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [y1,x1,y2,x2] boxes (np_box_ops.py:iou — plain
    areas, no +1)."""
    area_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    yy1 = np.maximum(det[:, None, 0], gt[None, :, 0])
    xx1 = np.maximum(det[:, None, 1], gt[None, :, 1])
    yy2 = np.minimum(det[:, None, 2], gt[None, :, 2])
    xx2 = np.minimum(det[:, None, 3], gt[None, :, 3])
    inter = (np.clip(yy2 - yy1, 0, None) * np.clip(xx2 - xx1, 0, None))
    union = area_d[:, None] + area_g[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def _tp_fp_single(det_boxes: np.ndarray, gt_boxes: np.ndarray,
                  iou_thr: float) -> np.ndarray:
    """per_image_evaluation.py:258-268: detections (already score-desc)
    each match their argmax-IoU GT; TP iff IoU >= thr and GT unseen."""
    n = len(det_boxes)
    tp = np.zeros(n, dtype=bool)
    if n == 0 or len(gt_boxes) == 0:
        return tp
    iou = _box_iou(det_boxes, gt_boxes)
    best = np.argmax(iou, axis=1)
    seen = np.zeros(len(gt_boxes), dtype=bool)
    for i in range(n):
        g = best[i]
        if iou[i, g] >= iou_thr and not seen[g]:
            tp[i] = True
            seen[g] = True
    return tp


def _voc_average_precision(precision: np.ndarray, recall: np.ndarray
                           ) -> float:
    """metrics.py:69-117: all-points VOC AP with monotone envelope."""
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    precision = np.flip(np.maximum.accumulate(np.flip(precision)))
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def ava_frame_map(gt_boxes: Dict[str, Sequence], gt_labels: Dict[str, Sequence],
                  det_boxes: Dict[str, Sequence],
                  det_labels: Dict[str, Sequence],
                  det_scores: Dict[str, Sequence],
                  class_ids: Iterable[int],
                  iou_thr: float = 0.5,
                  categories: Optional[List[Dict]] = None) -> Dict[str, float]:
    """In-memory Pascal frame-mAP over image-keyed box dicts.

    Equivalent to PascalDetectionEvaluator.add_*/evaluate()
    (object_detection_evaluation.py:324-574): per-class accumulation
    across images, classes with zero GT skipped, mAP = nanmean.
    Returns the reference's metric-name scheme:
    ``PascalBoxes_Precision/mAP@0.5IOU`` plus per-category
    ``PascalBoxes_PerformanceByCategory/AP@0.5IOU/<name>``.
    """
    names = {c["id"]: c["name"] for c in (categories or [])}
    per_class_scores: Dict[int, List[np.ndarray]] = defaultdict(list)
    per_class_tp: Dict[int, List[np.ndarray]] = defaultdict(list)
    num_gt: Dict[int, int] = defaultdict(int)

    for key, labels in gt_labels.items():
        for lb in labels:
            num_gt[int(lb)] += 1

    all_keys = set(det_boxes) | set(gt_boxes)
    for key in all_keys:
        dboxes = np.asarray(det_boxes.get(key, []), float).reshape(-1, 4)
        dlabels = np.asarray(det_labels.get(key, []), int).reshape(-1)
        dscores = np.asarray(det_scores.get(key, []), float).reshape(-1)
        gboxes = np.asarray(gt_boxes.get(key, []), float).reshape(-1, 4)
        glabels = np.asarray(gt_labels.get(key, []), int).reshape(-1)
        for c in np.unique(dlabels):
            sel = dlabels == c
            # rows are already score-desc per key from read_csv; sort
            # anyway so in-memory callers need not pre-sort
            order = np.argsort(-dscores[sel], kind="stable")
            db = dboxes[sel][order]
            tp = _tp_fp_single(db, gboxes[glabels == c], iou_thr)
            per_class_scores[int(c)].append(dscores[sel][order])
            per_class_tp[int(c)].append(tp)

    metrics: Dict[str, float] = {}
    aps: List[float] = []
    suffix = f"@{iou_thr}IOU"
    for c in sorted(set(int(c) for c in class_ids)):
        if num_gt[c] == 0:
            continue
        if per_class_scores[c]:
            scores = np.concatenate(per_class_scores[c])
            tp = np.concatenate(per_class_tp[c]).astype(float)
        else:
            scores = np.zeros(0)
            tp = np.zeros(0)
        order = np.argsort(-scores, kind="stable")
        cum_tp = np.cumsum(tp[order])
        cum_fp = np.cumsum(1.0 - tp[order])
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
        recall = cum_tp / num_gt[c]
        ap = _voc_average_precision(precision, recall) if scores.size else 0.0
        aps.append(ap)
        name = names.get(c, str(c))
        metrics[
            f"PascalBoxes_PerformanceByCategory/AP{suffix}/{name}"] = ap
    metrics[f"PascalBoxes_Precision/mAP{suffix}"] = (
        float(np.mean(aps)) if aps else float("nan"))
    return metrics


def ava_eval(result_file: str, result_type: str, label_file: str,
             ann_file: str, exclude_file: Optional[str] = None,
             verbose: bool = True,
             custom_classes: Optional[Sequence[int]] = None
             ) -> Dict[str, float]:
    """File-level entry matching the reference signature
    (ava_utils.py:159-240); returns only the non-ByCategory metrics,
    like the reference's final dict comprehension (:236-240)."""
    assert result_type == "mAP"
    with open(label_file) as f:
        categories, class_whitelist = read_labelmap(f)
    if custom_classes is not None:
        custom = list(custom_classes)[1:]
        assert set(custom).issubset(class_whitelist)
        class_whitelist = set(custom)
        categories = [c for c in categories if c["id"] in class_whitelist]

    with open(ann_file) as f:
        gt_boxes, gt_labels, _ = read_csv(f, class_whitelist)
    excluded = set()
    if exclude_file is not None:
        with open(exclude_file) as f:
            excluded = read_exclusions(f)
    with open(result_file) as f:
        boxes, labels, scores = read_csv(f, class_whitelist)

    for key in excluded:
        gt_boxes.pop(key, None)
        gt_labels.pop(key, None)
        boxes.pop(key, None)
        labels.pop(key, None)
        scores.pop(key, None)

    metrics = ava_frame_map(gt_boxes, gt_labels, boxes, labels, scores,
                            class_whitelist, categories=categories)
    if verbose:
        for k, v in metrics.items():
            print(f"{k}=\t{v}")
    return {k: v for k, v in metrics.items() if "ByCategory" not in k}

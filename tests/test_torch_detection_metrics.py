"""The port's detection metrics (metrics/detection.py) and the validation
path's host geometry (train/yolo_trainer.letterbox, data/yolo_aug.py,
cli/yolo_train.rasterize_segments and upsample_gt_masks) against the JAX
package and cv2 on the CPU.

Tolerances: none.  The metrics equal the JAX package's on seeded
predictions; the letterbox is bit-equal to the JAX package's cv2
letterbox on 10 shapes; the polygon fill bit-equal to cv2.fillPoly on 50
seeded polygons (convex, concave and self-crossing, inside the image and
touching its far edge, as a letterboxed label's polygon lies); the GT
masks' upsample equal to cv2's float INTER_LINEAR after the 0.5
threshold."""

import cv2
import numpy as np
import pytest

from cross_modal_video_engine_tpu.data import yolo_aug as jaug
from cross_modal_video_engine_tpu.metrics import detection as jdet
from cross_modal_video_engine_tpu.train.yolo_trainer import (
    letterbox as jletterbox, letterbox_boxes as jletterbox_boxes)
from cross_modal_video_engine_tpu_torch.cli.yolo_train import (
    rasterize_segments, upsample_gt_masks)
from cross_modal_video_engine_tpu_torch.data import yolo_aug as taug
from cross_modal_video_engine_tpu_torch.metrics import detection as tdet
from cross_modal_video_engine_tpu_torch.train.yolo_trainer import (
    letterbox, letterbox_boxes)


def _corpus(seed, n_images=12, n_classes=4, masks=False):
    """Seeded predictions near seeded ground truths (some missed, some
    spurious, some of the wrong class)."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_images):
        m = int(rng.integers(0, 6))
        xy = rng.uniform(0, 50, (m, 2))
        gb = np.concatenate([xy, xy + rng.uniform(4, 20, (m, 2))], 1)
        gc = rng.integers(0, n_classes, m)
        keep = rng.random(m) > 0.2
        pb = gb[keep] + rng.normal(0, 1.5, (int(keep.sum()), 4))
        pc = np.where(rng.random(int(keep.sum())) > 0.1, gc[keep],
                      rng.integers(0, n_classes, int(keep.sum())))
        extra = int(rng.integers(0, 3))
        exy = rng.uniform(0, 50, (extra, 2))
        pb = np.concatenate([pb, np.concatenate(
            [exy, exy + rng.uniform(4, 20, (extra, 2))], 1)])
        pc = np.concatenate([pc, rng.integers(0, n_classes, extra)])
        p = dict(boxes=pb, scores=rng.random(len(pb)), classes=pc)
        g = dict(boxes=gb, classes=gc)
        if masks:
            g["masks"] = rng.random((m, 16, 16)) > 0.5
            p["masks"] = rng.random((len(pb), 16, 16)) > 0.5
        preds.append(p)
        gts.append(g)
    return preds, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_map_matches_jax(seed):
    preds, gts = _corpus(seed)
    assert tdet.detection_map(preds, gts) == jdet.detection_map(preds, gts)


def test_segmentation_map_matches_jax():
    preds, gts = _corpus(3, masks=True)
    assert tdet.segmentation_map(preds, gts) \
        == jdet.segmentation_map(preds, gts)


def test_box_and_mask_iou_match_jax():
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (7, 2))
    a = np.concatenate([xy, xy + rng.uniform(1, 30, (7, 2))], 1)
    b = a[::-1] + rng.normal(0, 3, a.shape)
    np.testing.assert_array_equal(tdet.box_iou(a, b), jdet.box_iou(a, b))
    ma, mb = rng.random((5, 9, 9)) > 0.5, rng.random((3, 9, 9)) > 0.5
    np.testing.assert_array_equal(tdet.mask_iou(ma, mb),
                                  jdet.mask_iou(ma, mb))


def test_match_predictions_and_ap_per_class_match_jax():
    preds, gts = _corpus(5)
    p, g = preds[0], gts[0]
    np.testing.assert_array_equal(
        tdet.match_predictions(p["boxes"], p["classes"], g["boxes"],
                               g["classes"]),
        jdet.match_predictions(p["boxes"], p["classes"], g["boxes"],
                               g["classes"]))
    rng = np.random.default_rng(6)
    tp = rng.random((40, 10)) > 0.4
    conf, pc = rng.random(40), rng.integers(0, 3, 40)
    tc = rng.integers(0, 3, 25)
    for got, want in zip(tdet.ap_per_class(tp, conf, pc, tc),
                         jdet.ap_per_class(tp, conf, pc, tc)):
        np.testing.assert_array_equal(got, want)


SHAPES = [(480, 640), (360, 480), (640, 640), (100, 37), (720, 1280),
          (33, 700), (640, 480), (500, 333), (257, 129), (64, 64)]


@pytest.mark.parametrize("hw", SHAPES)
def test_letterbox_is_bit_equal_to_the_cv2_letterbox(hw):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    boxes = np.concatenate([rng.integers(0, 5, (4, 1)),
                            rng.uniform(0.2, 0.8, (4, 2)),
                            rng.uniform(0.05, 0.3, (4, 2))], 1)
    for new in (640, 128):
        got, r, pad = letterbox(img, new)
        want, rj, padj = jletterbox(img, new)
        np.testing.assert_array_equal(got, want)
        assert (r, pad) == (rj, padj)
        np.testing.assert_array_equal(
            letterbox_boxes(boxes, r, pad, hw, new),
            jletterbox_boxes(boxes, rj, padj, hw, new))


def test_box_helpers_match_jax():
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (6, 4))
    np.testing.assert_array_equal(taug.xywhn2xyxy(x, 64, 48, 3, 5),
                                  jaug.xywhn2xyxy(x, 64, 48, 3, 5))
    xyxy = rng.uniform(-5, 70, (6, 4))
    np.testing.assert_array_equal(taug.xyxy2xywhn(xyxy, 64, 48),
                                  jaug.xyxy2xywhn(xyxy, 64, 48))
    segs = [(float(c), rng.uniform(0, 1, (5, 2)).astype(np.float32))
            for c in range(3)]
    np.testing.assert_array_equal(taug.segments2boxes(segs),
                                  jaug.segments2boxes(segs))


def _polygons(seed=21, n=50):
    """(size, int32 points): convex, concave (star-like) and random
    self-crossing polygons inside [0, size], some touching the far edge."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        size = int(rng.integers(24, 96))
        k = int(rng.integers(3, 13))
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        if t % 3 == 0:
            r = rng.uniform(0.2, 0.5) * size
        elif t % 3 == 1:
            r = rng.uniform(0.05, 0.5, k) * size
        if t % 3 == 2:
            pts = rng.uniform(0, 1, (k, 2)) * size
        else:
            c = rng.uniform(0.3, 0.7, 2) * size
            pts = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                           1)
        pts = np.clip(np.round(pts), 0, size).astype(np.int32)
        out.append((size, pts))
    return out


def test_fill_poly_is_bit_equal_to_cv2():
    touching = 0
    for size, pts in _polygons():
        want = np.zeros((size, size), np.float32)
        cv2.fillPoly(want, [pts], 1.0)
        got = taug.fill_poly(np.zeros((size, size), np.float32), pts, 1.0)
        np.testing.assert_array_equal(got, want)
        touching += int(pts.max() == size)
    assert touching >= 5


def test_rasterize_segments_matches_the_cv2_path():
    polys = [p.astype(np.float32) * (64 / s) for s, p in _polygons(22, 8)]
    got = rasterize_segments(polys, 64, 4)
    want = np.zeros((len(polys), 64, 64), np.float32)
    for k, p in enumerate(polys):
        cv2.fillPoly(want[k], [np.round(p).astype(np.int32)], 1.0)
    np.testing.assert_array_equal(got, want[:, ::4, ::4])


@pytest.mark.parametrize("small,size", [(16, 64), (40, 160), (7, 30)])
def test_gt_mask_upsample_equals_cv2_after_the_threshold(small, size):
    rng = np.random.default_rng(small)
    masks = (rng.random((6, small, small)) > 0.6).astype(np.float32)
    want = np.stack([cv2.resize(m, (size, size),
                                interpolation=cv2.INTER_LINEAR)
                     for m in masks]) > 0.5
    np.testing.assert_array_equal(upsample_gt_masks(masks, size), want)

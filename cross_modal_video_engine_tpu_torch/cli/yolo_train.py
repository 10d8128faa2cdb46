"""The detector's validation half: datasets, batches, inference, mAP.

Counterpart of cross_modal_video_engine_tpu/cli/yolo_train.py up to its
trainer (MCT/yolov5/val.py and segment/val.py): yolov5-format directories
(images plus same-stem label files of normalized `cls cx cy w h` rows, or
`cls x1 y1 x2 y2 ...` polygons for the segment head), letterboxed
batches, the detector's inference (plain, scale/flip TTA, segment) built
once per model, and the COCO-protocol evaluation.  Images are `.npy`
arrays, read with numpy; other files go through `reader(path) -> (H, W,
3) uint8 RGB` (cv2's imread when no reader is given: the card's machine
has no cv2).  Training (`train_from_config`, `main`, the augmentations,
AutoAnchor) is ROADMAP.md queue 1 item 7b-ii.
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.pipelines import resize_linear
from ..data.yolo_aug import fill_poly, segments2boxes
from ..metrics.detection import detection_map, segmentation_map
from ..models.yolo import (TRAIN_ITEM, TTA_SCALES, YoloConfig, YoloV5,
                           clip_augmented, decode_predictions, descale_pred,
                           postprocess, postprocess_seg, scale_img)
from ..train.yolo_trainer import letterbox, letterbox_boxes


def _imread(path: str) -> np.ndarray:
    import cv2
    return cv2.imread(path)[:, :, ::-1]                  # BGR -> RGB


class YoloDetectionDataset:
    """yolov5 directory layout: image files (jpg/png/npy) + same-stem
    label txts of normalized ``cls cx cy w h`` rows."""

    def __init__(self, img_dir: str, label_dir: str,
                 reader: Optional[Callable[[str], np.ndarray]] = None):
        exts = ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.npy")
        self.images = sorted(p for e in exts
                             for p in glob.glob(os.path.join(img_dir, e)))
        if not self.images:
            raise FileNotFoundError(f"no images under {img_dir}")
        self.label_dir = label_dir
        self.reader = reader

    def __len__(self) -> int:
        return len(self.images)

    def _label_path(self, i: int) -> str:
        stem = os.path.splitext(os.path.basename(self.images[i]))[0]
        return os.path.join(self.label_dir, stem + ".txt")

    def labels(self, i: int) -> np.ndarray:
        lpath = self._label_path(i)
        boxes = np.zeros((0, 5), np.float32)
        if os.path.exists(lpath):
            rows = [ln.split() for ln in open(lpath) if ln.strip()]
            if rows:
                boxes = np.asarray(rows, np.float32)
        return boxes

    def image(self, i: int) -> np.ndarray:
        path = self.images[i]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            img = (self.reader or _imread)(path)
        return np.ascontiguousarray(img, np.uint8)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.image(i), self.labels(i)

    def shapes_and_labels(self):
        raise NotImplementedError(f"shapes_and_labels feeds AutoAnchor: "
                                  f"{TRAIN_ITEM}")


class YoloSegDataset(YoloDetectionDataset):
    """yolov5-seg labels: per-image rows ``cls x1 y1 x2 y2 ...``, one
    normalized polygon per instance; boxes from the polygons' extents."""

    def segments(self, i: int) -> List[Tuple[float, np.ndarray]]:
        lpath = self._label_path(i)
        out: List[Tuple[float, np.ndarray]] = []
        if os.path.exists(lpath):
            for ln in open(lpath):
                v = ln.split()
                if len(v) > 5:
                    out.append((float(v[0]),
                                np.asarray(v[1:], np.float32).reshape(-1, 2)))
        return out

    def labels(self, i: int) -> np.ndarray:
        return segments2boxes(self.segments(i))


def rasterize_segments(segments: List[np.ndarray], img_size: int,
                       ratio: int = 1) -> np.ndarray:
    """(n, H/ratio, W/ratio) float binary masks from pixel-space polygons:
    each filled at full resolution as cv2.fillPoly fills it (rounded to
    int32 points; data/yolo_aug.fill_poly), then nearest-downsampled by
    `ratio` (the reference's polygon2mask order)."""
    out = np.zeros((len(segments), img_size, img_size), np.float32)
    for k, pts in enumerate(segments):
        fill_poly(out[k], np.round(pts).astype(np.int32), 1.0)
    return out[:, ::ratio, ::ratio]


def _refuse_aug(aug) -> None:
    if aug is not None:
        raise NotImplementedError(f"the training augmentations: {TRAIN_ITEM}")


def _padded(order, batch_size: int):
    order = list(order)
    for i in range(0, len(order), batch_size):
        sel = order[i:i + batch_size]
        n = len(sel)
        yield sel + [sel[0]] * (batch_size - n), n


def yolo_seg_batches(ds: YoloSegDataset, batch_size: int, img_size: int,
                     max_targets: int, mask_ratio: int = 4, aug=None,
                     rng=None, order=None) -> Iterator:
    """(images (B, S, S, 3) f32 0-1, targets (B, T, 5), valid (B, T),
    gt_masks (B, T, S/r, S/r), n_real) of letterboxed images (the val
    path: `aug` raises).  The tail batch repeats its first image."""
    _refuse_aug(aug)
    mh = mw = img_size // mask_ratio
    for sel, n in _padded(order if order is not None else range(len(ds)),
                          batch_size):
        imgs, tgts, valids, masks = [], [], [], []
        for j in sel:
            img = ds.image(j)
            segs = ds.segments(j)
            hw = img.shape[:2]
            img, r, pad = letterbox(img, img_size)
            polys = [p * np.asarray([hw[1], hw[0]]) * r + np.asarray(pad)
                     for _, p in segs]
            boxes = segments2boxes(
                [(c, q / img_size) for (c, _), q in zip(segs, polys)])
            gm = rasterize_segments(polys, img_size, mask_ratio)
            t = np.zeros((max_targets, 5), np.float32)
            v = np.zeros((max_targets,), bool)
            m = np.zeros((max_targets, mh, mw), np.float32)
            k = min(len(boxes), max_targets)
            t[:k], v[:k], m[:k] = boxes[:k], True, gm[:k]
            imgs.append(img)
            tgts.append(t)
            valids.append(v)
            masks.append(m)
        yield (torch.from_numpy(np.stack(imgs)).float() / 255.0,
               torch.from_numpy(np.stack(tgts)),
               torch.from_numpy(np.stack(valids)),
               torch.from_numpy(np.stack(masks)), n)


def yolo_batches(ds: YoloDetectionDataset, batch_size: int, img_size: int,
                 max_targets: int, aug=None, rng=None,
                 order=None) -> Iterator:
    """(images (B, S, S, 3) f32 0-1, targets (B, T, 5), valid (B, T),
    n_real) of letterboxed images (the val path: `aug` raises)."""
    _refuse_aug(aug)
    for sel, n in _padded(order if order is not None else range(len(ds)),
                          batch_size):
        imgs, tgts, valids = [], [], []
        for j in sel:
            img, boxes = ds[j]
            hw = img.shape[:2]
            img, r, pad = letterbox(img, img_size)
            boxes = letterbox_boxes(boxes, r, pad, hw, img_size)
            t = np.zeros((max_targets, 5), np.float32)
            v = np.zeros((max_targets,), bool)
            k = min(len(boxes), max_targets)
            t[:k], v[:k] = boxes[:k], True
            imgs.append(img)
            tgts.append(t)
            valids.append(v)
        yield (torch.from_numpy(np.stack(imgs)).float() / 255.0,
               torch.from_numpy(np.stack(tgts)),
               torch.from_numpy(np.stack(valids)), n)


def yolo_config(cfg: Config) -> YoloConfig:
    """The YoloConfig a training config's `model` section names."""
    mcfg = dict(cfg.get("model", {}))
    mcfg.pop("type", None)
    anchors = mcfg.pop("anchors", None)
    kw = dict(num_classes=mcfg.get("num_classes", 80),
              depth_multiple=mcfg.get("depth_multiple", 0.33),
              width_multiple=mcfg.get("width_multiple", 0.50),
              img_size=mcfg.get("img_size", 640),
              masks=mcfg.get("masks", 0),
              protos=mcfg.get("protos", 0))
    if anchors is not None:
        kw["anchors"] = tuple(tuple(tuple(a) for a in layer)
                              for layer in anchors)
    return YoloConfig(**kw)


def build_yolo_model(cfg: Config, device=None) -> YoloV5:
    """The config's detector (zero weights until a state dict is loaded)
    on the card unless a device is named."""
    return YoloV5(yolo_config(cfg), device=device)


def _device(model) -> torch.device:
    return next(model.parameters()).device


@functools.lru_cache(maxsize=8)
def _det_infer(model: YoloV5):
    """images (B, H, W, 3) -> decoded predictions (B, N, 5+nc), on the
    model's device.  Built once per model, as the JAX package's jit is."""
    @torch.no_grad()
    def infer(images):
        return decode_predictions(model(images.to(_device(model))),
                                  model.cfg)
    return infer


@functools.lru_cache(maxsize=8)
def _det_infer_tta(model: YoloV5):
    """Scale/flip TTA (val.py --augment): three passes (1, flipped 0.83,
    0.67), each decoded on its own grid, de-scaled to the frame, the
    tails clipped, concatenated."""
    size = model.cfg.img_size

    @torch.no_grad()
    def infer(images):
        images = images.to(_device(model))
        ys = []
        for ratio, flip in TTA_SCALES:
            xi = images.flip(2) if flip == 3 else images
            yi = decode_predictions(model(scale_img(xi, ratio)), model.cfg)
            ys.append(descale_pred(yi, flip, ratio, (size, size)))
        return torch.cat(clip_augmented(ys), 1)
    return infer


@functools.lru_cache(maxsize=8)
def _seg_infer(model: YoloV5):
    @torch.no_grad()
    def infer(images):
        maps, proto = model(images.to(_device(model)))
        return decode_predictions(maps, model.cfg), proto
    return infer


def _gt_boxes(rows: np.ndarray, size: float) -> np.ndarray:
    xy, wh = rows[:, 1:3] * size, rows[:, 3:5] * size
    return np.concatenate([xy - wh / 2, xy + wh / 2], 1)


def evaluate_detector(model: YoloV5, batches: Iterator,
                      conf_thres: float = 0.001, iou_thres: float = 0.6,
                      augment: bool = False) -> Dict:
    """val.py: decode + NMS (multi-label, the val protocol), COCO mAP.
    augment=True runs the scale/flip TTA."""
    infer = _det_infer_tta(model) if augment else _det_infer(model)
    preds_all: List[Dict] = []
    gts_all: List[Dict] = []
    size = float(model.cfg.img_size)
    for images, targets, valid, n in batches:
        preds = infer(images).float().cpu().numpy()
        dets = postprocess(preds, conf_thres, iou_thres, multi_label=True)
        tn, vn = targets.numpy(), valid.numpy()
        for b in range(n):
            d = dets[b]
            preds_all.append(dict(boxes=d[:, :4], scores=d[:, 4],
                                  classes=d[:, 5].astype(int)))
            rows = tn[b][vn[b]]
            gts_all.append(dict(boxes=_gt_boxes(rows, size),
                                classes=rows[:, 0].astype(int)))
    return detection_map(preds_all, gts_all)


def upsample_gt_masks(masks: np.ndarray, size: int) -> np.ndarray:
    """(n, h, w) float masks -> (n, size, size) bool: bilinear as
    cv2.resize(INTER_LINEAR) computes float images (data/pipelines.
    resize_linear), then > 0.5 (segment/val.py's round trip)."""
    if not len(masks):
        return np.zeros((0, size, size), bool)
    up = resize_linear(np.ascontiguousarray(masks, np.float32)[..., None],
                       (size, size))
    return up[..., 0] > 0.5


def evaluate_segmenter(model: YoloV5, batches: Iterator,
                       conf_thres: float = 0.001, iou_thres: float = 0.6,
                       mask_ratio: int = 4) -> Dict:
    """segment/val.py: decode + seg NMS + process_mask, box AND mask
    mAP; the GT masks come at prototype resolution and are upsampled to
    the image (`upsample_gt_masks`)."""
    infer = _seg_infer(model)
    preds_all: List[Dict] = []
    gts_all: List[Dict] = []
    size = model.cfg.img_size
    for images, targets, valid, gt_masks, n in batches:
        preds, proto = infer(images)
        outs = postprocess_seg(preds.float().cpu().numpy(),
                               proto.float().cpu().numpy(), (size, size),
                               conf_thres, iou_thres, multi_label=True)
        tn, vn, gmn = targets.numpy(), valid.numpy(), gt_masks.numpy()
        for b in range(n):
            det, masks = outs[b]
            preds_all.append(dict(boxes=det[:, :4], scores=det[:, 4],
                                  classes=det[:, 5].astype(int),
                                  masks=masks))
            rows = tn[b][vn[b]]
            gts_all.append(dict(
                boxes=_gt_boxes(rows, size), classes=rows[:, 0].astype(int),
                masks=upsample_gt_masks(gmn[b][vn[b]], size)))
    return segmentation_map(preds_all, gts_all)


def train_from_config(*args, **kwargs):
    raise NotImplementedError(TRAIN_ITEM)


def main(argv=None):
    raise NotImplementedError(TRAIN_ITEM)


if __name__ == "__main__":
    main()

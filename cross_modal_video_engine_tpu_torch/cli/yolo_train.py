"""Config-driven YOLOv5 detector training CLI, and its validation half.

Counterpart of cross_modal_video_engine_tpu/cli/yolo_train.py
(MCT/yolov5/train.py, val.py and segment/train.py, segment/val.py):
yolov5-format directories (images plus same-stem label files of
normalized `cls cx cy w h` rows, or `cls x1 y1 x2 y2 ...` polygons for the
segment head), the training batches through the full augmentation
pipeline (data/yolo_aug.py: mosaic, mixup, perspective, HSV, flips) or
letterboxed for validation, AutoAnchor (utils/autoanchor.py), the
three-group SGD with warmup, EMA and the criterion
(train/yolo_trainer.py, losses/yolo.py), per-epoch validation of the EMA
weights with COCO-protocol mAP, `best/` by the fitness 0.1 * mAP50 +
0.9 * mAP (averaged over boxes and masks for the segment head) and
`epoch_{n}/` for resume.

    python -m cross_modal_video_engine_tpu_torch.cli.yolo_train CONFIG \\
        --work_dir work/yolo [--resume [PATH]] [--total_epochs N] \\
        [--device cpu]

Images are `.npy` arrays, read with numpy (their shapes from an mmap);
other files go through `reader(path) -> (H, W, 3) uint8 RGB` (cv2's
imread when no reader is given, PIL's header for the shapes AutoAnchor
reads: the card's machine has neither, so give it `.npy` images or a
reader).  `load_from` starts from a JAX-format checkpoint directory (a
`best/` directory or `save_checkpoint`'s).  The state starts from the
training init `models/yolo.init_state_dict` draws from `seed` (default
0): the same distributions as the JAX package's init, not the same
numbers.  A resumed run also restores the augmentation RandomState
(`aug_rng` in loop_state.json), so epoch n resumed from epoch_{n-1}/
equals the uninterrupted epoch; a state without it (the JAX package
writes none) restarts the RandomState at seed 0, as the JAX CLI does.
The f32 parts (the loss, the masters) run with TF32 off.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.datasets import ShardedSampler
from ..data.pipelines import resize_linear
from ..data.yolo_aug import (YoloAugHyp, augment_sample, augment_seg_sample,
                             fill_poly, segments2boxes)
from ..losses.yolo import YoloHyp
from ..metrics.detection import detection_map, segmentation_map
from ..models.yolo import (TTA_SCALES, YoloConfig, YoloV5, clip_augmented,
                           decode_predictions, descale_pred, postprocess,
                           postprocess_seg, scale_img)
from ..train.resume import (latest_checkpoint, load_train_state,
                            save_train_state)
from ..train.yolo_trainer import (YoloOptHyp, init_yolo_train_state,
                                  letterbox, letterbox_boxes, lr_momentum_at,
                                  make_yolo_train_step, scaled_weight_decay)
from ..utils.precision import no_tf32


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

    def shapes_and_labels(self) -> Tuple[np.ndarray, List[np.ndarray]]:
        """Per-image (h, w) and label rows without decoding pixels where
        the format allows (AutoAnchor reads the whole dataset): `.npy`
        shapes from an mmap, other files through the reader (decoded) or
        else PIL's header with the EXIF orientations 5-8 swapping w and h
        (cv2.imread applies every orientation)."""
        shapes, labels = [], []
        for i, path in enumerate(self.images):
            if path.endswith(".npy"):
                shapes.append(np.load(path, mmap_mode="r").shape[:2])
            elif self.reader is not None:
                shapes.append(self.reader(path).shape[:2])
            else:
                shapes.append(_header_hw(path))
            labels.append(self.labels(i))
        return np.asarray(shapes, np.float64), labels


def _header_hw(path: str) -> Tuple[int, int]:
    from PIL import Image
    with Image.open(path) as im:
        w, h = im.size
        try:
            rot = (im.getexif() or {}).get(274)           # Orientation
        except Exception:
            rot = None
        if rot in (5, 6, 7, 8):
            w, h = h, w
    return h, w


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


def _padded(order, batch_size: int):
    order = list(order)
    for i in range(0, len(order), batch_size):
        sel = order[i:i + batch_size]
        n = len(sel)
        yield sel + [sel[0]] * (batch_size - n), n


def yolo_seg_batches(ds: YoloSegDataset, batch_size: int, img_size: int,
                     max_targets: int, mask_ratio: int = 4,
                     aug: Optional[YoloAugHyp] = None,
                     rng: Optional[np.random.RandomState] = None,
                     order=None) -> Iterator:
    """(images (B, S, S, 3) f32 0-1, targets (B, T, 5), valid (B, T),
    gt_masks (B, T, S/r, S/r), n_real).  With `aug` and `rng` each sample
    runs augment_seg_sample (polygons ride the geometry, rasterized at
    S/mask_ratio); without, letterboxed (the val path).  The tail batch
    repeats its first image."""
    mh = mw = img_size // mask_ratio

    def load(j):
        return ds.image(j), ds.segments(j)

    for sel, n in _padded(order if order is not None else range(len(ds)),
                          batch_size):
        imgs, tgts, valids, masks = [], [], [], []
        for j in sel:
            if aug is not None and rng is not None:
                img, boxes, polys = augment_seg_sample(load, j, len(ds),
                                                       img_size, aug, rng)
            else:
                img = ds.image(j)
                segs = ds.segments(j)
                hw = img.shape[:2]
                img, r, pad = letterbox(img, img_size)
                polys = [p * np.asarray([hw[1], hw[0]]) * r
                         + np.asarray(pad) for _, p in segs]
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
                 max_targets: int, aug: Optional[YoloAugHyp] = None,
                 rng: Optional[np.random.RandomState] = None,
                 order=None) -> Iterator:
    """(images (B, S, S, 3) f32 0-1, targets (B, T, 5), valid (B, T),
    n_real).  With `aug` each sample runs augment_sample (mosaic, mixup,
    perspective, HSV, flips) drawing from `rng`; without, letterboxed
    (the val path)."""
    for sel, n in _padded(order if order is not None else range(len(ds)),
                          batch_size):
        imgs, tgts, valids = [], [], []
        for j in sel:
            if aug is not None:
                img, boxes = augment_sample(ds.__getitem__, j, len(ds),
                                            img_size, aug, rng)
            else:
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


def _anchors_json(cfg: YoloConfig):
    return [list(map(list, layer)) for layer in cfg.anchors]


def _rng_json(rng: np.random.RandomState) -> list:
    name, keys, pos, has_gauss, gauss = rng.get_state()
    return [name, keys.tolist(), pos, has_gauss, gauss]


def _rng_from_json(state: Optional[list]) -> np.random.RandomState:
    rng = np.random.RandomState(0)
    if state:
        name, keys, pos, has_gauss, gauss = state
        rng.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss,
                       gauss))
    return rng


def train_from_config(cfg: Config, work_dir: str,
                      resume: Optional[str] = None,
                      num_epochs: Optional[int] = None, device=None,
                      reader: Optional[Callable[[str], np.ndarray]] = None,
                      seed: int = 0, on_step: Optional[Callable] = None):
    """Train the config's detector (or segmenter) on `device` (None: the
    CUDA device).  Returns (state, history): one record per epoch with
    the mean loss and, on evaluation epochs, the EMA weights' mAP.
    `on_step(epoch, bi, state, logs, seconds)` is called after each step
    (timing and tracing hooks; `seconds` is the step's host time, the
    batch's assembly excluded)."""
    no_tf32()
    model = build_yolo_model(cfg, device=device)
    dev = next(model.parameters()).device
    seg = model.cfg.masks > 0
    img_size = model.cfg.img_size
    bs = cfg.get("data.batch_size", 16)
    max_t = cfg.get("data.max_targets", 64)
    mask_ratio = cfg.get("data.mask_ratio", 4)
    aug = YoloAugHyp(**cfg.get("aug", {}))

    ds_cls = YoloSegDataset if seg else YoloDetectionDataset
    train_ds = ds_cls(cfg["data.train.img_dir"], cfg["data.train.label_dir"],
                      reader=reader)
    val_ds = None
    if cfg.get("data.val"):
        val_ds = ds_cls(cfg["data.val.img_dir"], cfg["data.val.label_dir"],
                        reader=reader)

    hyp = YoloHyp(**cfg.get("loss", {}))
    opt = YoloOptHyp(**cfg.get("optimizer", {}))

    if cfg.get("autoanchor", True) and not resume:
        # train.py's AutoAnchor pass (on by default in the reference)
        from ..utils.autoanchor import check_anchors
        shapes, labs = train_ds.shapes_and_labels()
        new_anchors, bpr, changed = check_anchors(
            shapes, labs, model.cfg.anchors, thr=hyp.anchor_t,
            img_size=img_size, gen=cfg.get("autoanchor_gen", 1000))
        if changed:
            print(json.dumps({"autoanchor": [list(map(list, l))
                                             for l in new_anchors],
                              "bpr": bpr}))
            model = YoloV5(dataclasses.replace(model.cfg,
                                               anchors=new_anchors),
                           device=dev)

    wd = scaled_weight_decay(opt, bs)
    start = None
    load_from = cfg.get("load_from")
    if load_from and not resume:
        # train.py `--weights`: a best/ or save_checkpoint directory
        from .yolo_val import load_detector_weights
        start = load_detector_weights(model, load_from)
    state = init_yolo_train_state(model, seed=seed, state_dict=start)
    step = make_yolo_train_step(model, hyp, opt, wd,
                                bf16=cfg.get("bf16", False),
                                mask_cap=cfg.get("loss_mask_cap", 128),
                                device=dev)

    start_epoch, best = 0, -1.0
    aug_rng = np.random.RandomState(0)
    if resume:
        payload, loop = load_train_state(resume, {"state": state})
        state = payload["state"]
        start_epoch = int(loop.get("epoch", -1)) + 1
        # the best fitness so far: a post-resume eval can't overwrite
        # work_dir/best with a worse score
        best = float(loop.get("best", -1.0))
        aug_rng = _rng_from_json(loop.get("aug_rng"))

    epochs = num_epochs or cfg.get("total_epochs", 300)
    eval_interval = cfg.get("eval_interval", 1)
    nb = max(1, (len(train_ds) + bs - 1) // bs)
    sampler = ShardedSampler(len(train_ds), shuffle=True)
    history: List[Dict] = []
    for epoch in range(start_epoch, epochs):
        losses = []
        if seg:
            batches = yolo_seg_batches(train_ds, bs, img_size, max_t,
                                       mask_ratio, aug, aug_rng,
                                       sampler.indices(epoch))
        else:
            batches = yolo_batches(train_ds, bs, img_size, max_t, aug,
                                   aug_rng, sampler.indices(epoch))
        for bi, (images, targets, valid, *rest) in enumerate(batches):
            t0 = time.perf_counter()
            gt_masks = rest[0].to(dev) if seg else None
            ni = bi + nb * epoch
            lr_b, lr_r, mom = lr_momentum_at(ni, epoch, nb, epochs, opt)
            state, logs = step(state, images.to(dev), targets.to(dev),
                               valid.to(dev), lr_b, lr_r, mom,
                               gt_masks=gt_masks)
            losses.append(float(logs["loss"]))
            if on_step is not None:
                on_step(epoch, bi, state, logs, time.perf_counter() - t0)
        rec = {"epoch": epoch, "loss": float(np.mean(losses))}
        if val_ds is not None and (epoch + 1) % eval_interval == 0:
            ema = state.ema
            if seg:
                report = evaluate_segmenter(
                    ema, yolo_seg_batches(val_ds, bs, img_size, max_t,
                                          mask_ratio),
                    mask_ratio=mask_ratio)
                rec["map50"] = report["boxes"]["map50"]
                rec["map"] = report["boxes"]["map"]
                rec["mask_map50"] = report["masks"]["map50"]
                rec["mask_map"] = report["masks"]["map"]
                # segment/train.py: the fitness over boxes and masks
                score = float(np.mean(
                    [0.1 * report[k]["map50"] + 0.9 * report[k]["map"]
                     for k in ("boxes", "masks")]))
            else:
                report = evaluate_detector(
                    ema, yolo_batches(val_ds, bs, img_size, max_t))
                rec["map50"] = report["map50"]
                rec["map"] = report["map"]
                # train.py fitness: 0.1 * mAP@0.5 + 0.9 * mAP@0.5:0.95
                score = 0.1 * report["map50"] + 0.9 * report["map"]
            if score > best:
                best = score
                save_train_state(os.path.join(work_dir, "best"),
                                 {"detector": ema},
                                 {"epoch": epoch, "fitness": best,
                                  "model": dict(cfg.get("model", {})),
                                  "anchors": _anchors_json(model.cfg)})
        save_train_state(os.path.join(work_dir, f"epoch_{epoch}"),
                         {"state": state},
                         {"epoch": epoch, "best": best,
                          "anchors": _anchors_json(model.cfg),
                          "aug_rng": _rng_json(aug_rng)})
        history.append(rec)
        print(json.dumps(rec))
    return state, history


def main(argv=None, reader: Optional[Callable[[str], np.ndarray]] = None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config")
    parser.add_argument("--work_dir", default="work_dirs/yolo")
    parser.add_argument("--resume", nargs="?", const="latest", default=None)
    parser.add_argument("--total_epochs", type=int, default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    os.makedirs(args.work_dir, exist_ok=True)
    resume = args.resume
    if resume == "latest":
        resume = latest_checkpoint(args.work_dir)
    return train_from_config(cfg, args.work_dir, resume, args.total_epochs,
                             device=args.device, reader=reader)


if __name__ == "__main__":
    main()

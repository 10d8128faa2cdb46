"""Config-driven yolov5-cls classification training CLI.

Counterpart of cross_modal_video_engine_tpu/cli/yolo_cls_train.py (the
MCT/yolov5/classify/train.py surface): directory-per-class image folders,
RandomResizedCrop + flip for training and CenterCrop for evaluation, the
label-smoothed cross entropy with the detector's group numerics
(train/yolo_trainer.make_yolo_cls_train_step), the linear epoch schedule
lf = (1 - x/epochs) * (1 - lrf) + lrf, EMA weights, and `best/` by top-1
accuracy.

    python -m cross_modal_video_engine_tpu_torch.cli.yolo_cls_train CONFIG \\
        --work_dir work/yolo_cls [--resume [PATH]] [--total_epochs N] \\
        [--device cpu]

Layout (torchvision ImageFolder): root/train/<class>/* and
root/val/<class>/*.  `.npy` images are read with numpy; other files go
through `reader(path) -> (H, W, 3) uint8 RGB` (cv2's imread when no reader
is given: the card's machine has no cv2).  The resizes are
data/pipelines.resize_linear, cv2.resize's uint8 INTER_LINEAR bit for bit.
A resumed run also restores the loop's RandomState (`rng` in
loop_state.json); a state without it restarts it at seed 0, as the JAX
CLI does.
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.pipelines import resize_linear
from ..models.yolo import YoloClassifier, YoloConfig
from ..train.resume import (latest_checkpoint, load_train_state,
                            save_train_state)
from ..train.yolo_trainer import (YoloOptHyp, init_yolo_train_state,
                                  make_yolo_cls_train_step)
from ..utils.precision import no_tf32
from .yolo_train import _imread, _rng_from_json, _rng_json

# classify normalization constants (utils/augmentations.py)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ImageFolderDataset:
    """Directory-per-class layout, classes sorted by name to contiguous
    ids.  `classes` imposes an existing mapping (the train split's on the
    val split, so a missing class shifts no id)."""

    def __init__(self, root: str, classes: Optional[List[str]] = None,
                 reader: Optional[Callable[[str], np.ndarray]] = None):
        found = sorted(d for d in os.listdir(root)
                       if os.path.isdir(os.path.join(root, d)))
        if not found:
            raise FileNotFoundError(f"no class dirs under {root}")
        if classes is None:
            self.classes = found
        else:
            unknown = sorted(set(found) - set(classes))
            if unknown:
                raise ValueError(f"classes {unknown} under {root} not in "
                                 f"the imposed mapping {classes}")
            self.classes = list(classes)
        class_to_id = {c: i for i, c in enumerate(self.classes)}
        exts = ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.npy")
        self.samples: List[Tuple[str, int]] = []
        for cname in found:
            ci = class_to_id[cname]
            for e in exts:
                for p in sorted(glob.glob(os.path.join(root, cname, e))):
                    self.samples.append((p, ci))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}/<class>/")
        self.reader = reader

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path, label = self.samples[i]
        img = (np.load(path) if path.endswith(".npy")
               else (self.reader or _imread)(path))
        return np.ascontiguousarray(img, np.uint8), label


def random_resized_crop(img: np.ndarray, size: int,
                        rng: np.random.RandomState, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """RandomResizedCrop: an area/aspect crop (10 tries, then the centre
    crop), resized to size x size."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        log_r = rng.uniform(np.log(ratio[0]), np.log(ratio[1]))
        cw = int(round(np.sqrt(target * np.exp(log_r))))
        ch = int(round(np.sqrt(target / np.exp(log_r))))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.randint(0, w - cw + 1)
            y = rng.randint(0, h - ch + 1)
            return resize_linear(img[y:y + ch, x:x + cw], (size, size))
    return center_crop(img, size)


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """The eval transform: the central square, resized to size x size."""
    h, w = img.shape[:2]
    m = min(h, w)
    top, left = (h - m) // 2, (w - m) // 2
    return resize_linear(img[top:top + m, left:left + m], (size, size))


def _normalize(batch: np.ndarray) -> torch.Tensor:
    """uint8 -> / 255 -> ImageNet mean/std (ToTensor + Normalize)."""
    x = batch.astype(np.float32) / 255.0
    return torch.from_numpy((x - IMAGENET_MEAN) / IMAGENET_STD)


def cls_batches(ds: ImageFolderDataset, batch_size: int, size: int,
                augment: bool, rng: Optional[np.random.RandomState] = None,
                fliplr: float = 0.5, order=None) -> Iterator:
    """(images (B, S, S, 3) normalized f32, labels (B,) int64, n_real);
    the tail batch repeats its first image."""
    order = list(order if order is not None else range(len(ds)))
    for i in range(0, len(order), batch_size):
        sel = order[i:i + batch_size]
        n = len(sel)
        sel = sel + [sel[0]] * (batch_size - n)
        imgs, labels = [], []
        for j in sel:
            img, lab = ds[j]
            if augment and rng is not None:
                img = random_resized_crop(img, size, rng)
                if rng.rand() < fliplr:
                    img = img[:, ::-1]
            else:
                img = center_crop(img, size)
            imgs.append(np.ascontiguousarray(img))
            labels.append(lab)
        yield (_normalize(np.stack(imgs)),
               torch.as_tensor(np.asarray(labels, np.int64)), n)


@functools.lru_cache(maxsize=8)
def _cls_infer(model: YoloClassifier):
    @torch.no_grad()
    def infer(images):
        return model(images.to(next(model.parameters()).device))
    return infer


def evaluate_classifier(model: YoloClassifier,
                        batches: Iterator) -> Dict[str, float]:
    """classify/val.py: top-1 and top-5 over the eval transform."""
    infer = _cls_infer(model)
    top1 = top5 = total = 0
    for images, labels, n in batches:
        logits = infer(images).float().cpu().numpy()[:n]
        lab = labels.numpy()[:n]
        k = min(5, logits.shape[-1])
        topk = np.argsort(-logits, axis=-1)[:, :k]
        top1 += int((topk[:, 0] == lab).sum())
        top5 += int((topk == lab[:, None]).any(1).sum())
        total += n
    return {"top1": top1 / max(total, 1), "top5": top5 / max(total, 1)}


def build_cls_model(cfg: Config, device=None) -> YoloClassifier:
    mcfg = cfg.get("model", {})
    return YoloClassifier(YoloConfig(
        num_classes=mcfg.get("num_classes", 1000),
        depth_multiple=mcfg.get("depth_multiple", 0.33),
        width_multiple=mcfg.get("width_multiple", 0.50),
        img_size=mcfg.get("img_size", 224)), device=device)


def init_cls_train_state(model: YoloClassifier, seed: int = 0,
                         state_dict=None):
    """The classifier's state at step 0 (init_yolo_train_state)."""
    return init_yolo_train_state(model, seed=seed, state_dict=state_dict)


def train_from_config(cfg: Config, work_dir: str,
                      resume: Optional[str] = None,
                      num_epochs: Optional[int] = None, device=None,
                      reader: Optional[Callable[[str], np.ndarray]] = None,
                      seed: int = 0, on_step: Optional[Callable] = None):
    """Train the config's classifier on `device` (None: the CUDA device).
    Returns (state, history).  `on_step(epoch, bi, state, logs, seconds)`
    as in cli/yolo_train.train_from_config."""
    no_tf32()
    model = build_cls_model(cfg, device=device)
    dev = next(model.parameters()).device
    size = model.cfg.img_size
    bs = cfg.get("data.batch_size", 64)
    opt = YoloOptHyp(**cfg.get("optimizer", {}))
    lrf = cfg.get("lrf", 0.01)
    fliplr = cfg.get("aug.fliplr", 0.5)

    train_ds = ImageFolderDataset(cfg["data.train_dir"], reader=reader)
    # val takes the train split's class mapping (ids must match the head)
    val_ds = (ImageFolderDataset(cfg["data.val_dir"], train_ds.classes,
                                 reader=reader)
              if cfg.get("data.val_dir") else None)

    start = None
    load_from = cfg.get("load_from")
    if load_from and not resume:
        from .yolo_val import load_detector_weights
        start = load_detector_weights(model, load_from)
    state = init_cls_train_state(model, seed, start)
    step = make_yolo_cls_train_step(
        model, opt, weight_decay=cfg.get("weight_decay", 5e-5),
        label_smoothing=cfg.get("label_smoothing", 0.1),
        bf16=cfg.get("bf16", False), device=dev)

    start_epoch, best = 0, -1.0
    rng = np.random.RandomState(0)
    if resume:
        payload, loop = load_train_state(resume, {"state": state})
        state = payload["state"]
        start_epoch = int(loop.get("epoch", -1)) + 1
        best = float(loop.get("best", -1.0))
        rng = _rng_from_json(loop.get("rng"))

    epochs = num_epochs or cfg.get("total_epochs", 10)
    eval_interval = cfg.get("eval_interval", 1)
    history: List[Dict] = []
    for epoch in range(start_epoch, epochs):
        # the linear schedule, stepped per epoch (classify/train.py:148)
        lr = opt.lr0 * ((1 - epoch / epochs) * (1 - lrf) + lrf)
        order = rng.permutation(len(train_ds))
        losses, accs = [], []
        for bi, (images, labels, _n) in enumerate(cls_batches(
                train_ds, bs, size, True, rng, fliplr, order)):
            t0 = time.perf_counter()
            state, logs = step(state, images.to(dev), labels.to(dev), lr, lr,
                               0.9)
            losses.append(float(logs["loss"]))
            accs.append(float(logs["acc"]))
            if on_step is not None:
                on_step(epoch, bi, state, logs, time.perf_counter() - t0)
        rec = {"epoch": epoch, "loss": float(np.mean(losses)),
               "acc": float(np.mean(accs)), "lr": lr}
        if val_ds is not None and (epoch + 1) % eval_interval == 0:
            report = evaluate_classifier(
                state.ema, cls_batches(val_ds, bs, size, False))
            rec.update(report)
            if report["top1"] > best:   # fitness = top1
                best = report["top1"]
                save_train_state(os.path.join(work_dir, "best"),
                                 {"detector": state.ema},
                                 {"epoch": epoch, "top1": best,
                                  "classes": train_ds.classes,
                                  "model": dict(cfg.get("model", {}))})
        save_train_state(os.path.join(work_dir, f"epoch_{epoch}"),
                         {"state": state},
                         {"epoch": epoch, "best": best,
                          "rng": _rng_json(rng)})
        history.append(rec)
        print(json.dumps(rec))
    return state, history


def main(argv=None, reader: Optional[Callable[[str], np.ndarray]] = None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config")
    parser.add_argument("--work_dir", default="work_dirs/yolo_cls")
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

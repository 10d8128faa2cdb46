"""Config-driven skeleton-based action recognition training CLI.

Counterpart of cross_modal_video_engine_tpu/cli/skeleton_train.py (MCT
tools/train.py for `configs/skeleton/`), on the card unless `--device
cpu`:

* STGCN / AGCN (models/stgcn.py) over (B, T, V, C) keypoints, or
  (B, M, T, V, C) with `data.num_persons` > 1 (SkeletonClassifier: the
  pooled features averaged over the persons, head dropout 0.0; one
  person: head dropout 0.5, the JAX BackboneClassifier's).  The bone
  stream (`data.stream='bone'`) converts on the host, joint minus its
  COCO-17 parent (`to_bone_stream`); a 25-joint layout has no parent
  table here either, and numpy refuses the broadcast as it does in the
  JAX package;
* PoseC3D / SlowOnly: a ResNet3D over GeneratePoseTarget pseudo-heatmap
  volumes (T, H, W, K) made on the host, keypoints rescaled from the
  annotation's `img_shape` to the canvas (`_heatmap_volume`); the stem
  takes `heatmap_channels` inputs (the keypoints with `with_kp`, the
  limbs with `with_limb`).

  python -m cross_modal_video_engine_tpu_torch.cli.skeleton_train \\
      CONFIG --work_dir WORK [--resume [EPOCH_DIR]] [--total_epochs N] \\
      [--cfg-options data.stream=bone] [--device cpu]

The loop is the JAX CLI's: batches in `ShardedSampler`'s order, each
padded by repeating its first sample and trained whole; every
`eval_interval` epochs top-k and mean class accuracy on the val split
over the running statistics, `model_best` kept by top1_acc with the
{backbone, num_classes, stream} config and the params and batch_stats in
the JAX tree; `epoch_{n}` each epoch's `{"state", "batch_stats"}` in the
JAX layout (`--resume` with no directory takes the newest).  The weights
start from `models.recognizer.conv_init_state_dict` (numpy seed 0); the
head's dropout draws from a generator seeded anew each epoch (seed 1 +
epoch).  The f32 products run in f32 (TF32 off).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..config import Config
from ..convert.from_jax import conv_recognizer_variables_to_jax
from ..data.datasets import ShardedSampler
from ..data.datasets_extra import PoseDataset
from ..models.recognizer import BackboneClassifier, conv_init_state_dict
from ..models.stgcn import (AGCN, STGCN, AGCNConfig, SkeletonClassifier,
                            STGCNConfig)
from ..train.checkpoint import best_checkpoint_manager
from ..train.recognition_trainer import (
    RecognitionTrainConfig, evaluate_classification, init_rec_state,
    make_cls_train_step_stats, make_rec_optimizer)
from ..train.resume import (latest_checkpoint, load_train_state,
                            save_train_state)
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .caption_train import DROPOUT_SEED, INIT_SEED, steps_per_epoch
from .recognition_train import build_backbone

# COCO-17 bone parents (2s-AGCN's bone stream: vec = joint - parent)
COCO_PARENTS = (0, 0, 0, 1, 2, 0, 0, 5, 6, 7, 8, 0, 0, 11, 12, 13, 14)


def heatmap_channels(hm_cfg: Dict, num_joints: int = 17) -> int:
    """The channels of a GeneratePoseTarget volume: one per keypoint with
    `with_kp`, one per limb of its skeleton with `with_limb`."""
    from ..data.pipelines_extra import GeneratePoseTarget
    return ((num_joints if hm_cfg.get("with_kp", True) else 0)
            + (len(GeneratePoseTarget.COCO_SKELETONS)
               if hm_cfg.get("with_limb", False) else 0))


def build_skeleton_model(cfg: Config, device=None) -> torch.nn.Module:
    """The recognizer of `model` at the training init (numpy seed 0)."""
    dev = resolve_device(device)
    bcfg = dict(cfg["model.backbone"])
    btype = bcfg.pop("type", "STGCN")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in bcfg.items()}
    num_classes = cfg["model.num_classes"]
    heatmap = cfg.get("data.heatmap")
    # heatmap (PoseC3D) inputs max-combine persons into one volume, so
    # the per-person feature average applies to the GCN streams only
    person_avg = cfg.get("data.num_persons", 1) > 1 and not heatmap
    if btype in ("STGCN", "AGCN"):
        backbone = (STGCN(STGCNConfig(**kw), dev) if btype == "STGCN"
                    else AGCN(AGCNConfig(**kw), dev))
        model = SkeletonClassifier(backbone, num_classes,
                                   dropout_ratio=0.0 if person_avg else 0.5)
    elif btype in ("PoseC3D", "SlowOnly"):
        channels = heatmap_channels(
            heatmap or {}, cfg.get("model.backbone.num_joints", 17))
        model = BackboneClassifier(
            build_backbone("SlowOnly", kw, dev, in_channels=channels),
            num_classes)
    else:
        raise ValueError(f"unknown skeleton backbone {btype}")
    model.load_state_dict(conv_init_state_dict(model, INIT_SEED))
    return model


def to_bone_stream(kp: np.ndarray, parents=COCO_PARENTS) -> np.ndarray:
    """joint (T, V, C) -> bone vectors joint - parent (scores kept)."""
    parents = np.asarray(parents[: kp.shape[-2]])
    bones = kp.copy()
    bones[..., :2] = kp[..., :2] - kp[..., parents, :2]
    return bones


def _heatmap_volume(kp: np.ndarray, hm_cfg: Dict,
                    src_shape=None) -> np.ndarray:
    """PoseC3D input: GeneratePoseTarget pseudo-heatmaps (T, H, W, K) of
    (T, V, C) or (M, T, V, C) keypoints, max-combined over persons.
    src_shape: the (h, w) pixel frame of the coordinates (the
    annotation's img_shape), rescaled to the canvas; None: coordinates
    already on the canvas."""
    from ..data.pipelines_extra import GeneratePoseTarget
    h, w = hm_cfg.get("img_shape", (56, 56))
    op = GeneratePoseTarget(sigma=hm_cfg.get("sigma", 0.6),
                            use_score=hm_cfg.get("use_score", True),
                            with_kp=hm_cfg.get("with_kp", True),
                            with_limb=hm_cfg.get("with_limb", False))
    if kp.ndim == 3:
        kp = kp[None]
    xy = kp[..., :2]
    if src_shape is not None:
        sh, sw = src_shape
        xy = xy * np.asarray([w / sw, h / sh], np.float32)
    results = {"keypoint": xy,
               "keypoint_score": kp[..., 2]
               if kp.shape[-1] > 2 else np.ones(kp.shape[:-1],
                                                np.float32),
               "img_shape": (h, w)}
    return np.asarray(op(results)["imgs"], np.float32)


def skeleton_arrays(ds: PoseDataset, batch_size: int,
                    stream: str = "joint", heatmap: Optional[Dict] = None,
                    order=None) -> Iterator:
    """(inputs float32, labels int64, n valid) as numpy, each batch padded
    by repeating its first sample (JAX skeleton_batches)."""
    order = list(order if order is not None else range(len(ds)))
    for i in range(0, len(order), batch_size):
        sel = order[i:i + batch_size]
        n = len(sel)
        while len(sel) < batch_size:
            sel.append(sel[0])
        xs, ys = [], []
        for j in sel:
            kp, label = ds[j]
            if stream == "bone":
                kp = to_bone_stream(kp)
            xs.append(_heatmap_volume(kp, heatmap, ds.src_shape(j))
                      if heatmap else kp)
            ys.append(label)
        yield (np.stack(xs).astype(np.float32, copy=False),
               np.asarray(ys, np.int64), n)


def skeleton_batches(ds: PoseDataset, batch_size: int,
                     stream: str = "joint", heatmap: Optional[Dict] = None,
                     order=None, device=None) -> Iterator:
    """skeleton_arrays' batches as tensors on `device` (None: the card)."""
    dev = resolve_device(device)
    for x, y, n in skeleton_arrays(ds, batch_size, stream, heatmap, order):
        yield (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), n)


def train_from_config(cfg: Config, work_dir: str,
                      resume: Optional[str] = None,
                      num_epochs: Optional[int] = None, *, device=None):
    """Train as the config says on `device` (None: the CUDA device).
    Returns (state, history)."""
    dev = resolve_device(device)
    no_tf32()
    model = build_skeleton_model(cfg, dev)
    clip_len = cfg.get("data.clip_len", 48)
    num_joints = cfg.get("model.backbone.num_joints", 17)
    stream = cfg.get("data.stream", "joint")
    heatmap = cfg.get("data.heatmap")
    bs = cfg.get("data.batch_size", 16)
    num_persons = cfg.get("data.num_persons", 1)
    train_ds = PoseDataset(cfg["data.train.ann_file"], clip_len, num_joints,
                           num_persons)
    val_ds = PoseDataset(cfg["data.val.ann_file"], clip_len, num_joints,
                         num_persons)

    tcfg = RecognitionTrainConfig(**cfg.get("optimizer", {}))
    epochs = num_epochs or cfg.get("total_epochs", tcfg.num_epochs)
    # total_steps sizes the warmup-cosine schedule to the run
    tx = make_rec_optimizer(
        tcfg, total_steps=epochs * steps_per_epoch(len(train_ds), bs))
    state = init_rec_state(model, tx)
    generator = torch.Generator(device=dev)
    step = make_cls_train_step_stats(model, bf16=tcfg.bf16,
                                     generator=generator, device=dev)
    save_best = best_checkpoint_manager(work_dir)
    sampler = ShardedSampler(len(train_ds), shuffle=True)

    start_epoch = 0
    if resume:
        payload, loop = load_train_state(resume, {"state": state,
                                                  "batch_stats": model})
        state = payload["state"]
        start_epoch = int(loop.get("epoch", -1)) + 1

    eval_interval = cfg.get("eval_interval", tcfg.eval_interval)
    history: List[Dict] = []
    for epoch in range(start_epoch, epochs):
        generator.manual_seed(DROPOUT_SEED + epoch)
        losses, accs = [], []
        for x, labels, _n in skeleton_batches(train_ds, bs, stream, heatmap,
                                              sampler.indices(epoch), dev):
            state, logs = step(state, x, labels)
            losses.append(logs["loss"])
            accs.append(logs["top1_acc"])
        rec = {"epoch": epoch,
               "loss": float(torch.stack(losses).double().mean()),
               "train_top1": float(torch.stack(accs).double().mean())}
        if (epoch + 1) % eval_interval == 0:
            report = evaluate_classification(
                model, skeleton_batches(val_ds, bs, stream, heatmap,
                                        device=dev))
            rec.update(report)
            save_best(conv_recognizer_variables_to_jax(model.state_dict(),
                                                       model),
                      {"backbone": cfg["model.backbone"],
                       "num_classes": cfg["model.num_classes"],
                       "stream": stream},
                      report["top1_acc"], {"epoch": epoch})
        save_train_state(os.path.join(work_dir, f"epoch_{epoch}"),
                         {"state": state, "batch_stats": model},
                         {"epoch": epoch})
        history.append(rec)
        print(json.dumps(rec), flush=True)
    return state, history


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config")
    parser.add_argument("--work_dir", default="work_dirs/skeleton")
    parser.add_argument("--resume", nargs="?", const="latest", default=None)
    parser.add_argument("--total_epochs", type=int, default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    os.makedirs(args.work_dir, exist_ok=True)
    resume = args.resume
    if resume == "latest":
        resume = latest_checkpoint(args.work_dir)
    _, history = train_from_config(cfg, args.work_dir, resume,
                                   args.total_epochs,
                                   device=args.device or device)
    return history


if __name__ == "__main__":
    main()

"""Config-driven AVA spatio-temporal detection training CLI.

Counterpart of cross_modal_video_engine_tpu/cli/detection_train.py (MCT
tools/train.py for configs/detection/{ava,acrn,lfb}/): FastRCNN over a
SlowOnly or SlowFast backbone with the AVA RoI head, the ACRN or FBO
shared head (`model.shared_head=dict(type='ACRN' | 'FBO', ...)`), on the
card unless `--device cpu`.

  python -m cross_modal_video_engine_tpu_torch.cli.detection_train \\
      CONFIG --work_dir WORK [--resume [EPOCH_DIR]] [--total_epochs N] \\
      [--cfg-options ...] [--device cpu]

It keeps the JAX CLI's choices:

* keyframes decoded through `data.pipeline` (`reader=` hands the decode
  op a decord-alike reader, data/pipelines.with_reader), GT boxes and
  proposals riding through it under `gt_bboxes` / `proposals`, assigned
  by `assign_proposals` and packed `max_boxes` RoIs a keyframe; the tail
  batch padded with its first keyframe at `valid = 0` (`det_batches`);
* the epoch order `ShardedSampler(shuffle=True).indices(epoch)`; the
  first training batch read once before training, as the JAX CLI reads it
  for its init (the train pipeline's draws advance alike);
* the val pipeline: `data.val.pipeline`, or the train pipeline with
  SampleAVAFrames in test mode; val candidates from
  `data.val.proposal_file`, else the GT boxes;
* FBO configs (`model.lfb = dict(window_size, capacity, path,
  checkpoint)`): the bank loaded from `path`, or built over both splits
  from a bare detector (the training init, or `checkpoint`'s weights)
  and saved at `path`;
* every `eval_interval` epochs frame-mAP@0.5 on the val split and
  `model_best` kept by it ({"params", "batch_stats"} with the
  {backbone, roi_head} config); `epoch_{n}` each epoch's train state
  `{"state", "batch_stats"}` in the JAX layout, so `--resume` reads
  either package's.

The weights start from `models.recognizer.conv_init_state_dict` (numpy
seed 0); the dropouts draw from a generator seeded anew each epoch (seed
1 + epoch).  Proposal files are json {"video,tttt": [[x1, y1, x2, y2],
...]} in normalized coordinates (cli/ava_proposals.py writes them).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..config import Config
from ..convert.from_jax import (ava_detector_state_dict_from_jax,
                                ava_detector_variables_to_jax)
from ..data.datasets import ShardedSampler
from ..data.datasets_extra import AVADataset
from ..data.pipelines import build_pipeline, with_reader
from ..metrics.ava import make_image_key
from ..models.ava_head import AVAHeadConfig
from ..models.lfb import (ACRNHead, ACRNHeadConfig, FBOHead, FBOHeadConfig,
                          LongTermFeatureBank)
from ..models.recognizer import conv_init_state_dict
from ..train.checkpoint import best_checkpoint_manager, load_checkpoint
from ..train.detection_trainer import (AVAFastRCNN, assign_proposals,
                                       build_lfb, evaluate_ava_detection,
                                       make_det_infer, make_det_train_step,
                                       pack_detection_batch,
                                       sample_lt_features)
from ..train.recognition_trainer import (RecognitionTrainConfig,
                                         init_rec_state, make_rec_optimizer)
from ..train.resume import (latest_checkpoint, load_train_state,
                            save_train_state)
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .caption_train import DROPOUT_SEED, INIT_SEED
from .recognition_train import _deep_tuple, build_backbone


def build_detection_model(cfg: Config, device=None,
                          bare: bool = False) -> AVAFastRCNN:
    """The config's detector at the training init on `device` (None: the
    CUDA device); bare: without the shared head (the LFB bootstrap's)."""
    dev = resolve_device(device)
    bcfg = dict(cfg["model.backbone"])
    btype = bcfg.pop("type", "SlowOnly")
    backbone = build_backbone(btype, {k: _deep_tuple(v)
                                      for k, v in bcfg.items()}, dev)
    shared = None
    scfg = None if bare else cfg.get("model.shared_head")
    if scfg:
        scfg = dict(scfg)
        stype = scfg.pop("type")
        if stype == "ACRN":
            shared = ACRNHead(ACRNHeadConfig(**scfg), backbone.feat_dim,
                              device=dev)
        elif stype == "FBO":
            shared = FBOHead(FBOHeadConfig(**scfg), backbone.feat_dim,
                             device=dev)
        else:
            raise ValueError(f"unknown shared head {stype}")
    model = AVAFastRCNN(backbone, AVAHeadConfig(**cfg.get("model.roi_head",
                                                          {})),
                        shared, device=dev)
    model.load_state_dict(conv_init_state_dict(model, INIT_SEED))
    return model


def load_detector(cfg: Config, checkpoint: str, device=None,
                  bare: bool = False) -> AVAFastRCNN:
    """The config's detector with a checkpoint's weights ({"params",
    "batch_stats"} in the JAX layout, either package's)."""
    model = build_detection_model(cfg, device, bare)
    variables, _cfg, _meta = load_checkpoint(checkpoint)
    model.load_state_dict(ava_detector_state_dict_from_jax(variables, model))
    return model


def val_pipeline(cfg: Config) -> list:
    """data.val.pipeline, else the train pipeline with SampleAVAFrames in
    test mode (deterministic centre sampling)."""
    ops = cfg.get("data.val.pipeline")
    if ops is None:
        ops = [dict(op, test_mode=True)
               if op.get("type") == "SampleAVAFrames" else op
               for op in cfg["data.pipeline"]]
    return ops


def _load_proposals(path: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    if not path:
        return None
    with open(path) as f:
        raw = json.load(f)
    return {k: np.asarray(v, np.float32).reshape(-1, 4)
            for k, v in raw.items()}


def _decode_clip(pipeline, item: Dict, fps: float, ts_start: float,
                 proposals: Optional[np.ndarray] = None):
    """One keyframe through the decode pipeline; GT boxes and proposals
    ride along (gt_bboxes / proposals, normalized) so geometric ops move
    them with the frames."""
    results = dict(item)
    results.setdefault("fps", fps)
    results.setdefault("timestamp_start", ts_start)
    results.setdefault("start_index", 0)
    results["gt_bboxes"] = np.asarray(item["boxes"], np.float32)
    results["bbox_coords"] = "normalized"
    if proposals is not None:
        results["proposals"] = np.asarray(proposals, np.float32)
    out = pipeline(results)
    clip = np.asarray(out["imgs"], np.float32)
    if clip.ndim == 5:          # (num_clips, T, H, W, C) -> clip 0
        clip = clip[0]
    return (clip, np.asarray(out["gt_bboxes"], np.float32),
            out.get("proposals"))


def det_batches(ds: AVADataset, pipeline, batch_size: int, num_classes: int,
                max_boxes: int, fps: float, ts_start: float, proposals=None,
                pos_iou_thr: float = 0.9, order=None,
                include_meta: bool = False) -> Iterator[Dict]:
    """Decoded, assigned and packed keyframe batches (numpy); a short tail
    batch repeats its first keyframe at valid = 0."""
    order = list(order if order is not None else range(len(ds)))
    for i in range(0, len(order), batch_size):
        sel = order[i:i + batch_size]
        n = len(sel)
        while len(sel) < batch_size:
            sel.append(sel[0])
        items, metas = [], []
        for j in sel:
            kf = ds[j]
            props = None
            if proposals is not None:
                props = proposals.get(
                    make_image_key(kf["video_id"], kf["timestamp"]),
                    np.zeros((0, 4), np.float32))
            clip, gt_boxes, props = _decode_clip(pipeline, kf, fps,
                                                 ts_start, props)
            boxes, labels = assign_proposals(
                props if props is not None else np.zeros((0, 4), np.float32),
                gt_boxes, kf["labels"], num_classes, pos_iou_thr)
            items.append(dict(clip=clip, boxes=boxes, labels=labels))
            metas.append(dict(kf, boxes=gt_boxes))
        clips, rois, labels, valid = pack_detection_batch(
            items, max_boxes, num_classes)
        valid[n * max_boxes:] = 0.0
        batch = dict(clips=clips, rois=rois, labels=labels, valid=valid,
                     n=n)
        if include_meta:
            batch["video_id"] = [m["video_id"] for m in metas[:n]]
            batch["timestamp"] = [m["timestamp"] for m in metas[:n]]
            batch["gt_boxes"] = [m["boxes"] for m in metas[:n]]
            batch["gt_labels"] = [m["labels"] for m in metas[:n]]
        yield batch


def bootstrap_lfb(cfg: Config, train_batches, val_batches, device=None):
    """The bank over both splits from a bare detector: the training init,
    or model.lfb.checkpoint's weights (a trained base detector)."""
    ckpt = cfg.get("model.lfb.checkpoint")
    bare = (load_detector(cfg, ckpt, device, bare=True) if ckpt
            else build_detection_model(cfg, device, bare=True))
    return build_lfb(bare, itertools.chain(train_batches, val_batches),
                     capacity=cfg.get("model.lfb.capacity", 5))


def train_from_config(cfg: Config, work_dir: str,
                      resume: Optional[str] = None,
                      num_epochs: Optional[int] = None, *, device=None,
                      reader=None):
    """Train as the config says on `device` (None: the CUDA device), f32
    with TF32 off.  Returns (state, history)."""
    dev = resolve_device(device)
    no_tf32()
    num_classes = cfg.get("model.roi_head.num_classes", 81)
    max_boxes = cfg.get("model.train_cfg.max_boxes", 8)
    pos_iou_thr = cfg.get("model.train_cfg.pos_iou_thr", 0.9)
    action_thr = cfg.get("model.test_cfg.action_thr", 0.002)
    fps = cfg.get("data.fps", 30)
    ts_start = cfg.get("data.timestamp_start", 0)
    bs = cfg.get("data.videos_per_gpu", 4)

    pipe = build_pipeline(with_reader(cfg["data.pipeline"], reader))
    val_pipe = build_pipeline(with_reader(val_pipeline(cfg), reader))
    train_ds = AVADataset(cfg["data.train.ann_file"], num_classes,
                          cfg.get("data.train.data_prefix"))
    val_ds = AVADataset(cfg["data.val.ann_file"], num_classes,
                        cfg.get("data.val.data_prefix"))
    proposals = _load_proposals(cfg.get("data.train.proposal_file"))
    val_proposals = _load_proposals(cfg.get("data.val.proposal_file"))

    def train_batches(order=None, props=proposals, meta=False):
        return det_batches(train_ds, pipe, bs, num_classes, max_boxes, fps,
                           ts_start, props, pos_iou_thr, order,
                           include_meta=meta)

    def val_batches():
        return det_batches(val_ds, val_pipe, bs, num_classes, max_boxes, fps,
                           ts_start, val_proposals, include_meta=True)

    tcfg = RecognitionTrainConfig(**cfg.get("optimizer", {}))
    epochs = num_epochs or cfg.get("total_epochs", tcfg.num_epochs)
    steps_per_epoch = max(1, (len(train_ds) + bs - 1) // bs)
    tx = make_rec_optimizer(tcfg, total_steps=epochs * steps_per_epoch)
    model = build_detection_model(cfg, dev)

    bank = None
    window_size = cfg.get("model.lfb.window_size", 60)
    uses_fbo = isinstance(model.shared_head, FBOHead)
    lfb_path = cfg.get("model.lfb.path")
    if uses_fbo and lfb_path and os.path.exists(lfb_path):
        bank = LongTermFeatureBank.load(lfb_path, dev)
    # the JAX CLI reads its first batch for the init's shapes
    next(train_batches(meta=True))
    if uses_fbo and bank is None:
        bank = bootstrap_lfb(cfg, train_batches(props=None, meta=True),
                             val_batches(), dev)
        if lfb_path:
            bank.save(lfb_path)

    state = init_rec_state(model, tx)
    generator = torch.Generator(device=dev)
    step = make_det_train_step(model, generator=generator, device=dev)
    infer = make_det_infer(model)
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
        for batch in train_batches(sampler.indices(epoch), meta=uses_fbo):
            lt = None
            if uses_fbo:
                lt = sample_lt_features(bank, batch["video_id"],
                                        batch["timestamp"], max_boxes,
                                        window_size, bs)
            state, logs = step(state, batch["clips"], batch["rois"],
                               batch["labels"], batch["valid"], lt)
            losses.append(logs["loss"])
            accs.append(logs["label_acc"])
        rec = {"epoch": epoch,
               "loss": float(torch.stack(losses).double().mean()),
               "label_acc": float(torch.stack(accs).double().mean())}
        if (epoch + 1) % eval_interval == 0:
            report = evaluate_ava_detection(
                infer, val_batches(), num_classes, action_thr,
                bank=bank if uses_fbo else None, window_size=window_size)
            rec["mAP@0.5IOU"] = report["mAP@0.5IOU"]
            save_best(ava_detector_variables_to_jax(model.state_dict(),
                                                    model),
                      {"backbone": cfg["model.backbone"],
                       "roi_head": cfg.get("model.roi_head", {})},
                      report["mAP@0.5IOU"], {"epoch": epoch})
        save_train_state(os.path.join(work_dir, f"epoch_{epoch}"),
                         {"state": state, "batch_stats": model},
                         {"epoch": epoch})
        history.append(rec)
        print(json.dumps(rec), flush=True)
    return state, history


def main(argv=None, reader=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config")
    parser.add_argument("--work_dir", default="work_dirs/detection")
    parser.add_argument("--resume", nargs="?", const="latest", default=None)
    parser.add_argument("--total_epochs", type=int, default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    os.makedirs(args.work_dir, exist_ok=True)
    resume = args.resume
    if resume == "latest":
        resume = latest_checkpoint(args.work_dir)
    _, history = train_from_config(cfg, args.work_dir, resume,
                                   args.total_epochs, device=args.device,
                                   reader=reader)
    return history


if __name__ == "__main__":
    main()

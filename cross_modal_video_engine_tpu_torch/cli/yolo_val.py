"""Standalone YOLOv5 detector validation CLI.

Counterpart of cross_modal_video_engine_tpu/cli/yolo_val.py, the
MCT/yolov5/val.py offline-eval surface: load a detector checkpoint, run
letterbox inference + NMS over a yolov5-format validation directory on
the card (or `--device cpu`), and print the COCO-protocol summary row
(mAP@0.5, mAP@0.5:0.95, precision, recall, per-class AP) as one JSON
line, the same row the JAX CLI prints.

    python -m cross_modal_video_engine_tpu_torch.cli.yolo_val CONFIG \\
        --checkpoint work/yolo/best [--conf 0.001 --iou 0.6] \\
        [--augment] [--device cpu]

`--checkpoint` takes either a trainer `best/` directory (train_state.msgpack
of {"params", "batch_stats"} and loop_state.json, whose anchors replace
the config's) or a `save_checkpoint` directory (config.json +
params.msgpack), both in the JAX package's format.  Validation images are
`.npy` arrays or files cv2 reads (`yolo_train.YoloDetectionDataset`'s
`reader` takes other decoders).  f32, TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os

from ..config import Config
from ..convert.from_jax import (yolo_cls_state_dict_from_jax,
                                yolo_state_dict_from_jax)
from ..models.yolo import YoloClassifier
from ..train.checkpoint import load_checkpoint
from ..train.resume import STATE_FILE, load_train_state
from ..utils.precision import no_tf32
from .yolo_train import (YoloDetectionDataset, YoloSegDataset,
                         build_yolo_model, evaluate_detector,
                         evaluate_segmenter, yolo_batches, yolo_seg_batches)


def load_detector(cfg: Config, checkpoint: str, device=None):
    """The config's detector with a checkpoint's weights: a `best/`
    directory (its loop state's anchors applied) or a `save_checkpoint`
    directory."""
    model = build_yolo_model(cfg, device=device)
    model.load_state_dict(load_detector_weights(model, checkpoint))
    return model


def load_detector_weights(model, checkpoint: str):
    """The state dict a checkpoint directory holds for `model` (a `best/`
    directory loads into the model, its anchors applied, and hands back
    the model's state dict)."""
    if os.path.exists(os.path.join(checkpoint, STATE_FILE)):
        load_train_state(checkpoint, {"detector": model})
        return model.state_dict()
    variables, _, _ = load_checkpoint(checkpoint)
    from_jax = (yolo_cls_state_dict_from_jax
                if isinstance(model, YoloClassifier)
                else yolo_state_dict_from_jax)
    return from_jax(variables, model.cfg)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--conf", type=float, default=0.001)
    parser.add_argument("--iou", type=float, default=0.6)
    parser.add_argument("--augment", action="store_true",
                        help="scale/flip test-time augmentation "
                             "(val.py --augment; detection models only)")
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)

    no_tf32()
    model = load_detector(cfg, args.checkpoint, args.device)
    img_size = model.cfg.img_size
    bs = cfg.get("data.batch_size", 16)
    max_t = cfg.get("data.max_targets", 64)
    if model.cfg.masks > 0:   # segment/val.py route: box + mask mAP
        if args.augment:
            raise SystemExit("--augment supports detection models only "
                             "(the reference Segment head has no TTA "
                             "mask merge either)")
        mask_ratio = cfg.get("data.mask_ratio", 4)
        seg_ds = YoloSegDataset(cfg["data.val.img_dir"],
                                cfg["data.val.label_dir"])
        report = evaluate_segmenter(
            model, yolo_seg_batches(seg_ds, bs, img_size, max_t, mask_ratio),
            conf_thres=args.conf, iou_thres=args.iou, mask_ratio=mask_ratio)
    else:
        ds = YoloDetectionDataset(cfg["data.val.img_dir"],
                                  cfg["data.val.label_dir"])
        report = evaluate_detector(
            model, yolo_batches(ds, bs, img_size, max_t),
            conf_thres=args.conf, iou_thres=args.iou, augment=args.augment)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

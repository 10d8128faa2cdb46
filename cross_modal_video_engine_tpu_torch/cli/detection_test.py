"""Offline AVA detection evaluation CLI.

Counterpart of cross_modal_video_engine_tpu/cli/detection_test.py (MCT
tools/test.py for the detection family): a detection checkpoint
(`model_best` of either package's detection_train) run over the val
keyframes on the card unless `--device cpu`, the AVA results csv written
by metrics/ava.results2csv and, given a label map, scored through the
file-level `ava_eval`, as the reference's results2csv + ava_eval flow
does.

  python -m cross_modal_video_engine_tpu_torch.cli.detection_test CONFIG \\
      --checkpoint work_dirs/detection/model_best --out results.csv \\
      [--label_file ava_labels.pbtxt] [--exclude_file excluded.csv] \\
      [--device cpu]

The val pipeline and candidates are the trainer's eval's
(cli/detection_train.val_pipeline, `data.val.proposal_file`).  An FBO
checkpoint needs the bank the trainer saved at `model.lfb.path`; without
it the run is refused.  `run_detection_test(..., reader=)` hands the
decode op a decord-alike reader.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from ..config import Config
from ..data.datasets_extra import AVADataset
from ..data.pipelines import build_pipeline, with_reader
from ..metrics.ava import ava_eval, results2csv
from ..models.lfb import FBOHead, LongTermFeatureBank
from ..train.detection_trainer import (detection_results, make_det_infer,
                                       sample_lt_features)
from ..utils.device import resolve_device
from ..utils.precision import no_tf32
from .detection_train import (_load_proposals, det_batches, load_detector,
                              val_pipeline)


def run_detection_test(cfg: Config, checkpoint: str, out_csv: str,
                       label_file: Optional[str] = None,
                       exclude_file: Optional[str] = None, *, device=None,
                       reader=None):
    dev = resolve_device(device)
    no_tf32()
    num_classes = cfg.get("model.roi_head.num_classes", 81)
    max_boxes = cfg.get("model.train_cfg.max_boxes", 8)
    action_thr = cfg.get("model.test_cfg.action_thr", 0.002)
    fps = cfg.get("data.fps", 30)
    ts_start = cfg.get("data.timestamp_start", 0)
    bs = cfg.get("data.videos_per_gpu", 4)

    model = load_detector(cfg, checkpoint, dev)
    infer = make_det_infer(model)
    pipe = build_pipeline(with_reader(val_pipeline(cfg), reader))
    val_ds = AVADataset(cfg["data.val.ann_file"], num_classes,
                        cfg.get("data.val.data_prefix"))
    val_proposals = _load_proposals(cfg.get("data.val.proposal_file"))

    bank = None
    window_size = cfg.get("model.lfb.window_size", 60)
    if isinstance(model.shared_head, FBOHead):
        lfb_path = cfg.get("model.lfb.path")
        if not (lfb_path and os.path.exists(lfb_path)):
            raise ValueError(
                "FBO checkpoint needs the feature bank: set "
                "model.lfb.path to the bank the trainer saved")
        bank = LongTermFeatureBank.load(lfb_path, dev)

    # per-keyframe, per-class result lists in dataset order
    results: List[List[np.ndarray]] = []
    for batch in det_batches(val_ds, pipe, bs, num_classes, max_boxes, fps,
                             ts_start, val_proposals, include_meta=True):
        lt = None
        if bank is not None:
            lt = sample_lt_features(bank, batch["video_id"],
                                    batch["timestamp"], max_boxes,
                                    window_size, bs)
        scores = infer(batch["clips"], batch["rois"], lt).cpu().numpy()
        for b in range(batch["n"]):
            sl = slice(b * max_boxes, (b + 1) * max_boxes)
            n = int(batch["valid"][sl].sum())
            results.append(detection_results(
                scores[sl], batch["rois"][sl][:, 1:], n, num_classes,
                action_thr))

    results2csv(val_ds, results, out_csv)
    report = {"out": out_csv, "n_keyframes": len(val_ds)}
    if label_file:
        report.update(ava_eval(out_csv, "mAP", label_file,
                               cfg["data.val.ann_file"], exclude_file,
                               verbose=False))
    print(json.dumps(report), flush=True)
    return report


def main(argv=None, reader=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("config")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", default="results.csv")
    parser.add_argument("--label_file", default=None)
    parser.add_argument("--exclude_file", default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    return run_detection_test(cfg, args.checkpoint, args.out,
                              args.label_file, args.exclude_file,
                              device=args.device, reader=reader)


if __name__ == "__main__":
    main()

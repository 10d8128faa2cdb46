"""Offline recognition evaluation CLI.

Counterpart of cross_modal_video_engine_tpu/cli/recognition_test.py (MCT
tools/test.py): a checkpoint over a dataset's val split on the card (or
`--device cpu`), reporting top-k accuracy and mean class accuracy (the
`--eval` metrics) and writing the per-video scores with `--out`.

  python -m cross_modal_video_engine_tpu_torch.cli.recognition_test \\
      CONFIG --checkpoint CKPT [--out scores.npz] \\
      [--eval top_k_accuracy mean_class_accuracy] [--device cpu]

The multi-clip protocol of tools/test.py: every clip of a video goes into
the batch and `forward_test(num_segs)` averages the clips' softmax per
video.  The checkpoint loads through `api.init_recognizer`, so this CLI
takes the checkpoints the JAX CLI takes: TimeSformer classifiers and
caption models; a 3D-CNN checkpoint without a decoder is refused there,
as the JAX loader refuses it.  The f32 products run in f32 (TF32 off).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..api import init_recognizer, model_device
from ..config import Config
from ..data.datasets import VideoDataset
from ..data.pipelines import build_pipeline
from ..metrics.accuracy import mean_class_accuracy, top_k_accuracy


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", default=None, help="npz of scores")
    parser.add_argument("--eval", nargs="*",
                        default=["top_k_accuracy", "mean_class_accuracy"])
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    model, _ = init_recognizer(args.checkpoint, device=args.device)
    pipe = build_pipeline(cfg["data.pipeline"])
    ds = VideoDataset(cfg["data.val.ann_file"], pipe,
                      cfg.get("data.val.data_prefix"))
    bs = cfg.get("data.videos_per_gpu", 8)

    dev = model_device(model)
    scores, labels = [], []
    for imgs, items, n in ds.batches(bs):
        b, n_clips = imgs.shape[:2]
        clips = torch.from_numpy(imgs.reshape(
            (b * n_clips,) + imgs.shape[2:]).astype(np.float32)).to(dev)
        with torch.no_grad():
            s = model.forward_test(clips, num_segs=n_clips)
        scores.extend(list(s.float().cpu().numpy()[:n]))
        labels.extend(int(it["label"]) for it in items[:n])

    report = {}
    if "top_k_accuracy" in args.eval:
        k = min(5, scores[0].shape[0])
        top1, topk = top_k_accuracy(scores, labels, (1, k))
        report["top1_acc"] = top1
        report[f"top{k}_acc"] = topk
    if "mean_class_accuracy" in args.eval:
        report["mean_class_accuracy"] = mean_class_accuracy(scores, labels)
    if args.out:
        np.savez(args.out, scores=np.stack(scores),
                 labels=np.asarray(labels))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

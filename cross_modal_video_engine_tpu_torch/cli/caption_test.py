"""Dataset-level caption (label-sequence) evaluation CLI.

Counterpart of cross_modal_video_engine_tpu/cli/caption_test.py, the
caption half of MCT tools/test.py: run a Recognizer3D_Relseq checkpoint
over a VideoDatasetRelseq split on the card (or `--device cpu`) and
report the sequence-aware mean average precision (reference
core/evaluation/accuracy.py:268-317: per-class AP over sequence steps,
truncated at the first end-token step).

  python -m cross_modal_video_engine_tpu_torch.cli.caption_test CONFIG \\
      --checkpoint CKPT [--out scores.npz] [--device cpu]

Annotation mask semantics: the dataset's per-step validity mask marks
real steps; evaluation turns masked-out steps into end-token rows (last
class hot), the reference's label convention.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..api import init_recognizer, model_device
from ..config import Config
from ..data.datasets import VideoDatasetRelseq
from ..data.pipelines import build_pipeline
from ..metrics.accuracy import seq_average_precision


def eval_labels(mat: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(max_len, C) step labels + (max_len,) validity -> reference-style
    labels with end-token rows after the sequence ends."""
    out = np.asarray(mat, np.float32).copy()
    out[np.asarray(mask) == 0] = 0.0
    out[np.asarray(mask) == 0, -1] = 1.0
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    model, cfg_d = init_recognizer(args.checkpoint, device=args.device)
    if "decoder" not in cfg_d:
        raise ValueError("checkpoint is not a caption (Relseq) model")
    num_classes = cfg_d["decoder"]["num_classes"]
    max_len = cfg_d["decoder"].get("max_len", 5)

    pipe = build_pipeline(cfg["data.pipeline"])
    ds = VideoDatasetRelseq(cfg["data.val.ann_file"], pipe,
                            num_classes=num_classes, max_len=max_len,
                            data_prefix=cfg.get("data.val.data_prefix"))
    bs = cfg.get("data.videos_per_gpu", 8)

    dev = model_device(model)
    scores, labels = [], []
    for imgs, items, n in ds.batches(bs):
        b, n_clips = imgs.shape[0], imgs.shape[1]
        clips = torch.from_numpy(imgs.reshape(
            (b * n_clips,) + imgs.shape[2:]).astype(np.float32)).to(dev)
        with torch.no_grad():
            probs = model.forward_test(clips, num_segs=n_clips)
        probs = probs.cpu().numpy()                    # (B, L, C)
        for i in range(n):
            scores.append(probs[i])
            labels.append(eval_labels(items[i]["label"], items[i]["mask"]))

    aps = seq_average_precision(scores, labels)
    # classes with no positives in the split score 0 by the reference's
    # NaN->0 rule; report both the raw mean and the positives-only mean
    has_pos = np.concatenate(labels).sum(0) > 0
    report = {
        "seq_mAP": float(np.mean(aps)),
        "seq_mAP_labeled_classes": float(
            np.mean([a for a, h in zip(aps, has_pos) if h])),
        "num_videos": len(scores),
    }
    if args.out:
        np.savez(args.out, scores=np.stack(scores),
                 labels=np.stack(labels), per_class_ap=np.asarray(aps))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

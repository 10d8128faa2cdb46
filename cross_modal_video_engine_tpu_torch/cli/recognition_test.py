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
caption models.  A classifier's checkpoint (no decoder, a backbone of
the config's `model.backbone.type`, as cli/recognition_train writes it
for the 2D, TSM, 3D-CNN and TPN families and for Swin3D, MViT,
VideoMAEViT and VideoCLIP) is rebuilt from the config's `model` (its
neck and head, which the checkpoint does not record), where the JAX
CLI's loader refuses it; one of another backbone is refused, as the JAX
loader refuses it.  A 'CLIP' checkpoint (a Recognizer3DCLIP) is refused:
the JAX class has no `forward_test`, so the JAX CLI fails on it too.  The f32 products run in f32
(TF32 off).  `test_from_config(..., reader=)` hands the pipeline a
decord-alike reader in place of opening files (a machine without cv2).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from ..api import init_recognizer, model_device
from ..config import Config
from ..convert.from_jax import conv_recognizer_state_dict_from_jax
from ..data.datasets import VideoDataset
from ..data.pipelines import build_pipeline, with_reader
from ..metrics.accuracy import mean_class_accuracy, top_k_accuracy
from ..train.checkpoint import load_checkpoint
from ..utils.precision import no_tf32


CLIP_REFUSAL = ("a 'CLIP' checkpoint is a Recognizer3DCLIP, which has no "
                "forward_test (the JAX class has none, and the JAX "
                "package's recognition_test fails on it too)")


def load_recognizer(cfg: Config, checkpoint: str, device=None):
    """The checkpoint's recognizer, eval mode and frozen: a CNN classifier
    of the config's backbone type built from the config's `model`, any
    other checkpoint through `api.init_recognizer`."""
    from .recognition_train import build_recognition_model
    variables, cfg_d, _ = load_checkpoint(checkpoint)
    btype = cfg_d["backbone"].get("type", "TimeSformer")
    if btype == "CLIP":
        raise ValueError(CLIP_REFUSAL)
    if btype == "TimeSformer" or "decoder" in cfg_d or \
            btype != cfg["model.backbone"].get("type", "TimeSformer"):
        return init_recognizer(checkpoint, device=device)[0]
    no_tf32()
    model = build_recognition_model(cfg, device)
    model.load_state_dict(conv_recognizer_state_dict_from_jax(variables,
                                                              model))
    return model.eval().requires_grad_(False)


def test_from_config(cfg: Config, checkpoint: str, device=None,
                     evals=("top_k_accuracy", "mean_class_accuracy"),
                     out: Optional[str] = None, reader=None) -> dict:
    """The checkpoint over the config's val split on `device` (None: the
    CUDA device): the report, and the scores written to `out` (npz).
    reader: a decord-alike reader for the pipeline's DecordInit."""
    model = load_recognizer(cfg, checkpoint, device)
    pipe = build_pipeline(with_reader(cfg["data.pipeline"], reader))
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
    if "top_k_accuracy" in evals:
        k = min(5, scores[0].shape[0])
        top1, topk = top_k_accuracy(scores, labels, (1, k))
        report["top1_acc"] = top1
        report[f"top{k}_acc"] = topk
    if "mean_class_accuracy" in evals:
        report["mean_class_accuracy"] = mean_class_accuracy(scores, labels)
    if out:
        np.savez(out, scores=np.stack(scores), labels=np.asarray(labels))
    return report


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
    report = test_from_config(cfg, args.checkpoint, args.device, args.eval,
                              args.out)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

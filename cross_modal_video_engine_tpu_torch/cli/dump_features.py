"""Dataset-scale per-layer embedding / gradient dumps.

Counterpart of cross_modal_video_engine_tpu/cli/dump_features.py, the
equivalent of the reference concept-bank builders MCT/tools/
inference_batch.py (per-video layer embeddings via OutputHook) and
inference_grad.py (per-video layer gradients of the max-class score):
iterate a dataset with a trained recognizer, capture the requested layer
CLS features (crop/clip-averaged, inference_batch.py:40-52) and/or the
class-score gradients at those layers, and write one pickle mapping
video filename -> {layer: vector}, the file format the CTV tooling
consumes (the JAX tool's format).

  python -m cross_modal_video_engine_tpu_torch.cli.dump_features CONFIG \\
      --checkpoint CKPT --mode embeddings|grads|both \\
      --layers 0 5 11 --out feats.pkl [--device cpu]

A batch runs one forward with capture (explain/grads.capture_forward);
the gradients are taken from its captured tokens through the rest of the
network (`class_score_grads`, grad_extract's second half), so the
embeddings and the gradients of mode `both` come from one forward, as
the JAX tool's two programs compute them.  `main(..., reader=)` hands
the pipeline's DecordInit a decord-alike reader (filename -> reader)
in place of opening the file; the default opens it with cv2.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch

from ..api import init_recognizer, model_device
from ..config import Config
from ..data.datasets import VideoDataset
from ..data.pipelines import build_pipeline, with_reader
from ..explain.grads import capture_forward, class_score_grads


def dump_features(model, state, dataset, layers, batch_size: int = 8,
                  mode: str = "embeddings", target_class=None):
    """Returns {video_name: {'pred': int, layer: vec, ('grad', layer): vec}}:
    CLS-token features averaged over clips/crops (inference_batch.py
    process_med_feats) and, for grads mode, the gradient CLS vectors.
    state: a state dict loaded into `model` first (the JAX tool's
    `variables`), or None for the model's own weights."""
    if state is not None:
        model.load_state_dict(state)
    layers = tuple(layers)
    dev = model_device(model)
    out = {}
    for imgs, items, n in dataset.batches(batch_size):
        # (B, n_clips, T, H, W, C): fold clips into the batch, average after
        B, n_clips = imgs.shape[0], imgs.shape[1]
        clips = torch.from_numpy(np.ascontiguousarray(
            imgs.reshape((B * n_clips,) + imgs.shape[2:]),
            np.float32)).to(dev)
        recs = [{} for _ in range(n)]
        scores, cls_idx, captured = capture_forward(model, clips, layers,
                                                    target_class)
        preds = scores.float().cpu().numpy().reshape(B, n_clips, -1).mean(1)
        for i in range(n):
            recs[i]["pred"] = int(preds[i].argmax())
        if mode in ("embeddings", "both"):
            for l in layers:
                cls = captured[l][:, 0].cpu().numpy()        # CLS token
                cls = cls.reshape(B, n_clips, -1).mean(1)    # crop average
                for i in range(n):
                    recs[i][l] = cls[i].astype(np.float32)
        if mode in ("grads", "both"):
            grads = class_score_grads(model, captured, cls_idx, layers)
            for l in layers:
                gcls = grads[l][:, 0].cpu().numpy().reshape(
                    B, n_clips, -1).mean(1)
                for i in range(n):
                    recs[i][("grad", l)] = gcls[i].astype(np.float32)
        for i in range(n):
            out[items[i]["filename"]] = recs[i]
    return out


def main(argv=None, *, device=None, reader=None):
    """device: overrides --device (None: --device, whose default is the
    CUDA device); reader: filename -> decord-alike reader for the
    pipeline's DecordInit (None: open the file)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--mode", default="embeddings",
                        choices=["embeddings", "grads", "both"])
    parser.add_argument("--layers", type=int, nargs="+", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--split", default="val")
    parser.add_argument("--target_class", type=int, default=None)
    parser.add_argument("--cfg-options", nargs="*", default=[])
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    model, _ = init_recognizer(args.checkpoint,
                               device=device if device is not None
                               else args.device)
    pipe = build_pipeline(with_reader(cfg["data.pipeline"], reader))
    ds = VideoDataset(cfg[f"data.{args.split}.ann_file"], pipe,
                      cfg.get(f"data.{args.split}.data_prefix"))
    bs = cfg.get("data.videos_per_gpu", 8)

    feats = dump_features(model, None, ds, args.layers, bs, args.mode,
                          args.target_class)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(feats, f)
    print(json.dumps({"videos": len(feats), "layers": args.layers,
                      "mode": args.mode, "out": args.out}))
    return feats


if __name__ == "__main__":
    main()

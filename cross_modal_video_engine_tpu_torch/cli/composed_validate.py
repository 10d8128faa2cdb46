"""Composed-retrieval validation CLI.

Counterpart of cross_modal_video_engine_tpu/cli/composed_validate.py
(MultiFusion/src/validate.py:27-143, `compute_cirr_val_metrics`): build
index features from the dataset's videos (frame-mean + normalize), predict
fused features for every relative-mode triplet, mask each query's
reference video out of the ranking, report recall@1/5/10/50, and dump the
top-100 ranking (the `results_wo_attn.npy` analogue).

  python -m cross_modal_video_engine_tpu_torch.cli.composed_validate \
      --triplets T.tsv --features_root FEATS --clip_checkpoint CKPT \
      --combiner_checkpoint CKPT2 --merges merges.txt [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.composed_dataset import ComposedVideoDataset, FeatureStore
from ..utils.bpe import BPETokenizer
from ..utils.device import resolve_device
from .combiner_trainer import (build_index_features, encode_texts, recalls,
                               validation_orders)
from .composed_inference import load_clip_tower, load_combiner


def validate(combiner, dataset, text_encode_fn, batch_size: int = 64):
    """(the top-100 ranking (Q, 100), report) on the combiner's device."""
    index_high = torch.from_numpy(build_index_features(dataset)).to(
        combiner.device)
    # the reference dumps the top-100 ranking
    order, gts = validation_orders(combiner, dataset, text_encode_fn,
                                   index_high, batch_size, top_k=100)
    report = recalls(order, gts)
    report["n_queries"] = int(len(gts))
    return order, report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--triplets", required=True)
    parser.add_argument("--features_root", required=True)
    parser.add_argument("--id2name", default=None)
    parser.add_argument("--clip_checkpoint", required=True)
    parser.add_argument("--combiner_checkpoint", required=True)
    parser.add_argument("--merges", required=True)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--output", default=None,
                        help="npy path for the top-100 ranking")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    clip_model, clip_cfg = load_clip_tower(args.clip_checkpoint, device)
    tok = BPETokenizer(args.merges)
    combiner = load_combiner(args.combiner_checkpoint, device,
                             require_config=True)
    dataset = ComposedVideoDataset(
        args.triplets, FeatureStore({"main": args.features_root}),
        args.id2name)

    def text_fn(caps):
        return encode_texts(clip_model, tok, caps, clip_cfg.context_length)

    order, report = validate(combiner, dataset, text_fn, args.batch_size)
    if args.output:
        np.save(args.output, order[:, :100])
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

"""Test-split evaluation CLI.

Counterpart of cross_modal_video_engine_tpu/cli/retrieval_tester.py and
parity surface for LINAS-engine/tester.py:41-141 + validate.py:15-90:
encodes the test split's videos and captions on the device, computes the
full error matrix, writes it (`pred_errors_matrix.npz`, the reference
writes pred_errors_matrix.pth.tar) and prints R@K / medr / meanr / mAP in
both directions plus rsum.

Usage:
  python -m cross_modal_video_engine_tpu_torch.cli.retrieval_tester \
      --checkpoint CKPT_DIR --rootpath ROOT --testCollection C \
      --visual_feature F [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..metrics.retrieval import cal_perf, get_gt
from .common import load_dataset, restore_dual_encoding
from .retrieval_inference import build_video_index


def evaluate(model, dataset, batch_size: int = 64):
    """(errors, report) of the dataset's captions against its videos; the
    dataset's batches must lie on the model's device."""
    index = build_video_index(model, dataset, batch_size)
    cap_chunks = []
    with torch.no_grad():
        for batch, n in dataset.text_batches(batch_size):
            cap_chunks.append(model.embed_txt_distill(batch)[:n])
    cap_emb = torch.cat(cap_chunks, 0).cpu().numpy()

    errors = index.full_errors(cap_emb)   # (n_captions, n_videos)
    v2t_gt, t2v_gt = get_gt(dataset.video_ids, dataset.cap_ids)
    (t2v_r, v2t_r, t2v_map_score, v2t_map_score) = cal_perf(
        errors, v2t_gt, t2v_gt)
    report = {
        "t2v": {"r1": t2v_r[0], "r5": t2v_r[1], "r10": t2v_r[2],
                "medr": t2v_r[3], "meanr": t2v_r[4], "map": t2v_map_score},
        "v2t": {"r1": v2t_r[0], "r5": v2t_r[1], "r10": v2t_r[2],
                "medr": v2t_r[3], "meanr": v2t_r[4], "map": v2t_map_score},
        "rsum": sum(t2v_r[:3]) + sum(v2t_r[:3]),
    }
    return errors, report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--rootpath", required=True)
    parser.add_argument("--testCollection", required=True)
    parser.add_argument("--visual_feature", required=True)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    model, _ = restore_dual_encoding(args.checkpoint, device=args.device)
    dataset = load_dataset(args.rootpath, args.testCollection,
                           args.visual_feature, device=model.device)
    errors, report = evaluate(model, dataset, args.batch_size)

    out_dir = args.output_dir or args.checkpoint
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "pred_errors_matrix.npz"), errors=errors,
             video_ids=np.array(dataset.video_ids),
             cap_ids=np.array(dataset.cap_ids))
    with open(os.path.join(out_dir, "test_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

"""Misc tools: the BSN proposal generation.

Counterpart of cross_modal_video_engine_tpu/cli/misc_tools.py, of which
the port holds `bsn_pgm`: TEM result curves -> PGM proposals csv + BSP
feature npy per video, the exact LoadProposals input contract
(misc/bsn_proposal_generation.py:32-157); its files are byte-equal to
the JAX tool's.  The other subcommands (flow_extraction, publish_model,
export_model, export_yolo) are refused: they come with the host tools,
ROADMAP.md queue 1 item 8i.

Usage: python -m cross_modal_video_engine_tpu_torch.cli.misc_tools bsn_pgm
    --tem_dir D --proposals_dir P --features_dir F [--ann_file A]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

UNPORTED = ("flow_extraction", "publish_model", "export_model",
            "export_yolo")


def refuse(args):
    from ..train.recognition_trainer import not_ported
    raise NotImplementedError(not_ported(f"the {args.cmd} tool", "8i"))


def bsn_pgm(args):
    """TEM curves (<tem_dir>/<vid>.npz: action/start/end (T,)) + optional
    ActivityNet-style gt json -> per-video proposals csv
    (tmin,tmax,tmin_score,tmax_score,score,match_iou) + BSP features."""
    from ..data.datasets_extra import ActivityNetDataset
    from ..metrics.proposals import pairwise_temporal_iou
    from ..models.bsn import match_boundaries, proposal_features

    gt_by_video = {}
    if args.ann_file:
        ds = ActivityNetDataset(args.ann_file, feature_prefix="",
                                temporal_dim=1)
        gt_by_video = {v["video"]: v["segments"] for v in ds.videos}

    os.makedirs(args.proposals_dir, exist_ok=True)
    os.makedirs(args.features_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(args.tem_dir)):
        if not name.endswith(".npz"):
            continue
        vid = name[:-4]
        tem = np.load(os.path.join(args.tem_dir, name))
        action, start, end = tem["action"], tem["start"], tem["end"]
        T = len(action)
        props = match_boundaries(start, end,
                                 max_proposals=args.max_proposals)
        if props.size == 0:
            # still write the files: the PEM dataset LoadProposals
            # np.loadtxt's every annotated video's csv — a missing file
            # would crash training mid-epoch.  One zero-score full-span
            # placeholder row keeps the contract.
            rows = np.asarray([[0.0, 1.0, 0.0, 0.0, 0.0, 0.0]],
                              np.float32)
            np.savetxt(os.path.join(args.proposals_dir, vid + ".csv"),
                       rows, delimiter=",", fmt="%.6f",
                       header="tmin,tmax,tmin_score,tmax_score,score,"
                              "match_iou")
            np.save(os.path.join(args.features_dir, vid + ".npy"),
                    proposal_features(
                        action, np.asarray([[0, T - 1, 0.0]],
                                           np.float32)))
            count += 1
            continue
        tmin, tmax = props[:, 0] / T, props[:, 1] / T
        rows = np.stack([
            tmin, tmax,
            start[props[:, 0].astype(int)],
            end[props[:, 1].astype(int)],
            props[:, 2],
            np.zeros(len(props), np.float32),
        ], axis=1)
        gt = gt_by_video.get(vid)
        if gt is not None and len(gt):
            iou, = (pairwise_temporal_iou(rows[:, :2], gt),)
            rows[:, 5] = iou.max(axis=0)
        np.savetxt(os.path.join(args.proposals_dir, vid + ".csv"), rows,
                   delimiter=",", fmt="%.6f",
                   header="tmin,tmax,tmin_score,tmax_score,score,match_iou")
        np.save(os.path.join(args.features_dir, vid + ".npy"),
                proposal_features(action, props))
        count += 1
    print(f"generated proposals for {count} videos")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("bsn_pgm")
    p.add_argument("--tem_dir", required=True)
    p.add_argument("--proposals_dir", required=True)
    p.add_argument("--features_dir", required=True)
    p.add_argument("--ann_file", default=None)
    p.add_argument("--max_proposals", type=int, default=200)
    p.set_defaults(fn=bsn_pgm)

    for cmd in UNPORTED:
        sub.add_parser(cmd).set_defaults(fn=refuse)

    # a refused subcommand takes whatever arguments the JAX tool takes
    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is not refuse:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main() or 0)

"""Misc / deployment tools (MCT/tools/misc + tools/deployment equivalents).

Counterpart of cross_modal_video_engine_tpu/cli/misc_tools.py; each
subcommand writes the bytes the JAX tool writes from the same inputs.

  flow_extraction: video -> quantized optical-flow rawframes
      (misc/flow_extraction.py:10-123; Farneback, the reference's own
      fallback `method='farneback'`, with the clip-to-[-bound,bound]
      uint8 quantization and flow_x/flow_y naming); the frames decode
      through io/native.NativeVideoReader and the flow is cv2's, so the
      tool needs cv2 and refuses with ImportError where it is missing
  bsn_pgm: TEM result curves -> PGM proposals csv + BSP feature npy per
      video, the exact LoadProposals input contract
      (misc/bsn_proposal_generation.py:32-157)
  publish_model: stamp a checkpoint file with its sha256 prefix
      (deployment/publish_model.py)

`export_model` and `export_yolo` (the serving artifacts) are refused:
they come with the checkpoint converters and exports, ROADMAP.md queue
1 item 8j.

Usage: python -m cross_modal_video_engine_tpu_torch.cli.misc_tools CMD ...
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np

UNPORTED = ("export_model", "export_yolo")


def refuse(args):
    from ..train.recognition_trainer import not_ported
    raise NotImplementedError(not_ported(f"the {args.cmd} tool", "8j"))


def flow_extraction(args):
    """Video -> quantized Farneback flow jpgs (misc/flow_extraction.py);
    cv2 is imported first, so on a machine without it the tool raises
    ImportError naming cv2."""
    import cv2

    from ..io.native import NativeVideoReader

    reader = NativeVideoReader(args.input)
    n = len(reader)
    os.makedirs(args.dest, exist_ok=True)
    bound = args.bound
    # stream in bounded chunks (a whole-video decode would exhaust host
    # memory on long inputs); keep one frame of overlap for the i -> i+1
    # flow pair
    chunk = 256
    prev_rgb = prev_gray = None
    written = 0
    for base in range(0, n, chunk):
        frames = reader.get_batch(list(range(base, min(base + chunk, n))))
        for off, frame in enumerate(frames):
            g = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
            if prev_gray is not None:
                i = base + off - 1
                flow = cv2.calcOpticalFlowFarneback(
                    prev_gray, g, None, 0.5, 3, 15, 3, 5, 1.2, 0)
                q = np.clip(flow, -bound, bound)
                q = ((q + bound) * (255.0 / (2 * bound))).astype(np.uint8)
                cv2.imwrite(os.path.join(args.dest, f"flow_x_{i:05d}.jpg"),
                            q[..., 0])
                cv2.imwrite(os.path.join(args.dest, f"flow_y_{i:05d}.jpg"),
                            q[..., 1])
                if args.save_rgb:
                    cv2.imwrite(os.path.join(args.dest, f"img_{i:05d}.jpg"),
                                prev_rgb[..., ::-1])
                written += 1
            prev_gray, prev_rgb = g, frame
    reader.release()
    print(f"wrote {written} flow frame pairs to {args.dest}")


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


def publish_model(args):
    with open(args.input, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:8]
    root, ext = os.path.splitext(args.input)
    out = f"{root}-{digest}{ext}"
    os.replace(args.input, out)
    print(out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("flow_extraction")
    p.add_argument("--input", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--bound", type=float, default=20.0)
    p.add_argument("--save_rgb", action="store_true")
    p.set_defaults(fn=flow_extraction)

    p = sub.add_parser("bsn_pgm")
    p.add_argument("--tem_dir", required=True)
    p.add_argument("--proposals_dir", required=True)
    p.add_argument("--features_dir", required=True)
    p.add_argument("--ann_file", default=None)
    p.add_argument("--max_proposals", type=int, default=200)
    p.set_defaults(fn=bsn_pgm)

    p = sub.add_parser("publish_model")
    p.add_argument("--input", required=True)
    p.set_defaults(fn=publish_model)

    for cmd in UNPORTED:
        sub.add_parser(cmd).set_defaults(fn=refuse)

    # a refused subcommand takes whatever arguments the JAX tool takes
    args, extra = parser.parse_known_args(argv)
    if extra and args.fn is not refuse:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main() or 0)

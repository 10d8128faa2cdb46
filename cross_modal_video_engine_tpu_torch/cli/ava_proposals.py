"""AVA person proposals from the port's YOLOv5 detector.

Counterpart of cross_modal_video_engine_tpu/cli/ava_proposals.py: for
every keyframe of an AVA annotation csv, the keyframe's centre frame
(SampleAVAFrames' centre, fps * (ts - ts0) + 1) through YOLOv5 on the
card unless `--device cpu`, the `person_class` boxes at or above `conf`
kept (at most `max_boxes`, by score), written as the normalized proposal
json that cli/detection_train reads through `data.train.proposal_file`:

    {"<video_id>,<tttt>": [[x1, y1, x2, y2], ...], ...}

    python -m cross_modal_video_engine_tpu_torch.cli.ava_proposals \\
        --ann_file ava_train.csv --data_prefix videos/ \\
        --yolo_checkpoint yolo_ckpt --out proposals.json [--device cpu]

The detector's checkpoint is a `save_checkpoint` directory in the JAX
package's format or a yolo_train `best/` directory
(cli/ctv_build.load_detector_checkpoint); frames are resized to the
square input by data/pipelines.resize_linear, cv2's INTER_LINEAR bit for
bit on uint8.  `reader=` (filename -> decord-alike reader) replaces the
file decode.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.datasets_extra import AVADataset
from ..data.pipelines import resize_linear
from ..io.video_decode import open_video
from ..metrics.ava import make_image_key
from ..models.yolo import decode_predictions, postprocess
from .ctv_build import load_detector_checkpoint


def keyframe_frame(path: str, timestamp: float, fps: float,
                   timestamp_start: float = 0.0,
                   reader: Optional[Callable] = None
                   ) -> Optional[np.ndarray]:
    """The keyframe's centre frame (uint8 (H, W, 3)), None for an empty
    video; reader: filename -> decord-alike reader (default open_video)."""
    video = (reader or open_video)(path)
    n = len(video)
    if n == 0:
        video.release()
        return None
    # +1: SampleAVAFrames' centre, fps * (ts - ts0) + 1
    idx = int(np.clip(round(fps * (timestamp - timestamp_start)) + 1,
                      0, n - 1))
    frame = video.get_batch([idx])[0]
    video.release()
    return frame


def person_proposals_for_frame(detector_fn: Callable, frame: np.ndarray,
                               person_class: int = 0, conf: float = 0.25,
                               max_boxes: int = 32) -> np.ndarray:
    """detector_fn: (1, H, W, 3) u8 -> [(n, 6) x1,y1,x2,y2,conf,cls in
    pixels].  Returns (m, 4) normalized x1y1x2y2 person boxes."""
    H, W = frame.shape[:2]
    det = np.asarray(detector_fn(frame[None])[0])
    if det.size == 0:
        return np.zeros((0, 4), np.float32)
    keep = (det[:, 5].astype(int) == person_class) & (det[:, 4] >= conf)
    det = det[keep]
    order = np.argsort(-det[:, 4])[:max_boxes]
    boxes = det[order, :4] / np.asarray([W, H, W, H], np.float32)
    return np.clip(boxes, 0.0, 1.0).astype(np.float32)


def build_proposals(ds: AVADataset, detector_fn: Callable, fps: float,
                    timestamp_start: float = 0.0, person_class: int = 0,
                    conf: float = 0.25, max_boxes: int = 32,
                    reader: Optional[Callable] = None) -> Dict[str, List]:
    out: Dict[str, List] = {}
    for i in range(len(ds)):
        kf = ds[i]
        frame = keyframe_frame(kf["filename"], kf["timestamp"], fps,
                               timestamp_start, reader)
        key = make_image_key(kf["video_id"], kf["timestamp"])
        if frame is None:
            out[key] = []
            continue
        boxes = person_proposals_for_frame(detector_fn, frame, person_class,
                                           conf, max_boxes)
        out[key] = [[float(v) for v in b] for b in boxes]
    return out


def make_yolo_detector(checkpoint: str, img_size: int = 640,
                       conf: float = 0.25, iou: float = 0.45, device=None):
    """uint8 frames (B, H, W, 3) -> per frame (n, 6) rows in the original
    frame's pixels: each frame resized to img_size², the detector on
    `device` (None: the CUDA device), decoded, NMS on the host."""
    detector = load_detector_checkpoint(checkpoint, device)
    dev = next(detector.parameters()).device

    @torch.no_grad()
    def detector_fn(frames_u8: np.ndarray) -> List[np.ndarray]:
        H, W = frames_u8.shape[1:3]
        imgs = np.stack([resize_linear(f, (img_size, img_size))
                         for f in frames_u8]).astype(np.float32) / 255.0
        preds = decode_predictions(detector(torch.from_numpy(imgs).to(dev)),
                                   detector.cfg)
        dets = postprocess(preds.cpu().numpy(), conf_thres=conf,
                           iou_thres=iou)
        scale = np.asarray([W / img_size, H / img_size] * 2, np.float32)
        return [np.concatenate([d[:, :4] * scale, d[:, 4:]], axis=1)
                if len(d) else d for d in dets]

    return detector_fn


def main(argv=None, reader=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ann_file", required=True)
    parser.add_argument("--data_prefix", default=None)
    parser.add_argument("--yolo_checkpoint", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--fps", type=float, default=30)
    parser.add_argument("--timestamp_start", type=float, default=0)
    parser.add_argument("--conf", type=float, default=0.25)
    parser.add_argument("--person_class", type=int, default=0)
    parser.add_argument("--img_size", type=int, default=640)
    parser.add_argument("--max_boxes", type=int, default=32)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)

    ds = AVADataset(args.ann_file, data_prefix=args.data_prefix)
    detector_fn = make_yolo_detector(args.yolo_checkpoint, args.img_size,
                                     args.conf, device=args.device)
    proposals = build_proposals(ds, detector_fn, args.fps,
                                args.timestamp_start, args.person_class,
                                args.conf, args.max_boxes, reader)
    with open(args.out, "w") as f:
        json.dump(proposals, f)
    n = sum(len(v) for v in proposals.values())
    print(json.dumps({"keyframes": len(proposals), "boxes": n,
                      "out": args.out}), flush=True)
    return proposals


if __name__ == "__main__":
    main()

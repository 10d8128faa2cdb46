"""Batch CTV-bank construction CLI.

Counterpart of cross_modal_video_engine_tpu/cli/ctv_build.py, the parity
surface for MCT/tools/ctvs/ctv_construction (raw_video_inference +
instance_level_ctv + the pipeline.sh class loop): for every video in a
list, detect concepts with the YOLOv5 detector, build per-class masked
clips in memory, embed raw + masked in one batch on the card, and
accumulate instance CTVs; emit symbolic (mean) and cluster (k-means)
concept banks as the npz `explain_demo` and the `/explain` route load.

    python -m cross_modal_video_engine_tpu_torch.cli.ctv_build \\
        --checkpoint CKPT --video_list videos.txt \\
        --detector_checkpoint YOLO --class_names names.json \\
        --output banks.npz [--target_layer L] [--min_frames 10] \\
        [--device cpu]

`--detector_checkpoint` takes a `save_checkpoint` directory (the JAX
package's format, as its ctv_build reads) or a detector trainer's `best/`
directory (cli/yolo_train.py).  The detector sees the decoded frames at
their own size, as in the JAX
package, so their height and width must be multiples of 32 (352x480, not
360x480): other sizes are refused before the detector runs
(models/yolo.SIZE_FAULT).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..api import init_recognizer, model_device
from ..convert.from_jax import yolo_state_dict_from_jax
from ..data.pipelines import build_pipeline, with_reader
from ..explain.ctv import (build_instance_ctvs, cluster_concept_vectors,
                           symbolic_concept_vectors)
from ..explain.masking import detect_video, per_class_masked_videos
from ..explain.model_layers import get_model_layers
from ..models.yolo import (SIZE_FAULT, YoloConfig, YoloV5,
                           decode_predictions, postprocess)
from ..train.checkpoint import load_checkpoint
from ..train.resume import LOOP_FILE, STATE_FILE, load_train_state
from ..utils.precision import no_tf32
from .caption_inference import DEFAULT_PIPELINE

DECODE_TYPES = ("DecordInit", "SampleFrames", "DecordDecode")


def _timed(times: Optional[Dict[str, float]], key: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    if times is not None:
        times[key] = times.get(key, 0.0) + time.perf_counter() - t0
    return out


def make_detector_fn(detector: YoloV5, conf_thres: float = 0.25,
                     iou_thres: float = 0.45, max_det: int = 300
                     ) -> Callable[[np.ndarray], list]:
    """frames (B, H, W, 3) uint8 -> per frame (n, 6) x1,y1,x2,y2,conf,cls:
    the detector on its device, decoded, and NMS on the host with the
    detect.py protocol (argmax class, conf 0.25, max 300)."""
    device = next(detector.parameters()).device

    @torch.no_grad()
    def detect(frames_u8: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(device)
        preds = decode_predictions(detector(x.float() / 255.0),
                                   detector.cfg)
        return postprocess(preds.cpu().numpy(), conf_thres, iou_thres,
                           max_det)
    return detect


def build_ctv_banks(model, video_paths, detector_fn, class_names,
                    target_layer: int, pipeline=None, min_frames: int = 10,
                    n_clusters: int = 3, reader=None,
                    times: Optional[Dict[str, float]] = None):
    """The banks of the videos (see the module docstring), embedded under
    no_grad through the recognizer's `forward_with_capture` on its
    device.  reader: filename -> decord-alike reader for the decode
    stage (data/pipelines.with_reader).  times: a dict that gathers the
    seconds of each phase (decode, detection, masking, embedding,
    clustering)."""
    pipe_cfg = list(pipeline or DEFAULT_PIPELINE)
    # raw frames for the detector come from the decode stage only; the
    # augment tail (resize/crop/normalize/format) re-runs on masked clips
    decode_pipe = build_pipeline(with_reader(
        [c for c in pipe_cfg if c["type"] in DECODE_TYPES], reader))
    tail_pipe = build_pipeline(
        [c for c in pipe_cfg if c["type"] not in DECODE_TYPES])
    device = model_device(model)

    def prep(clip_u8):
        res = tail_pipe({"imgs": list(clip_u8), "clip_len": len(clip_u8),
                         "num_clips": 1})
        return np.asarray(res["imgs"][0], np.float32)

    @torch.no_grad()
    def embed(stack_u8):
        batch = torch.from_numpy(np.stack([prep(c) for c in stack_u8]))
        _, cap = model.forward_with_capture(batch.to(device),
                                            (target_layer,))
        return cap[target_layer][:, 0].float().cpu().numpy()

    instance_ctvs = {}
    for path in video_paths:
        raw = _timed(times, "decode", lambda: np.stack(decode_pipe(
            {"filename": path, "start_index": 0})["imgs"]))
        h, w = raw.shape[1:3]
        if h % 32 or w % 32:
            raise ValueError(f"{path}: frames of {h}x{w}: {SIZE_FAULT}")
        dets = _timed(times, "detection", detect_video, detector_fn, raw)
        # the reference's >10-frame noise filter assumes the FULL video
        # is decoded (detect.py); a sampled pipeline may decode fewer
        # frames than min_frames: cap it so a concept present in every
        # sampled frame passes
        mf = min(min_frames, len(raw) - 1)
        masked = _timed(times, "masking", per_class_masked_videos, raw,
                        dets, class_names, mf)
        if not masked:
            continue
        ctvs = _timed(times, "embedding", build_instance_ctvs, embed, raw,
                      masked)
        for concept, vec in ctvs.items():
            instance_ctvs.setdefault(concept, []).append(vec)

    if not instance_ctvs:
        raise ValueError(
            "no masked clips produced any CTVs — no detector class "
            "passed the min_frames filter on any video (check the "
            "detector checkpoint/classes and the decode pipeline's "
            "frame count)")
    t0 = time.perf_counter()
    sym, sym_names = symbolic_concept_vectors(instance_ctvs)
    clus, clus_names = cluster_concept_vectors(instance_ctvs, n_clusters)
    if times is not None:
        times["clustering"] = times.get("clustering", 0.0) \
            + time.perf_counter() - t0
    inst_names, inst_vecs = [], []
    for c, vecs in sorted(instance_ctvs.items()):
        for i, v in enumerate(vecs):
            inst_names.append(f"{c}#{i}")
            inst_vecs.append(v)
    return {
        "symbolic_matrix": sym, "symbolic_names": np.array(sym_names),
        "cluster_matrix": clus, "cluster_names": np.array(clus_names),
        "instance_matrix": np.stack(inst_vecs),
        "instance_names": np.array(inst_names),
    }


def load_detector_checkpoint(path: str, device=None) -> YoloV5:
    """A detector checkpoint directory -> YoloV5 on the card unless a
    device is named; f32 with TF32 off.  Either a `save_checkpoint`
    directory in the JAX package's format (config.json holds the
    YoloConfig) or a trainer's `best/` directory (cli/yolo_train.py: the
    config's `model` dict and the anchors in loop_state.json)."""
    no_tf32()
    if os.path.exists(os.path.join(path, STATE_FILE)):
        from ..config import Config
        from .yolo_train import yolo_config
        with open(os.path.join(path, LOOP_FILE)) as f:
            loop = json.load(f)
        detector = YoloV5(yolo_config(Config({"model": loop["model"]})),
                          device=device)
        load_train_state(path, {"detector": detector})
        return detector
    variables, ycfg_d, _ = load_checkpoint(path)
    ycfg = YoloConfig(**{k: tuple(tuple(map(tuple, v)) for v in vs)
                         if k == "anchors" else vs
                         for k, vs in ycfg_d.items()})
    detector = YoloV5(ycfg, device=device)
    detector.load_state_dict(yolo_state_dict_from_jax(variables, ycfg))
    return detector


def main(argv=None, reader=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--video_list", required=True,
                        help="text file, one video path per line")
    parser.add_argument("--detector_checkpoint", required=True)
    parser.add_argument("--class_names", required=True,
                        help="json list of detector class names")
    parser.add_argument("--output", required=True, help="npz bank path")
    parser.add_argument("--target_layer", type=int, default=None)
    parser.add_argument("--min_frames", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    model, cfg_d = init_recognizer(args.checkpoint, device=args.device)
    # configs may rely on the TimeSformerConfig default
    n_layers = cfg_d["backbone"].get("num_layers", 12)
    target = (args.target_layer if args.target_layer is not None
              else get_model_layers("timesformer", n_layers)["target"])
    detector = load_detector_checkpoint(args.detector_checkpoint,
                                        args.device)
    videos = [l.strip() for l in open(args.video_list) if l.strip()]
    class_names = json.load(open(args.class_names))
    banks = build_ctv_banks(model, videos, make_detector_fn(detector),
                            class_names, target, min_frames=args.min_frames,
                            reader=reader)
    np.savez(args.output, **banks)
    print(f"wrote banks: {[f'{k}:{v.shape}' for k, v in banks.items() if hasattr(v, 'shape')]}")
    return banks


if __name__ == "__main__":
    main()

"""Video caption (label-sequence) generation CLI.

Counterpart of cross_modal_video_engine_tpu/cli/caption_inference.py, the
MCT seq_generate inference path (Recognizer3D_Relseq._do_test ->
RNNDecoderHead greedy loop, decoder_head.py:187-227): decode a video, run
the recognizer on the card (or `--device cpu`), print the thresholded
label sequence per step (optionally mapped through a label names file).

  python -m cross_modal_video_engine_tpu_torch.cli.caption_inference \\
      --checkpoint CKPT --video V.mp4 [--label_names names.json] \\
      [--threshold 0.5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..api import (TEST_PIPELINE, caption_clips, init_recognizer,
                   model_device, run_pipeline)

# the test pipeline, as api.TEST_PIPELINE defines it once
DEFAULT_PIPELINE = TEST_PIPELINE


def caption_video(model, video_path: str, pipeline=None,
                  threshold: float = 0.5):
    """The video's clips (num_clips, T, H, W, C) fold into one batch and
    their per-step probabilities are averaged (average_clip(...,
    seq_gen=True) semantics).  Returns (steps, probs): the labels above
    threshold at each step, and the (max_len, C) probabilities as float32
    numpy."""
    clips = run_pipeline(pipeline or DEFAULT_PIPELINE, video_path)
    steps, probs = caption_clips(
        model, torch.from_numpy(clips).to(model_device(model)),
        num_segs=clips.shape[0], threshold=threshold)
    return steps[0], probs[0].cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--video", required=True)
    parser.add_argument("--label_names", default=None,
                        help="json list of class names")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    model, _ = init_recognizer(args.checkpoint, device=args.device)
    steps, _ = caption_video(model, args.video, threshold=args.threshold)
    names = None
    if args.label_names:
        with open(args.label_names) as f:
            names = json.load(f)
    for t, labels in enumerate(steps):
        shown = [names[i] if names else str(i) for i in labels]
        print(f"step {t}: {' '.join(shown) if shown else '<none>'}")
    return steps


if __name__ == "__main__":
    main()

"""Explainable recognition demo CLI.

Counterpart of cross_modal_video_engine_tpu/cli/explain_demo.py, the
parity surface for MCT/tools/ctvs/inference_demo.py:283-321: classify a
video on the card (or `--device cpu`), extract the target-layer gradient
probe, and print top concepts at every interpretation level of the
concept banks.

  python -m cross_modal_video_engine_tpu_torch.cli.explain_demo \\
      --checkpoint CKPT --target_video_path V.mp4 \\
      [--concept_banks banks.npz] [--target_layer 10] [--topk 5] \\
      [--label_names names.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..api import init_recognizer, model_device, run_pipeline
from ..explain.pipeline import ConceptBank, explain_video
from ..models.recognizer import Recognizer3D
from .caption_inference import DEFAULT_PIPELINE


def load_concept_banks(path: str):
    """npz with arrays '<level>_matrix' and json lists '<level>_names'."""
    data = np.load(path, allow_pickle=True)
    banks = {}
    for key in data.files:
        if key.endswith("_matrix"):
            level = key[: -len("_matrix")]
            names = list(data[f"{level}_names"])
            banks[level] = ConceptBank(np.asarray(data[key], np.float32),
                                       [str(n) for n in names])
    return banks


def load_explain_model(checkpoint: str, device=None):
    """(model, cfg_d) of a classification checkpoint through
    `api.init_recognizer` (bf16 cast, TF32 off, parameters frozen).  The
    explain stack takes gradients through Recognizer3D's
    `score_from_layer`: a caption checkpoint (a config with `decoder`)
    is refused here."""
    model, cfg_d = init_recognizer(checkpoint, device=device)
    if not isinstance(model, Recognizer3D):
        raise ValueError(
            f"{checkpoint}: explainable recognition needs a classification "
            f"checkpoint (a config with num_classes); this one holds a "
            f"caption model (its config has a decoder)")
    return model, cfg_d


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--target_video_path", required=True)
    parser.add_argument("--concept_banks", default=None,
                        help="npz of {level}_matrix / {level}_names")
    parser.add_argument("--target_layer", type=int, default=10)
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--label_names", default=None)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    model, _ = load_explain_model(args.checkpoint, args.device)
    clips = torch.from_numpy(run_pipeline(
        DEFAULT_PIPELINE, args.target_video_path)).to(model_device(model))

    banks = load_concept_banks(args.concept_banks) if args.concept_banks else {}
    out = explain_video(model, clips, target_layer=args.target_layer,
                        concept_banks=banks, topk=args.topk)
    names = None
    if args.label_names:
        with open(args.label_names) as f:
            names = json.load(f)
    pred = int(out["pred"][0])
    print(f"prediction: {names[pred] if names else pred}")
    for level in banks:
        print(f"[{level}] top concepts:")
        for name, score in out[f"{level}_top"]:
            print(f"  {name}\t{score:+.4f}")
    return out


if __name__ == "__main__":
    main()

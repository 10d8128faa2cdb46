"""End-to-end explainability pipeline (inference_demo equivalent).

Counterpart of cross_modal_video_engine_tpu/explain/pipeline.py, the
MCT/tools/ctvs/inference_demo.py:283-321 flow as a library call:

  1. recognize the clip and extract the target-layer gradient probe;
  2. detect concepts per frame, build per-class masked clips in memory;
  3. instance CTVs = embed(raw) - embed(masked) in one batched call on
     the model's device;
  4. score precomputed symbolic/cluster/instance concept banks against the
     gradient, return top-k interpretations per level.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .ctv import build_instance_ctvs, concept_scores, top_concepts
from .grads import grad_extract, normalized_cls_grad
from .masking import detect_video, per_class_masked_videos


@dataclasses.dataclass
class ConceptBank:
    """A (n_concepts, D) matrix with names, per interpretation level."""
    matrix: np.ndarray
    names: List[str]


def _on_model_device(model, x) -> torch.Tensor:
    """A float32 batch (numpy or tensor) on the model's device."""
    device = next(model.parameters()).device
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device)


def explain_video(model, frames_batch, target_layer: int,
                  concept_banks: Dict[str, ConceptBank],
                  detector_fn: Optional[Callable] = None,
                  raw_frames_u8: Optional[np.ndarray] = None,
                  class_names: Optional[Sequence[str]] = None,
                  preprocess_fn: Optional[Callable] = None,
                  min_frames: int = 10, topk: int = 5) -> Dict:
    """frames_batch: model-ready (B, T, H, W, 3), a tensor or numpy array
    (moved to the model's device).  If detector_fn + raw_frames_u8 are
    given, instance-level CTVs for THIS video are built on the fly
    (inference_demo get_video_ctvs, :116-149)."""
    out: Dict = {}

    g = grad_extract(model, _on_model_device(model, frames_batch),
                     [target_layer])
    out["pred"] = g["pred"]
    out["scores"] = g["scores"]
    grad_probe = normalized_cls_grad(g["gradients"][target_layer])
    out["grad_probe"] = grad_probe

    for level, bank in concept_banks.items():
        s = concept_scores(bank.matrix, grad_probe)
        out[f"{level}_scores"] = s
        out[f"{level}_top"] = top_concepts(s, bank.names, topk)

    if detector_fn is not None and raw_frames_u8 is not None:
        dets = detect_video(detector_fn, raw_frames_u8)
        masked = per_class_masked_videos(
            raw_frames_u8, dets,
            class_names or [str(i) for i in range(10000)], min_frames)
        out["detected_concepts"] = sorted(masked)
        if masked:
            if preprocess_fn is None:
                raise ValueError(
                    "instance CTVs need preprocess_fn: the masked uint8 "
                    "clips must go through the SAME normalization as "
                    "frames_batch (a bare float cast would embed raw "
                    "0-255 pixels in a different input regime than the "
                    "gradient probe, making the CTV scores meaningless)")
            prep = preprocess_fn

            def embed(stack_u8):
                # stack_u8: (N, T, H, W, 3) uint8 clips -> layer CLS feats
                batch = _on_model_device(model, np.stack(
                    [np.asarray(prep(clip)) for clip in stack_u8]))
                with torch.no_grad():
                    _, cap = model.forward_with_capture(batch,
                                                        (target_layer,))
                return cap[target_layer][:, 0].cpu().numpy()

            # ONE batched call embeds raw + every masked clip
            ctvs = build_instance_ctvs(embed, raw_frames_u8, masked)
            out["video_ctvs"] = ctvs
            names = sorted(ctvs)
            mat = np.stack([ctvs[n] for n in names])
            s = concept_scores(mat, grad_probe)
            out["video_ctv_top"] = top_concepts(s, names, topk)
    return out

"""High-level recognition and caption API.

Counterpart of cross_modal_video_engine_tpu/api.py's `init_recognizer`
and of the model half of cli/caption_inference.py's `caption_video`:

* `init_recognizer(cfg_d, state_dict)` builds the recognizer a
  checkpoint's config dict names (`backbone`, then `decoder` for a
  caption model or `num_classes` for a classifier), applies the bf16
  inference cast the JAX loader applies (utils/precision.py), loads the
  weights, and returns the model ready to serve (eval mode, parameters
  frozen).  Reading the JAX checkpoint files (`params.msgpack`) and the
  non-TimeSformer caption backbones are not ported yet.
* `caption_clips(model, clips)` runs `forward_test` on normalised clips
  and thresholds the per-step probabilities.  Video decoding and the
  test pipeline are host code the port does not have yet; when it needs
  them it keeps its own copy (the port imports nothing of the JAX
  package).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .models.decoder_head import RNNDecoderConfig
from .models.recognizer import Recognizer3D, Recognizer3DRelseq
from .models.timesformer import TimeSformerConfig
from .utils.precision import maybe_cast_bf16


def init_recognizer(cfg_d: dict, state_dict: Dict[str, torch.Tensor],
                    device=None):
    """Returns (model, cfg_d); device=None builds on the CUDA device."""
    bb_kw = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cfg_d["backbone"].items()}
    btype = bb_kw.pop("type", "TimeSformer")
    if btype != "TimeSformer":
        raise NotImplementedError(f"backbone type {btype!r}: only TimeSformer "
                                  f"recognizers are ported")
    backbone = TimeSformerConfig(**bb_kw)
    if "decoder" in cfg_d:
        model = Recognizer3DRelseq(
            backbone, RNNDecoderConfig(**cfg_d["decoder"]), device=device)
    else:
        model = Recognizer3D(backbone, num_classes=cfg_d["num_classes"],
                             device=device)
    model.load_state_dict(maybe_cast_bf16(state_dict, cfg_d))
    return model.eval().requires_grad_(False), cfg_d


def caption_clips(model: Recognizer3DRelseq, clips: torch.Tensor,
                  num_segs: Optional[int] = None, threshold: float = 0.5
                  ) -> Tuple[List[List[List[int]]], torch.Tensor]:
    """clips: normalised (V * num_segs, T, H, W, 3), num_segs clips per
    video (default: all clips are one video, as caption_video has it).
    Returns (steps, probs): steps[v][i] the labels of video v at step i
    (probability > threshold), probs (V, max_len, num_classes) fp32."""
    with torch.no_grad():
        probs = model.forward_test(
            clips, num_segs=clips.shape[0] if num_segs is None else num_segs)
    on = (probs > threshold).cpu()
    steps = [[row.nonzero().flatten().tolist() for row in video]
             for video in on]
    return steps, probs

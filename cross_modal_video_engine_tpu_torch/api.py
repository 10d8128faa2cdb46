"""High-level recognition and caption API.

Counterpart of cross_modal_video_engine_tpu/api.py (MCT mmaction/apis):

* `init_recognizer(checkpoint)` rebuilds the recognizer a checkpoint in
  the JAX package's format holds (`train/checkpoint.load_checkpoint`, the
  variables through `convert.recognizer_state_dict_from_jax`), or the one
  a config dict names with a state dict (`init_recognizer(cfg_d,
  state_dict)`): `backbone`, then `decoder` for a caption model or
  `num_classes` for a classifier.  A checkpoint of a CNN backbone
  (ResNet3D/SlowOnly, CSN, SlowFast, X3D, C3D, R2Plus1D, and the
  per-frame TSM, TSN, TIN, TINExact, TANet and MobileNetV2TSM behind the
  temporal mean) or of a transformer (Swin3D, MViT, VideoMAEViT;
  `backbone.type`) is a caption model, a RecognizerRelseq on
  `cli/recognition_train.build_caption_backbone` with its params and
  batch_stats (`convert.conv_recognizer_state_dict_from_jax`); one
  without a decoder is refused, as the JAX loader's assert refuses it
  (cli/recognition_test rebuilds such classifiers from their config).
  It applies the bf16 inference cast the JAX loader applies
  (utils/precision.py: a TimeSformer recognizer is cast whole to bf16
  after loading; a VideoMAE configured in bf16 holds the rounded
  values in its f32 parameters, and its layers name their dtypes, so it
  computes what the JAX model computes on the cast tree) and returns the
  model ready to serve (eval mode, parameters frozen) on the card unless
  a device is named.  'CLIP' and 'VideoCLIP' build no caption backbone
  and raise "unknown backbone type", as the JAX loader does.
* `inference_recognizer(model, video, outputs=...)` runs the test
  pipeline on a video and the recognizer on its clips, with the
  `outputs=` layer capture, the `centercrop` toggle and the `shuffle_idx`
  frame-permutation probe (apis/inference.py:56-192).
* `caption_clips(model, clips)` runs `forward_test` on normalised clips
  and thresholds the per-step probabilities.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .convert.from_jax import (conv_recognizer_state_dict_from_jax,
                              recognizer_state_dict_from_jax)
from .data.pipelines import build_pipeline
from .models.decoder_head import RNNDecoderConfig
from .models.recognizer import (Recognizer3D, Recognizer3DRelseq,
                                RecognizerRelseq)
from .models.timesformer import TimeSformerConfig
from .train.checkpoint import load_checkpoint
from .utils.precision import (maybe_cast_bf16, maybe_cast_model_bf16,
                              no_tf32)

TEST_PIPELINE = [
    dict(type="DecordInit"),
    dict(type="SampleFrames", clip_len=8, frame_interval=32, num_clips=1,
         test_mode=True),
    dict(type="DecordDecode"),
    dict(type="Resize", scale=(-1, 256)),
    dict(type="CenterCrop", crop_size=224),
    dict(type="Normalize", mean=[127.5] * 3, std=[127.5] * 3),
    dict(type="FormatShape", input_format="NTHWC"),
]


def init_recognizer(checkpoint, state_dict: Optional[Dict[str, torch.Tensor]]
                    = None, device=None):
    """checkpoint: the directory of a checkpoint in the JAX package's
    format, or a config dict given with `state_dict` (the port's keys).
    Returns (model, cfg_d); device=None builds on the CUDA device.  The
    f32 products run in f32 there: TF32 is turned off for the process."""
    if isinstance(checkpoint, dict):
        if state_dict is None:
            raise ValueError("a config dict needs its state_dict")
        cfg_d = checkpoint
    else:
        variables, cfg_d, _ = load_checkpoint(checkpoint)
    bb_kw = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cfg_d["backbone"].items()}
    btype = bb_kw.pop("type", "TimeSformer")
    if btype != "TimeSformer":
        return _init_caption_backbone(btype, bb_kw, cfg_d, state_dict,
                                      None if state_dict is not None
                                      else variables, device)
    backbone = TimeSformerConfig(**bb_kw)
    if state_dict is None:
        state_dict = recognizer_state_dict_from_jax(variables, backbone)
    no_tf32()
    if "decoder" in cfg_d:
        model = Recognizer3DRelseq(
            backbone, RNNDecoderConfig(**cfg_d["decoder"]), device=device)
    else:
        model = Recognizer3D(backbone, num_classes=cfg_d["num_classes"],
                             device=device)
    model.load_state_dict(maybe_cast_bf16(state_dict, cfg_d))
    maybe_cast_model_bf16(model, cfg_d)
    return model.eval().requires_grad_(False), cfg_d


def _init_caption_backbone(btype: str, bb_kw: dict, cfg_d: dict,
                           state_dict, variables, device):
    """The non-TimeSformer arm (JAX api.py:47-54): a RecognizerRelseq."""
    from .cli.recognition_train import _deep_tuple, build_caption_backbone
    from .utils.device import resolve_device
    if "decoder" not in cfg_d:
        raise ValueError(f"a {btype!r} checkpoint is a caption model: its "
                         f"config has no decoder (the JAX package's "
                         f"init_recognizer refuses it too)")
    no_tf32()
    kw = {k: _deep_tuple(v) for k, v in bb_kw.items()}
    # a ResNet3D stem's input channels from its weights (PoseC3D's are the
    # heatmap channels)
    in_channels = 3
    if btype in ("ResNet3D", "SlowOnly"):
        in_channels = int(
            state_dict["backbone.conv1.conv.weight"].shape[1]
            if state_dict is not None else
            variables["params"]["backbone"]["conv1"]["kernel"].shape[-2])
    model = RecognizerRelseq(
        build_caption_backbone(btype, kw, resolve_device(device),
                               in_channels=in_channels),
        RNNDecoderConfig(**cfg_d["decoder"]))
    if state_dict is None:
        state_dict = conv_recognizer_state_dict_from_jax(variables, model)
    model.load_state_dict(maybe_cast_bf16(state_dict, cfg_d))
    return model.eval().requires_grad_(False), cfg_d


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def run_pipeline(pipeline: Sequence[dict], video: str) -> np.ndarray:
    """The pipeline over one video: its clips as float32
    (num_clips, T, H, W, C)."""
    r = build_pipeline(pipeline)({"filename": video, "start_index": 0})
    return np.asarray(r["imgs"], np.float32)


def inference_recognizer(model, video: str,
                         outputs: Optional[Sequence[int]] = None,
                         pipeline: Optional[list] = None,
                         centercrop: bool = True,
                         shuffle_idx: Optional[Sequence[int]] = None,
                         return_scores: bool = True
                         ) -> Tuple[Optional[np.ndarray],
                                    Dict[int, np.ndarray]]:
    """Run a video through the test pipeline and the recognizer, on the
    model's device.  outputs: backbone block indices to capture (the
    OutputHook equivalent, `forward_with_capture`).  Returns (scores or
    None, {layer: tokens}) as float32 numpy."""
    # copy the op dicts, not just the list: centercrop=False rewrites
    # the Resize entry, which must not change the caller's pipeline
    pipe_cfg = [dict(c) for c in (pipeline or TEST_PIPELINE)]
    if not centercrop:
        pipe_cfg = [c for c in pipe_cfg if c.get("type") != "CenterCrop"]
        for c in pipe_cfg:
            if c.get("type") == "Resize":
                c["scale"] = (224, 224)
                c["keep_ratio"] = False
    if shuffle_idx is not None:
        insert_at = next((i for i, c in enumerate(pipe_cfg)
                          if c["type"] == "Resize"), None)
        if insert_at is None:
            raise ValueError(
                "shuffle_idx needs a Resize op in the pipeline as its "
                "insertion anchor; none found")
        pipe_cfg.insert(insert_at,
                        dict(type="RandomShuffleFrames",
                             shuffle_idx=list(shuffle_idx)))
    clips = torch.from_numpy(run_pipeline(pipe_cfg, video)).to(
        model_device(model))
    with torch.no_grad():
        if outputs:
            scores, captured = model.forward_with_capture(clips,
                                                          tuple(outputs))
            captured = {k: v.float().cpu().numpy()
                        for k, v in captured.items()}
        else:
            scores, captured = model(clips), {}
    return (scores.float().cpu().numpy() if return_scores else None), captured


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

"""Composed text+video retrieval CLI.

Counterpart of cross_modal_video_engine_tpu/cli/composed_inference.py
(MultiFusion/src/inference.py:119-239): given a reference video file and a
modification text, extract CLIP features live, fuse them with the
Combiner, rank an index of candidate videos, report (and optionally copy)
the top hits.  Both checkpoints are in the JAX package's format.  A CLIP
checkpoint whose config has `patch_size` is a ViT (run with the fused
sublayer kernels on the card, `enable_fused_inference`); any other is the
ModifiedResNet tower (the RN50x4 contract, inference.py:179-196), f32 with
TF32 off.

Feature extraction is two steps: `decode_video_frames` (OpenCV, on the
host) and `encode_video_frames` (a uint8 (F, H, W, 3) array through
clip_preprocess and the vision tower on the device), so already-decoded
frames can be fed without cv2.

Usage:
  python -m cross_modal_video_engine_tpu_torch.cli.composed_inference \
      --input_vdo ref.mp4 --input_modified_text "make it red" \
      --videos_dir dataset/videos --clip_checkpoint CKPT \
      --combiner_checkpoint CKPT2 --merges merges.txt [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.from_jax import (clip_resnet_state_dict_from_jax,
                                clip_state_dict_from_jax,
                                combiner_state_dict_from_jax)
from ..data.composed_dataset import save_video_features
from ..io.video_decode import open_video
from ..models.clip import CLIPConfig, CLIPModel, enable_fused_inference
from ..models.clip_resnet import CLIPResNetConfig, CLIPResNetModel
from ..models.combiner import Combiner, CombinerConfig
from ..ops.preprocess import clip_preprocess
from ..ops.similarity import l2norm
from ..train.checkpoint import load_checkpoint
from ..utils.bpe import BPETokenizer
from ..utils.device import resolve_device
from ..utils.precision import no_tf32

VIDEO_EXTS = ("mp4", "avi", "mkv", "webm", "mov")


def _loaded(model: torch.nn.Module, sd, device) -> torch.nn.Module:
    """A model built on the meta device, materialized on `device` and
    filled from the state dict (no random init is drawn)."""
    model.to_empty(device=device)
    model.load_state_dict(sd)
    return model.eval()


def load_clip_tower(path: str, device=None):
    """(model, cfg) of a CLIP checkpoint on `device` (None: the CUDA
    device): a ViT (`patch_size` in its config) with the fused sublayers
    where the device is CUDA, else the ModifiedResNet tower."""
    device = resolve_device(device)
    variables, cfg_d, _ = load_checkpoint(path)
    no_tf32()
    if "patch_size" in cfg_d:
        cfg = enable_fused_inference(CLIPConfig(**cfg_d), device=device)
        sd = clip_state_dict_from_jax(variables, cfg)
        return _loaded(CLIPModel(cfg, device="meta"), sd, device), cfg
    cfg_d = dict(cfg_d, vision_layers=tuple(cfg_d["vision_layers"]))
    cfg = CLIPResNetConfig(**cfg_d)
    sd = clip_resnet_state_dict_from_jax(variables, cfg)
    return _loaded(CLIPResNetModel(cfg, device="meta"), sd, device), cfg


def load_combiner(path: str, device=None, require_config: bool = False
                  ) -> Combiner:
    """The Combiner of a checkpoint on `device` (None: the CUDA device).
    require_config: raise when the checkpoint carries no CombinerConfig
    (defaults would silently mismatch its weights)."""
    variables, cfg_d, _ = load_checkpoint(path)
    if require_config and not cfg_d:
        raise ValueError(
            f"{path} has no CombinerConfig — re-save with the config "
            "(combiner_trainer embeds it); rebuilding from defaults would "
            "silently mismatch")
    cfg = CombinerConfig(**cfg_d)
    sd = combiner_state_dict_from_jax(variables, cfg)
    return _loaded(Combiner(cfg, device="meta"), sd, resolve_device(device))


def decode_video_frames(path: str, stride: int = 8,
                        max_frames: int = 64) -> np.ndarray:
    """Every `stride`-th frame, at most `max_frames`, as RGB uint8 (F, H,
    W, 3) (MultiFusion utils.extract_vdo_features, utils.py:22-29)."""
    reader = open_video(path)
    try:
        idx = list(range(0, len(reader), stride))[:max_frames]
        return reader.get_batch(idx)
    finally:
        reader.release()


@torch.no_grad()
def encode_video_frames(clip_model, frames_u8, dim: int = 224
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 (F, H, W, 3) frames -> (high (F, E), middle (F, L, C)), f32
    on the model's device: all frames in one device batch (the reference
    loops per frame)."""
    device = next(clip_model.parameters()).device
    x = torch.as_tensor(frames_u8).to(device)
    high, middle = clip_model.encode_image(clip_preprocess(x, dim=dim))
    return high.float(), middle.float()


def extract_video_features(clip_model, path: str, stride: int = 8,
                           dim: int = 224, max_frames: int = 64):
    """decode_video_frames, then encode_video_frames."""
    return encode_video_frames(
        clip_model, decode_video_frames(path, stride, max_frames), dim)


def pool_frames(high: torch.Tensor, frames: int = 8) -> torch.Tensor:
    """(F, D) -> (frames, D) by adaptive average pooling over F."""
    return F.adaptive_avg_pool1d(high.t()[None], frames)[0].t()


def build_combiner_inputs(high: torch.Tensor, middle: torch.Tensor,
                          frames: int = 8, tokens: int = 16,
                          dim: Optional[int] = None):
    """Adaptive-average-pool high to (frames, D) and middle to (frames,
    tokens, dim or C) (reference inference.py:58-59; for RN50x4 middles
    the channel axis pools 1280 -> 640 too), with torch's bins, which are
    data/composed_dataset.adaptive_avg_pool_axis's."""
    size = (frames, tokens, middle.shape[-1] if dim is None else dim)
    return (pool_frames(high, frames),
            F.adaptive_avg_pool3d(middle[None, None], size)[0, 0])


def list_videos(videos_dir: str) -> List[str]:
    return sorted(f for f in os.listdir(videos_dir)
                  if f.split(".")[-1].lower() in VIDEO_EXTS)


def candidate_index(clip_model, dim: int, videos_dir: str,
                    feature_cache: Optional[str] = None,
                    decode: Callable = decode_video_frames):
    """(names, index_high (N, 8, E) on the model's device) over the videos
    of a directory.  A video with a `<name>.npz` under `feature_cache` is
    read from it; any other is decoded and encoded, and cached there when
    a cache directory is given."""
    device = next(clip_model.parameters()).device
    names = list_videos(videos_dir)
    index_high = []
    for name in names:
        cache = (os.path.join(feature_cache, name + ".npz")
                 if feature_cache else None)
        if cache and os.path.exists(cache):
            with np.load(cache) as d:
                h = torch.from_numpy(np.asarray(d["high_feature"],
                                                np.float32)).to(device)
        else:
            h, m = encode_video_frames(
                clip_model, decode(os.path.join(videos_dir, name)), dim)
            if cache:
                os.makedirs(feature_cache, exist_ok=True)
                save_video_features(cache, h.cpu().numpy(), m.cpu().numpy())
        index_high.append(pool_frames(h))
    return names, torch.stack(index_high)


def normalized_index(index_high: torch.Tensor) -> torch.Tensor:
    """(N, F, D) -> (N, D): the frame mean, L2-normalized."""
    return l2norm(index_high.mean(dim=1))


@torch.no_grad()
def rank_index(combiner: Combiner, ref_high, ref_middle, text_feat,
               index_high: torch.Tensor) -> np.ndarray:
    """The candidates' rows in order of distance 1 - cos, nearest first."""
    pred = combiner.combine_features((ref_high[None], ref_middle[None]),
                                     text_feat)
    scores = 1.0 - pred @ normalized_index(index_high).t()
    return torch.argsort(scores[0]).cpu().numpy()


@torch.no_grad()
def encode_text(clip_model, tok: BPETokenizer, texts, context_length: int
                ) -> torch.Tensor:
    device = next(clip_model.parameters()).device
    ids = torch.from_numpy(tok.tokenize(texts, context_length)).to(
        device, torch.int64)
    return clip_model.encode_text(ids).float()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_vdo", required=True)
    parser.add_argument("--input_modified_text", required=True)
    parser.add_argument("--videos_dir", required=True)
    parser.add_argument("--clip_checkpoint", required=True)
    parser.add_argument("--combiner_checkpoint", required=True)
    parser.add_argument("--merges", required=True)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--topK", type=int, default=1)
    parser.add_argument("--feature_cache", default=None)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)

    clip_model, clip_cfg = load_clip_tower(args.clip_checkpoint, args.device)
    combiner = load_combiner(args.combiner_checkpoint, args.device)
    tok = BPETokenizer(args.merges)
    dim = clip_cfg.image_resolution

    # reference video features (live extraction)
    rh, rm = extract_video_features(clip_model, args.input_vdo, dim=dim)
    ref_high, ref_middle = build_combiner_inputs(
        rh, rm, dim=combiner.cfg.clip_feature_dim)
    text_feat = encode_text(clip_model, tok, args.input_modified_text,
                            clip_cfg.context_length)

    names, index_high = candidate_index(clip_model, dim, args.videos_dir,
                                        args.feature_cache)
    order = rank_index(combiner, ref_high, ref_middle, text_feat, index_high)
    for i in order[: args.topK]:
        print(names[i])
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        shutil.copy(os.path.join(args.videos_dir, names[order[0]]),
                    os.path.join(args.output_dir, names[order[0]]))
    return [names[i] for i in order[: args.topK]]


if __name__ == "__main__":
    main()

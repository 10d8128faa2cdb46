"""uint8 ingest: frames -> normalized patch tokens, on the device.

Counterpart of cross_modal_video_engine_tpu/ops/pallas_preprocess.py.  The
JAX package has no Pallas kernel here (XLA fuses the relayout into one
pass); the port runs the same math as plain torch ops.  The host ships
uint8 frames, and the tokens feed the patch-embedding GEMM directly
(models/clip.py PatchEmbed `tokens=` path).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .preprocess import CLIP_MEAN, CLIP_STD, patchify


def channel_affine(mean: Sequence[float] = CLIP_MEAN,
                   std: Sequence[float] = CLIP_STD,
                   patch: int = 32, channels: int = 3,
                   max_value: float = 255.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token-column scale/shift so that
    token * scale + shift == ((u8 / max) - mean) / std, tiled to the
    (p, p, C) row-major token layout."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    scale_c = 1.0 / (max_value * std)
    shift_c = -mean / std
    reps = patch * patch
    return (np.tile(scale_c, reps).astype(np.float32),
            np.tile(shift_c, reps).astype(np.float32))


def u8_to_patches(frames_u8: torch.Tensor, patch: int = 32,
                  mean: Sequence[float] = CLIP_MEAN,
                  std: Sequence[float] = CLIP_STD,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, H, W, C) uint8 -> (N, (H/p)*(W/p), p*p*C) normalized tokens.

    `tokens @ conv_weight.permute(2, 3, 1, 0).reshape(-1, width)` equals
    the strided patch-embedding conv.  The affine runs in out_dtype, as in
    the JAX package: uint8 values are exact in bf16, and bf16 parity with
    it depends on rounding at the same points.
    """
    c = frames_u8.shape[-1]
    scale, shift = channel_affine(mean, std, patch, c)
    dev = frames_u8.device
    toks = patchify(frames_u8, patch).to(out_dtype)
    return (toks * torch.from_numpy(scale).to(dev, out_dtype)
            + torch.from_numpy(shift).to(dev, out_dtype))

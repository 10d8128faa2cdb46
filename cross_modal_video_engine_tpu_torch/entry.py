"""The flagship forward step: `entry()`.

Counterpart of the JAX package's `__graft_entry__.entry()`: CLIP ViT-B/32
in bf16 with the fused sublayers on, embedding one batch of 2 videos of
8 x 224^2 frames, weights 0.02 * N(0, 1) and frames N(0, 1) from
np.random.default_rng(0).  Returns `(fn, (model, frames))`; `fn(model,
frames)` is `encode_video`'s `high`, (videos, frames, embed_dim) in fp32.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .models.clip import (CLIPConfig, CLIPModel, flagship_config,
                          seeded_state_dict)
from .utils.device import resolve_device


def entry(device=None, *, cfg: Optional[CLIPConfig] = None, videos: int = 2,
          frames: int = 8
          ) -> Tuple[Callable, Tuple[CLIPModel, torch.Tensor]]:
    """device=None is the CUDA device.  `cfg` defaults to the flagship
    configuration with fused_attn and fused_mlp on; tests pass a small
    one."""
    device = resolve_device(device)
    if cfg is None:
        cfg = flagship_config(fused_attn=True, fused_mlp=True)
    rng = np.random.default_rng(0)
    res = cfg.image_resolution
    clip = torch.from_numpy(rng.standard_normal(
        (videos, frames, res, res, 3)).astype(np.float32)).to(device)
    model = CLIPModel(cfg, device=device)
    model.load_state_dict(seeded_state_dict(cfg, seed=0))
    model.eval().requires_grad_(False)

    def fn(model: CLIPModel, clip: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            high, _middle = model.encode_video(clip)
        return high

    return fn, (model, clip)

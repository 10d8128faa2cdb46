"""Frame preprocessing constants and the patch relayout.

Counterpart of cross_modal_video_engine_tpu/ops/preprocess.py; only what
the video-embedding path uses is ported so far.
"""

from __future__ import annotations

import torch

# public CLIP normalization constants (data_utils.py:83)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/p * W/p, p*p*C), tokens in (p, p, C)
    row-major order, grid in row-major order."""
    *lead, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(*lead, gh, patch, gw, patch, c)
    nd = x.dim()
    # (..., gh, p, gw, p, C) -> (..., gh, gw, p, p, C)
    perm = list(range(nd - 5)) + [nd - 5, nd - 3, nd - 4, nd - 2, nd - 1]
    return x.permute(*perm).reshape(*lead, gh * gw, patch * patch * c)

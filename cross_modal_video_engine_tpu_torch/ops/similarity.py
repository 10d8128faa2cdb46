"""Similarity helpers.

Counterpart of cross_modal_video_engine_tpu/ops/similarity.py; only
`l2norm` is ported so far (the measures and cal_error come with the
text->video retrieval slice).
"""

from __future__ import annotations

import torch


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim`; the eps guard keeps an all-zero row
    (a padded or blank batch entry) at zero instead of NaN."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, eps)

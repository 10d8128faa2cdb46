"""AVA spatio-temporal action detection head (RoI head), in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/ava_head.py (the
reference's bbox_head.py:34-118 and the RoIAlign its roi extractor calls):
the backbone's map is pooled over time, each person box is RoIAligned,
pooled over space and classified by a multilabel sigmoid head (class 0
reserved, BCE loss).

* `roi_align`: the JAX package's RoIAlign, not torchvision's or mmcv's.
  Sample points sit at `(arange(n) + 0.5) / n` of a box at least 1e-6
  wide, shifted by -0.5 (aligned); each point's floor is clipped to [0,
  size - 1] and its weight to [0, 1], so a point outside the map takes the
  border value (nothing is zeroed); the r² points of a bin are averaged.
  The bilinear weights separate by axis, so each RoI is two small
  products: per-bin row weights (out x H) and column weights (out x W)
  against its map (`axis_weights`), never a gather of the map per RoI.
* `AVARoIHead`: the time-pooled map, RoIAlign of the rows (batch_idx, x1,
  y1, x2, y2) normalized to [0, 1] and scaled by the map's (W, H, W, H),
  the shared head (models/lfb.py's ACRNHead or FBOHead) where there is
  one, the spatial pool, dropout and `fc_cls` (normal(0.01) at the init,
  models/recognizer.conv_init_state_dict).  Its input width is the
  backbone's (the JAX Dense reads it off its input).
* `ava_bbox_loss`: sigmoid BCE over classes 1.., averaged per row, then
  over the `valid` rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dropout


def axis_weights(lo: torch.Tensor, hi: torch.Tensor, out_size: int,
                 sampling_ratio: int, size: int,
                 aligned: bool = True) -> torch.Tensor:
    """(N,) box edges in pixels along one axis -> (N, out_size, size): the
    weight each bin gives each row (or column) of the map, the bilinear
    taps of its `sampling_ratio` points averaged."""
    off = 0.5 if aligned else 0.0
    span = torch.clamp_min(hi - lo, 1e-6)
    n = out_size * sampling_ratio
    steps = (torch.arange(n, dtype=lo.dtype, device=lo.device) + 0.5) / n
    pts = lo[:, None] + steps[None, :] * span[:, None] - off      # (N, n)
    p0 = torch.clamp(torch.floor(pts), 0, size - 1)
    p1 = torch.clamp(p0 + 1, 0, size - 1)
    w = torch.clamp(pts - p0, 0.0, 1.0)
    taps = torch.zeros(pts.shape + (size,), dtype=lo.dtype, device=lo.device)
    taps.scatter_add_(2, p0.long()[..., None], (1.0 - w)[..., None])
    taps.scatter_add_(2, p1.long()[..., None], w[..., None])
    return taps.reshape(-1, out_size, sampling_ratio, size).mean(2)


def _align(maps: torch.Tensor, idx: torch.Tensor, boxes: torch.Tensor,
           out_size: int, sampling_ratio: int,
           aligned: bool) -> torch.Tensor:
    """maps (B, H, W, C); idx (N,) each box's map; boxes (N, 4) pixel
    coords -> (N, out_size, out_size, C).  The rows' weights pick the
    box's map (one-hot over the batch), so all boxes are one product over
    (B, H), then one per box over W."""
    B, H, W, C = maps.shape
    N = boxes.shape[0]
    ay = axis_weights(boxes[:, 1], boxes[:, 3], out_size, sampling_ratio, H,
                      aligned)                                   # (N, o, H)
    ax = axis_weights(boxes[:, 0], boxes[:, 2], out_size, sampling_ratio, W,
                      aligned)                                   # (N, o, W)
    rows = torch.zeros(N, out_size, B, H, dtype=maps.dtype,
                       device=maps.device)
    rows[torch.arange(N, device=maps.device), :, idx] = ay.to(maps.dtype)
    t = (rows.reshape(N * out_size, B * H)
         @ maps.reshape(B * H, W * C)).reshape(N, out_size, W, C)
    return torch.einsum("nqw,npwc->npqc", ax.to(maps.dtype), t)


def roi_align_maps(maps: torch.Tensor, rois: torch.Tensor, out_size: int = 8,
                   sampling_ratio: int = 2,
                   aligned: bool = True) -> torch.Tensor:
    """maps: (B, H, W, C); rois: (N, 5) rows (batch_idx, x1, y1, x2, y2)
    normalized to [0, 1], scaled by the maps' (W, H, W, H) -> (N,
    out_size, out_size, C)."""
    _, H, W, _ = maps.shape
    scale = torch.tensor([W, H, W, H], dtype=torch.float32,
                         device=rois.device)
    return _align(maps, rois[:, 0].long(), rois[:, 1:].float() * scale,
                  out_size, sampling_ratio, aligned)


def roi_align(feat: torch.Tensor, boxes: torch.Tensor, out_size: int = 8,
              sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """Bilinear RoIAlign over one feature map, the JAX function's
    signature: feat (H, W, C); boxes (N, 4) pixel coords (x1, y1, x2,
    y2) -> (N, out_size, out_size, C)."""
    idx = torch.zeros(boxes.shape[0], dtype=torch.long, device=boxes.device)
    return _align(feat[None], idx, boxes, out_size, sampling_ratio, aligned)


@dataclasses.dataclass(frozen=True)
class AVAHeadConfig:
    num_classes: int = 81             # class 0 reserved, like the reference
    in_channels: int = 2048
    roi_size: int = 8
    sampling_ratio: int = 2
    temporal_pool: str = "avg"        # | 'max'
    spatial_pool: str = "max"         # | 'avg'
    dropout: float = 0.0


class AVARoIHead(nn.Module):
    """The RoI head, a shared head threaded between RoIAlign and the
    classifier where given (models/lfb.py's `ACRNHead`, or its `FBOHead`
    with the sampled long-term window as `lt_feat`).  in_channels: the
    backbone map's width (None: cfg.in_channels)."""

    def __init__(self, cfg: AVAHeadConfig,
                 shared_head: Optional[nn.Module] = None,
                 in_channels: Optional[int] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.shared_head = shared_head
        c = cfg.in_channels if in_channels is None else in_channels
        if shared_head is not None:
            c = shared_head.out_channels
        self.dropout = Dropout(cfg.dropout)
        self.fc_cls = nn.Linear(c, cfg.num_classes, device=device)

    def forward(self, feats: torch.Tensor, rois: torch.Tensor, *,
                lt_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """feats: (B, T, H, W, C); rois: (N, 5).  Returns multilabel
        logits (N, num_classes)."""
        from .lfb import ACRNHead
        cfg = self.cfg
        maps = feats.mean(1) if cfg.temporal_pool == "avg" \
            else feats.amax(1)                                 # (B, H, W, C)
        pooled = roi_align_maps(maps, rois, cfg.roi_size, cfg.sampling_ratio)
        head = self.shared_head
        if head is not None:
            roi5 = pooled[:, None]                             # (N, 1, r, r, C)
            if isinstance(head, ACRNHead):
                roi5 = head(roi5, maps[:, None], rois)
            else:
                if lt_feat is None:
                    raise ValueError("FBOHead needs lt_feat")
                roi5 = head(roi5, lt_feat)
            pooled = roi5.mean(1)
        x = pooled.amax((1, 2)) if cfg.spatial_pool == "max" \
            else pooled.mean((1, 2))
        return self.fc_cls(self.dropout(x))


def ava_bbox_loss(logits: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multilabel BCE over sigmoid scores, skipping the reserved class 0,
    averaged per row, then over the valid rows."""
    loss = F.binary_cross_entropy_with_logits(
        logits[:, 1:], labels[:, 1:], reduction="none").mean(-1)
    if valid is not None:
        return (loss * valid).sum() / torch.clamp_min(valid.sum(), 1.0)
    return loss.mean()

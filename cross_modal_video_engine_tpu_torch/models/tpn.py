"""TPN: the Temporal Pyramid Network neck, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/tpn.py (mmaction's
necks/tpn.py), over channels-first stage maps (B, C, T, H, W):

* the aux head (when `aux_num_classes` is set) on the second-to-last
  stage: a (1, 3, 3) stride (1, 2, 2) conv to twice the width, BatchNorm,
  ReLU, the global mean, dropout 0.5, `fc`; with labels, `loss_aux` is
  `aux_loss_weight` times its cross entropy;
* the spatial modulation, a ladder of (1, 3, 3) stride-2 conv + BN + ReLU
  steps per stage, int(log2(C_top / C_i)) of them: keyed on the channel
  ratio, not the resolution;
* the temporal modulation per level: a grouped (3, 1, 1) conv (no bias,
  BN or activation) and, at scale s > 1, a ceil-mode max pool over time:
  the tail padded with -inf to a multiple of s;
* `resample_t`: up to a longer time by half-pixel nearest (torch's
  'nearest-exact', jax.image.resize's 'nearest'), down by a floor-mode
  max pool of T // t;
* the top-down pass (each level plus the coarser one resampled to it),
  a level fusion, the bottom-up pass ('cascade' on the top-down maps,
  'parallel' on the modulated ones; each hop a real (3, 1, 1) conv
  before its resampling), a second level fusion; a level fusion is a
  grouped 1x1x1 conv + BN + ReLU per level, the concatenation, a 1x1x1
  conv + BN + ReLU; then the pyramid fusion conv + BN + ReLU over both.

Keys are mmaction's that convert_tpn reads: `spatial_modulation.
spatial_modulation.{i}.{j}`, `temporal_modulation_ops.{i}.conv.conv`,
`downsample_ops.{i}.conv.conv`, `level_fusion_{1,2}.downsamples.{i}.conv`
and `.fusion_conv`, `pyramid_fusion`, `aux_head.conv` and `aux_head.fc`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dropout
from .resnet3d import ConvModule


@dataclasses.dataclass(frozen=True)
class TPNConfig:
    in_channels: Tuple[int, ...] = (1024, 2048)
    out_channels: int = 1024          # the temporal modulation's width
    mid_channels: int = 1024          # a level fusion's width per level
    lf_out_channels: int = 2048       # a level fusion's output width
    fusion_channels: int = 2048       # the pyramid fusion's output width
    downsample_scales: Tuple[int, ...] = (8, 8)
    groups: int = 32
    flow_type: str = "cascade"        # | 'parallel'
    aux_num_classes: Optional[int] = None
    aux_loss_weight: float = 0.5


def temporal_pool_ceil(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Max pool of (scale, 1, 1) in ceil mode: the time axis padded with
    -inf to a multiple of scale."""
    pad = (-x.shape[2]) % scale
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad), value=float("-inf"))
    return F.max_pool3d(x, (scale, 1, 1), (scale, 1, 1))


def resample_t(x: torch.Tensor, t: int) -> torch.Tensor:
    """(B, C, T, H, W) -> time t: half-pixel nearest up, floor-mode max
    pool of T // t down."""
    if x.shape[2] == t:
        return x
    if x.shape[2] < t:
        return F.interpolate(x, size=(t,) + x.shape[3:], mode="nearest-exact")
    s = x.shape[2] // t
    return F.max_pool3d(x, (s, 1, 1), (s, 1, 1))


class _Conv(nn.Module):
    """mmaction's DownSample / TemporalModulation shell: `conv`, a
    ConvModule (its keys `<name>.conv.conv`, `<name>.conv.bn`)."""

    def __init__(self, conv: ConvModule):
        super().__init__()
        self.conv = conv


class AuxHead(nn.Module):
    def __init__(self, channels: int, num_classes: int, device=None):
        super().__init__()
        self.conv = ConvModule(channels, channels * 2, (1, 3, 3), (1, 2, 2),
                               (0, 1, 1), device=device)
        self.dropout = Dropout(0.5)
        self.fc = nn.Linear(channels * 2, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv(x)).mean(dim=(2, 3, 4))
        return self.fc(self.dropout(x))


class LevelFusion(nn.Module):
    def __init__(self, n: int, in_channels: int, mid: int, out: int,
                 groups: int, device=None):
        super().__init__()
        self.downsamples = nn.ModuleList(
            _Conv(ConvModule(in_channels, mid, 1, groups=groups,
                             device=device)) for _ in range(n))
        self.fusion_conv = ConvModule(n * mid, out, 1, device=device)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = torch.cat([F.relu(d.conv(f))
                       for d, f in zip(self.downsamples, feats)], 1)
        return F.relu(self.fusion_conv(x))


class TPN(nn.Module):
    def __init__(self, cfg: TPNConfig, device=None):
        super().__init__()
        self.cfg = cfg
        n, c_top = len(cfg.in_channels), cfg.in_channels[-1]
        self.spatial_modulation = nn.Module()
        ladders = []
        for c in cfg.in_channels:
            steps = int(math.log2(max(1, c_top // c)))
            ladders.append(nn.ModuleList(
                ConvModule(c * 2 ** j, c * 2 ** (j + 1), (1, 3, 3),
                           (1, 2, 2), (0, 1, 1), device=device)
                for j in range(steps)))
        self.spatial_modulation.spatial_modulation = nn.ModuleList(ladders)
        out = cfg.out_channels
        self.temporal_modulation_ops = nn.ModuleList(
            _Conv(ConvModule(c_top, out, (3, 1, 1), padding=(1, 0, 0),
                             groups=cfg.groups, norm=False, device=device))
            for _ in range(n))
        self.downsample_ops = nn.ModuleList(
            _Conv(ConvModule(out, out, (3, 1, 1), padding=(1, 0, 0),
                             norm=False, device=device))
            for _ in range(n - 1))
        for name in ("level_fusion_1", "level_fusion_2"):
            setattr(self, name, LevelFusion(
                n, out, cfg.mid_channels, cfg.lf_out_channels, cfg.groups,
                device))
        self.pyramid_fusion = ConvModule(2 * cfg.lf_out_channels,
                                         cfg.fusion_channels, 1,
                                         device=device)
        self.aux_head = (AuxHead(cfg.in_channels[-2], cfg.aux_num_classes,
                                 device)
                         if cfg.aux_num_classes is not None else None)
        self.eval()   # the JAX default (train=False)

    def forward(self, stages: Sequence[torch.Tensor],
                target: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """stages: the last len(in_channels) stage maps (B, C_i, T_i, H_i,
        W_i), coarsest last.  Returns (the fused map (B, fusion_channels,
        T', H', W'), {"loss_aux"} when the aux head is set and target
        labels are given)."""
        cfg = self.cfg
        n = len(cfg.in_channels)
        if len(stages) != n:
            raise ValueError(f"TPN takes {n} stage maps, got {len(stages)}")
        aux = {}
        if self.aux_head is not None:
            scores = self.aux_head(stages[-2])
            if target is not None:
                aux["loss_aux"] = cfg.aux_loss_weight * F.cross_entropy(
                    scores.to(torch.promote_types(scores.dtype,
                                                  torch.float32)), target)
        sm = []
        for f, ladder in zip(stages,
                             self.spatial_modulation.spatial_modulation):
            for step in ladder:
                f = F.relu(step(f))
            sm.append(f)
        tm = []
        for f, op, scale in zip(sm, self.temporal_modulation_ops,
                                cfg.downsample_scales):
            f = op.conv(f)
            tm.append(temporal_pool_ceil(f, scale) if scale > 1 else f)

        outs = list(tm)
        for i in range(n - 1, 0, -1):
            outs[i - 1] = outs[i - 1] + resample_t(outs[i],
                                                   outs[i - 1].shape[2])
        t_top = tm[-1].shape[2]
        top_down = self.level_fusion_1([resample_t(o, t_top) for o in outs])
        if cfg.flow_type == "parallel":
            outs = list(tm)
        for i in range(n - 1):
            hop = self.downsample_ops[i].conv(outs[i])
            outs[i + 1] = outs[i + 1] + resample_t(hop, outs[i + 1].shape[2])
        bottom_up = self.level_fusion_2([resample_t(o, t_top) for o in outs])
        x = F.relu(self.pyramid_fusion(torch.cat([top_down, bottom_up], 1)))
        return x, aux


def stage_maps(backbone: nn.Module, videos: torch.Tensor
               ) -> List[torch.Tensor]:
    """A ResNet3D's channels-first stage maps of channels-last videos."""
    return backbone.stages(videos.permute(0, 4, 1, 2, 3))

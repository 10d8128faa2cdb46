"""Classification heads of the CNN recognizers, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/heads.py (mmaction's
I3DHead, SlowFastHead, X3DHead, TSNHead, TRNHead): the 3-D backbones pool
to (B, C) already, so a head is dropout then a linear classifier (`fc_cls`,
init normal(0.01)); X3DHead is fc1 -> ReLU -> dropout -> fc2.  TSNHead
takes per-frame (B, S, C) features: the mean over the segments, dropout
0.4, `fc_cls`.  TRNHead: dropout 0.8 on the frames, `fc_cls` to
`hidden_dim` per frame, then relation MLPs (ReLU, Linear to
`bottleneck_dim`, ReLU, Linear to the classes) over frame tuples: 'TRN'
one over all segments, 'TRNMultiScale' one per scale S .. 2, each over
at most `max_subsample` tuples of `itertools.combinations` (evenly spaced
at eval, `linspace(...).round()`; drawn without replacement from the
head's `generator` in train mode, or handed in as `picks`), the scales'
scores summed.  Dropout is `layers.Dropout` (flax's, drawn from the
module's generator), active in train mode.  State-dict keys are the
mmaction heads' (`fc_cls`, `fc1`, `fc2`; TRN's `consensus.classifier.
{1,3}` and `consensus.fc_fusion_scales.{i}.{1,3}`, scale S - i).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import HEADS
from .flax_nn import Dense
from .layers import Dropout


class _PooledHead(nn.Module):
    default_dropout = 0.5

    def __init__(self, in_channels: int, num_classes: int,
                 dropout_ratio: float = None, device=None):
        super().__init__()
        self.dropout = Dropout(self.default_dropout if dropout_ratio is None
                               else dropout_ratio)
        # flax's Dense(dtype=None): a transformer's fp32 feature promotes
        # the bf16 trainer's bf16 weights
        self.fc_cls = Dense(in_channels, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_cls(self.dropout(x))


@HEADS.register("I3DHead")
class I3DHead(_PooledHead):
    pass


@HEADS.register("SlowFastHead")
class SlowFastHead(_PooledHead):
    default_dropout = 0.8


@HEADS.register("X3DHead")
class X3DHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int,
                 mid_channels: int = 2048, dropout_ratio: float = 0.5,
                 device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_channels, mid_channels, device=device)
        self.dropout = Dropout(dropout_ratio)
        self.fc2 = nn.Linear(mid_channels, num_classes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.dropout(F.relu(self.fc1(x))))


@HEADS.register("TSNHead")
class TSNHead(_PooledHead):
    """Segment consensus: (B, S, C) -> the mean over S, dropout, fc_cls."""

    default_dropout = 0.4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x.mean(1)
        return super().forward(x)


def _relation_mlp(in_features: int, bottleneck: int, num_classes: int,
                  device=None) -> nn.Sequential:
    return nn.Sequential(nn.ReLU(),
                         nn.Linear(in_features, bottleneck, device=device),
                         nn.ReLU(),
                         nn.Linear(bottleneck, num_classes, device=device))


@HEADS.register("TRNHead")
class TRNHead(nn.Module):
    """The Temporal Relation Network head (see the module docstring)."""

    generator = None

    def __init__(self, in_channels: int, num_classes: int,
                 num_segments: int = 8, hidden_dim: int = 256,
                 bottleneck_dim: int = 256, dropout_ratio: float = 0.8,
                 relation_type: str = "TRNMultiScale",
                 max_subsample: int = 3, device=None):
        super().__init__()
        if relation_type not in ("TRN", "TRNMultiScale"):
            raise ValueError(f"unknown relation_type {relation_type!r}")
        self.num_segments, self.max_subsample = num_segments, max_subsample
        self.relation_type = relation_type
        self.dropout = Dropout(dropout_ratio)
        self.fc_cls = nn.Linear(in_channels, hidden_dim, device=device)
        self.consensus = nn.Module()
        if relation_type == "TRN":
            self.consensus.classifier = _relation_mlp(
                num_segments * hidden_dim, bottleneck_dim, num_classes,
                device)
        else:
            self.consensus.fc_fusion_scales = nn.ModuleList(
                _relation_mlp(s * hidden_dim, bottleneck_dim, num_classes,
                              device) for s in self.scales)

    @property
    def scales(self):
        return list(range(self.num_segments, 1, -1))

    def combos(self, scale: int) -> np.ndarray:
        return np.asarray(list(itertools.combinations(
            range(self.num_segments), scale)), np.int64)

    def eval_picks(self, scale: int) -> np.ndarray:
        n = len(self.combos(scale))
        k = min(self.max_subsample, n)
        return np.linspace(0, n - 1, k).round().astype(np.int64)

    def draw_picks(self) -> Dict[int, np.ndarray]:
        """A train step's tuples: for each scale below S, min(max_subsample,
        n) of its n combinations without replacement, from `generator`."""
        out = {}
        g = self.generator
        for scale in self.scales[1:]:
            n = len(self.combos(scale))
            perm = torch.randperm(n, generator=g, device=None if g is None
                                  else g.device)
            out[scale] = perm[:min(self.max_subsample, n)].cpu().numpy()
        return out

    def forward(self, x: torch.Tensor,
                picks: Optional[Dict[int, np.ndarray]] = None
                ) -> torch.Tensor:
        """x: (B, S, C) or (B*S, C) frame features -> (B, num_classes).
        picks: {scale: indices into combos(scale)} for the scales below S
        (default: evenly spaced at eval, drawn in train mode)."""
        if x.dim() == 2:
            x = x.reshape(-1, self.num_segments, x.shape[-1])
        x = self.fc_cls(self.dropout(x))                   # (B, S, hidden)
        if self.relation_type == "TRN":
            return self.consensus.classifier(x.flatten(1))
        if picks is None:
            picks = (self.draw_picks() if self.training else
                     {s: self.eval_picks(s) for s in self.scales[1:]})
        mlps = self.consensus.fc_fusion_scales
        out = mlps[0](x.flatten(1))
        for i, scale in enumerate(self.scales[1:], start=1):
            sel = torch.from_numpy(self.combos(scale)[
                np.asarray(picks[scale])]).to(x.device)    # (k, scale)
            feats = x[:, sel]                              # (B, k, scale, h)
            out = out + mlps[i](feats.flatten(2)).sum(1)
        return out

"""Classification heads of the 3D-CNN recognizers, in PyTorch.

Counterpart of the pooled heads of cross_modal_video_engine_tpu/models/
heads.py (mmaction's I3DHead, SlowFastHead, X3DHead): the backbones pool
to (B, C) already, so a head is dropout then a linear classifier (`fc_cls`,
init normal(0.01)); X3DHead is fc1 -> ReLU -> dropout -> fc2.  Dropout is
`layers.Dropout` (flax's, drawn from the module's generator), active in
train mode.  State-dict keys are the mmaction heads' (`fc_cls`, `fc1`,
`fc2`).  TSNHead and TRNHead come with Recognizer2D (ROADMAP.md queue 1
item 8b).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import HEADS
from .layers import Dropout


class _PooledHead(nn.Module):
    default_dropout = 0.5

    def __init__(self, in_channels: int, num_classes: int,
                 dropout_ratio: float = None, device=None):
        super().__init__()
        self.dropout = Dropout(self.default_dropout if dropout_ratio is None
                               else dropout_ratio)
        self.fc_cls = nn.Linear(in_channels, num_classes, device=device)

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

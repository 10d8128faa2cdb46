"""SSN: the Structured Segment Network head (temporal action detection).

Counterpart of cross_modal_video_engine_tpu/models/ssn.py (mmaction's
SSN): proposals augmented with their context (start, course and end
stages) are pooled with a Structured Temporal Pyramid (STPP) over
precomputed snippet features and scored by two classifiers, activity
(which action) and completeness (is the proposal whole), with a location
regression beside them.

STPP pooling is one product with a host-built averaging matrix per
proposal (`stpp_matrix`).  The JAX batch step vmaps its head over the
videos; `SSNHead` here takes the batch directly: features (B, T, F) and
pooling weights (B, P, S, T).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


def stpp_matrix(T: int, proposals: np.ndarray,
                parts: Tuple[int, ...] = (1, 2, 1),
                extension: float = 0.5) -> np.ndarray:
    """(P, sum(parts)+2, T) averaging weights per proposal: the course
    span split into pyramid `parts` + one start and one end context span
    (extension * duration on each side)."""
    rows = []
    for s, e in proposals[:, :2]:
        d = max(e - s, 1.0)
        spans = [(s - extension * d, s), (e, e + extension * d)]
        segs = []
        for p in parts:
            for i in range(p):
                lo = s + d * i / p
                hi = s + d * (i + 1) / p
                segs.append((lo, hi))
        segs = segs + spans
        W = np.zeros((len(segs), T), np.float32)
        for r, (lo, hi) in enumerate(segs):
            lo_i = int(np.clip(np.floor(lo), 0, T - 1))
            hi_i = int(np.clip(np.ceil(hi), lo_i + 1, T))
            W[r, lo_i:hi_i] = 1.0 / (hi_i - lo_i)
        rows.append(W)
    return np.stack(rows)


@dataclasses.dataclass(frozen=True)
class SSNConfig:
    feat_dim: int = 400
    num_classes: int = 20
    parts: Tuple[int, ...] = (1, 2, 1)
    hidden: int = 256


class SSNHead(nn.Module):
    """forward(features (B, T, F), stpp (B, P, S, T)) -> dict(activity (B,
    P, C+1), completeness (B, P, C), regression (B, P, C, 2))."""

    def __init__(self, cfg: SSNConfig = SSNConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        f, h, c = cfg.feat_dim, cfg.hidden, cfg.num_classes
        s = sum(cfg.parts) + 2
        self.act_hidden = nn.Linear(f, h, device=dev)
        self.activity_fc = nn.Linear(h, c + 1, device=dev)
        self.comp_hidden = nn.Linear(s * f, h, device=dev)
        self.completeness_fc = nn.Linear(h, c, device=dev)
        self.reg_hidden = nn.Linear(s * f, h, device=dev)
        self.regression_fc = nn.Linear(h, 2 * c, device=dev)

    def forward(self, features: torch.Tensor,
                stpp: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, P, S, T = stpp.shape
        pooled = torch.matmul(stpp.reshape(B, P * S, T), features)
        pooled = pooled.reshape(B, P, S, -1)
        # activity sees the course span only (pyramid part 0: the whole
        # span); completeness and regression the whole structured feature
        act_feat = pooled[:, :, 0]
        comp_feat = pooled.reshape(B, P, -1)
        act = self.activity_fc(F.relu(self.act_hidden(act_feat)))
        comp = self.completeness_fc(F.relu(self.comp_hidden(comp_feat)))
        reg = self.regression_fc(F.relu(self.reg_hidden(comp_feat)))
        return {"activity": act, "completeness": comp,
                "regression": reg.reshape(B, P, self.cfg.num_classes, 2)}


def ssn_proposal_scores(activity: np.ndarray, completeness: np.ndarray
                        ) -> np.ndarray:
    """(P, C) combined detection scores: softmax activity (minus bg) *
    exp(completeness) — the reference's score fusion."""
    act = np.exp(activity - activity.max(-1, keepdims=True))
    act = act / act.sum(-1, keepdims=True)
    return act[:, 1:] * np.exp(completeness)

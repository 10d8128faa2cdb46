"""BSN: the Boundary-Sensitive Network for temporal proposals.

Counterpart of cross_modal_video_engine_tpu/models/bsn.py (mmaction's BSN
pair):
* `TEM`: a 1-D conv stack emitting per-snippet action, start and end
  probabilities;
* PGM (proposal generation), on the host in numpy: boundary pairing
  (`match_boundaries`) and the boundary-sensitive proposal feature
  (`proposal_features`): the action probability sampled over the span and
  its two boundary regions;
* `PEM`: an MLP scoring proposal features, its 0.1 output ratios inside
  the relu and the sigmoid as the reference keeps them (bsn.py:306-309).

A flax `Conv(ch, (k,))` kernel (k, in, out) is the Conv1d weight (out,
in, k); a `Dense` kernel (in, out) is the Linear weight (out, in).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


class TEM(nn.Module):
    """forward(x (B, T, F)) -> action / start / end probabilities (B, T)."""

    def __init__(self, feat_dim: int = 400, hidden: int = 512, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.c1 = nn.Conv1d(feat_dim, hidden, 3, padding=1, device=dev)
        self.c2 = nn.Conv1d(hidden, hidden, 3, padding=1, device=dev)
        self.c3 = nn.Conv1d(hidden, 3, 1, device=dev)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = F.relu(self.c1(x.transpose(1, 2)))
        h = F.relu(self.c2(h))
        out = torch.sigmoid(self.c3(h))                   # (B, 3, T)
        return {"action": out[:, 0], "start": out[:, 1], "end": out[:, 2]}


class PEM(nn.Module):
    """forward(feats (P, D)) -> (P,) confidence: sigmoid(r2 fc2(relu(r1
    fc1(x)))); fc*_ratio=1.0 gives the plain MLP."""

    def __init__(self, feat_dim: int = 32, hidden: int = 128,
                 fc1_ratio: float = 0.1, fc2_ratio: float = 0.1,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.fc1_ratio, self.fc2_ratio = fc1_ratio, fc2_ratio
        self.fc1 = nn.Linear(feat_dim, hidden, device=dev)
        self.fc2 = nn.Linear(hidden, 1, device=dev)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1_ratio * self.fc1(feats))
        return torch.sigmoid(self.fc2_ratio * self.fc2(h))[..., 0]


def match_boundaries(start: np.ndarray, end: np.ndarray,
                     threshold: float = 0.5,
                     max_proposals: int = 200) -> np.ndarray:
    """Pair start/end peaks into candidate (s, e) proposals (PGM step 1):
    a snippet is a boundary if its prob exceeds threshold*max or is a
    local peak.  Rows sort by descending score with Python's stable sort,
    so ties keep the (s, e) loop order."""
    def candidates(p):
        peak = np.zeros_like(p, bool)
        peak[1:-1] = (p[1:-1] > p[:-2]) & (p[1:-1] > p[2:])
        strong = p > threshold * p.max()
        return np.nonzero(peak | strong)[0]

    starts = candidates(start)
    ends = candidates(end)
    rows = [(s, e, float(start[s] * end[e]))
            for s in starts for e in ends if e > s]
    rows.sort(key=lambda r: -r[2])
    return np.asarray(rows[:max_proposals], np.float32)


def proposal_features(action: np.ndarray, proposals: np.ndarray,
                      n_body: int = 16, n_boundary: int = 4) -> np.ndarray:
    """Boundary-sensitive feature: action prob sampled over the span and
    over both boundary regions (linear interp) -> (N, n_body+2*n_boundary).
    """
    T = len(action)

    def sample(lo, hi, n):
        pts = np.linspace(lo, hi, n)
        lo_i = np.clip(np.floor(pts).astype(int), 0, T - 1)
        hi_i = np.clip(lo_i + 1, 0, T - 1)
        frac = pts - np.floor(pts)
        return (1 - frac) * action[lo_i] + frac * action[hi_i]

    out = []
    for s, e, _ in proposals:
        d = max(e - s, 1.0)
        out.append(np.concatenate([
            sample(s, e, n_body),
            sample(s - d / 5, s + d / 5, n_boundary),
            sample(e - d / 5, e + d / 5, n_boundary),
        ]))
    return np.asarray(out, np.float32)

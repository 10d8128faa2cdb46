"""BMN: the Boundary-Matching Network for temporal action proposals.

Counterpart of cross_modal_video_engine_tpu/models/bmn.py (after
MCT/mmaction/models/localizers/bmn.py): a temporal base of grouped 1-D
convolutions over snippet features, a Temporal Evaluation Module (start
and end probabilities) and a Proposal Evaluation Module whose
boundary-matching layer is one product with a fixed sampling matrix,
(C, T) x (T, N*D*T) -> (C, N, D, T), dense as the JAX package keeps it.

The layout, against the JAX module's parameters:
* a flax `Conv(ch, (3,), feature_group_count=4)` kernel (3, in/4, out) is
  the torch Conv1d weight (out, in/4, 3) with the same grouping of the
  output channels;
* `pem_3d`, flax's (N, 1, 1) convolution with stride N over (B, N, D, T,
  C), is the Conv3d weight (512, C, N, 1, 1); it runs as one product over
  (C*N) for every (d, t): the weight read as (512, C*N) times the sampled
  map read as (B, C*N, D*T), which comes out channels first as the 2-D
  convolutions after it take it.

The sampling matrix is built once per (T, N, D) (`sampling_matrix`) and
kept on the model's device as a non-persistent buffer, outside the state
dict.  Proposal scoring and soft-NMS run on the host in numpy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BMNConfig:
    temporal_dim: int = 100          # T snippets
    feat_dim: int = 400
    num_samples: int = 32            # N samples per proposal
    max_duration: int = 100          # D
    hidden_1d: int = 256
    hidden_2d: int = 128
    hidden_3d: int = 512


def bm_sampling_matrix(T: int, N: int, D: int) -> np.ndarray:
    """(T, N*D*T) interpolation weights: proposal (start t, duration d)
    samples N points linearly over [t, t+d+1] with linear weights.

    The JAX package's loop, vectorized and bit-equal to it: each sample
    point (n, d, t) writes its two cells (lo and lo+1 in the row axis)
    and no other sample writes those cells, so every cell is the float32
    rounding of one float64 weight added to zero.  The points come from
    np.linspace over the broadcast (t, t+d+1) pairs, which computes each
    point as the scalar call does."""
    d = np.arange(D)[:, None]
    t = np.arange(T)[None, :]
    start = np.broadcast_to(t, (D, T)).astype(np.float64)
    end = (t + d + 1).astype(np.float64)
    pts = np.linspace(start, end, N, axis=-1)          # (D, T, N)
    lo = np.floor(pts).astype(np.int64)
    frac = pts - lo
    W = np.zeros((T, N, D, T), np.float32)
    nn_, dd, tt = np.meshgrid(np.arange(N), np.arange(D), np.arange(T),
                              indexing="ij")
    lo_, frac_ = lo.transpose(2, 0, 1), frac.transpose(2, 0, 1)  # (N, D, T)
    for row, w in ((lo_, 1 - frac_), (lo_ + 1, frac_)):
        ok = (row >= 0) & (row < T)
        W[row[ok], nn_[ok], dd[ok], tt[ok]] = w[ok]
    return W.reshape(T, N * D * T)


@functools.lru_cache(maxsize=4)
def sampling_matrix(T: int, N: int, D: int) -> np.ndarray:
    """bm_sampling_matrix, built once per (T, N, D) in this process (the
    full-width (100, 32, 100) matrix is 122 MiB), read-only."""
    W = bm_sampling_matrix(T, N, D)
    W.setflags(write=False)
    return W


class BMN(nn.Module):
    """forward(features (B, T, F)) -> dict(tem_start (B, T), tem_end (B,
    T), pem_reg (B, D, T), pem_cls (B, D, T)), in float32 (or the dtype
    the model was cast to)."""

    def __init__(self, cfg: BMNConfig = BMNConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        h1, h2, h3 = cfg.hidden_1d, cfg.hidden_2d, cfg.hidden_3d
        N = cfg.num_samples

        def conv1d(cin, cout, k=3, groups=1):
            return nn.Conv1d(cin, cout, k, padding=k // 2, groups=groups,
                             device=dev)

        self.base1 = conv1d(cfg.feat_dim, h1, groups=4)
        self.base2 = conv1d(h1, h1, groups=4)
        self.tem1 = conv1d(h1, h1, groups=4)
        self.tem_start = conv1d(h1, 1, 1)
        self.tem_end = conv1d(h1, 1, 1)
        self.pem_conv = conv1d(h1, h2)
        self.pem_3d = nn.Conv3d(h2, h3, (N, 1, 1), stride=(N, 1, 1),
                                device=dev)
        self.pem_2d1 = nn.Conv2d(h3, h2, 1, device=dev)
        self.pem_2d2 = nn.Conv2d(h2, h2, 3, padding=1, device=dev)
        self.pem_out = nn.Conv2d(h2, 2, 1, device=dev)
        W = sampling_matrix(cfg.temporal_dim, N, cfg.max_duration)
        self.register_buffer("sampling", torch.from_numpy(W.copy()).to(dev),
                             persistent=False)

    def forward(self, features: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        T, N, D = cfg.temporal_dim, cfg.num_samples, cfg.max_duration
        x = features.transpose(1, 2)                      # (B, F, T)
        base = F.relu(self.base1(x))
        base = F.relu(self.base2(base))
        tem = F.relu(self.tem1(base))
        start = torch.sigmoid(self.tem_start(tem))[:, 0]
        end = torch.sigmoid(self.tem_end(tem))[:, 0]
        pem_in = F.relu(self.pem_conv(base))              # (B, C, T)
        B, C = pem_in.shape[:2]
        W = self.sampling.to(pem_in.dtype)
        bm = torch.matmul(pem_in, W)                      # (B, C, N*D*T)
        k = self.pem_3d.weight.reshape(cfg.hidden_3d, C * N)
        y = torch.matmul(k, bm.reshape(B, C * N, D * T))  # (B, 512, D*T)
        y = y + self.pem_3d.bias[:, None]
        y = F.relu(y).reshape(B, cfg.hidden_3d, D, T)
        y = F.relu(self.pem_2d1(y))
        y = F.relu(self.pem_2d2(y))
        out = torch.sigmoid(self.pem_out(y))              # (B, 2, D, T)
        return {"tem_start": start, "tem_end": end,
                "pem_reg": out[:, 0], "pem_cls": out[:, 1]}


def generate_proposals(tem_start: np.ndarray, tem_end: np.ndarray,
                       pem_reg: np.ndarray, pem_cls: np.ndarray,
                       max_proposals: int = 100) -> np.ndarray:
    """Host-side proposal scoring: rows (start, end, score) sorted by
    score = s_prob * e_prob * reg * cls (reference score fusion)."""
    T = tem_start.shape[0]
    rows = []
    for d in range(pem_reg.shape[0]):
        for t in range(T):
            end = t + d + 1
            if end >= T:
                continue
            score = (tem_start[t] * tem_end[end]
                     * pem_reg[d, t] * pem_cls[d, t])
            rows.append((t, end, float(score)))
    rows.sort(key=lambda r: -r[2])
    return np.asarray(rows[:max_proposals], np.float32)


def soft_nms(proposals: np.ndarray, sigma: float = 0.4,
             top_k: int = 100) -> np.ndarray:
    """Gaussian soft-NMS over (start, end, score) rows (reference
    post-processing)."""
    props = proposals.copy()
    keep = []
    while len(props) and len(keep) < top_k:
        i = int(np.argmax(props[:, 2]))
        best = props[i]
        keep.append(best.copy())
        props = np.delete(props, i, axis=0)
        if not len(props):
            break
        inter = (np.minimum(best[1], props[:, 1])
                 - np.maximum(best[0], props[:, 0])).clip(0)
        union = (best[1] - best[0]) + (props[:, 1] - props[:, 0]) - inter
        iou = inter / np.maximum(union, 1e-9)
        props[:, 2] *= np.exp(-(iou ** 2) / sigma)
    return np.asarray(keep, np.float32)

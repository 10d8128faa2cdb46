"""The long-term feature bank (LFB), the FBO fusion heads and the ACRN
head, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/lfb.py (the
reference's common/lfb.py and heads/{fbo_head,misc_head}.py):

* `LFBBuilder` / `LongTermFeatureBank`: the bank as three dense arrays on
  the device, `features` (num_steps, capacity, C) zero-padded per (video,
  second) step, a (V, S) `step_table` of row ids (-1 where empty) and per
  video start seconds; `build` samples a second's rows down to the
  capacity with `np.random.default_rng(seed).choice`, as the JAX builder
  does, so both build the same bank.  `sample_window` / `sample_batch`
  are one gather, zero where the second lies outside the video's span,
  where it holds no step, and in the slots past its count.  `save` writes
  `np.savez` with the JAX keys and dtypes, so either package loads the
  other's file.
* `NonLocalLayer` / `FBONonLocal`: the non-local stack fusing the
  short-term RoI feature with the long-term window (latent Linear
  projections, theta·phi / sqrt(latent) softmax, flax's LayerNorm (eps
  1e-6) + ReLU before the out projection when `pre_activate`, dropout
  0.2 on st, on lt and on each layer's output).
* `FBOAvg` / `FBOMax`: the parameter-free pools.
* `FBOHead`: temporal-avg and spatial-max pool of the RoI feature, the
  fusion, concat [identity, fbo] -> (N, 1, 1, 1, C').
* `ACRNHead`: the RoI feature max-pooled, tiled over the time-pooled map
  and concatenated with its batch element's map, then a 1x1x1 conv and a
  (1, 3, 3) conv (stride (1, s, s)) stack, each flax's BatchNorm
  (momentum 0.9, biased variance) and ReLU.

The dropouts are models/layers.Dropout (their masks drawn from the
module's generator, or handed in).  Widths are explicit where flax reads
them off the input: the heads take the backbone's `in_channels`, which
is also the long-term rows' and the context map's (the bank holds RoI
features of the same backbone).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .flax_nn import LayerNorm
from .layers import Dropout, FlaxBatchNorm

__all__ = [
    "LongTermFeatureBank", "LFBBuilder", "NonLocalLayer", "FBONonLocal",
    "FBOAvg", "FBOMax", "FBOHead", "FBOHeadConfig", "ACRNHead",
    "ACRNHeadConfig",
]


# -- the bank ------------------------------------------------------------------

class LFBBuilder:
    """Accumulates RoI features keyed by (video_id, second) and finalizes
    to the dense device layout."""

    def __init__(self, channels: int, capacity: int = 5):
        self.channels = channels
        self.capacity = capacity
        self._store: Dict[str, Dict[int, List[np.ndarray]]] = {}

    def add(self, video_id: str, timestamp, features) -> None:
        """features: (n, C) RoI rows for one keyframe."""
        sec = int(timestamp)
        rows = self._store.setdefault(video_id, {}).setdefault(sec, [])
        for f in np.asarray(features, np.float32).reshape(-1, self.channels):
            rows.append(f)

    def build(self, seed: int = 0, device=None) -> "LongTermFeatureBank":
        """Each (video, second) sampled down to `capacity` rows (without
        replacement, by the seeded numpy generator) and zero-padded; the
        bank on `device` (None: the CUDA device)."""
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        video_ids = sorted(self._store)
        sec_min = {v: min(self._store[v]) for v in video_ids}
        span = max((max(self._store[v]) - sec_min[v] + 1
                    for v in video_ids), default=1)
        steps: List[np.ndarray] = []
        counts: List[int] = []
        table = -np.ones((max(len(video_ids), 1), span), np.int32)
        for vi, v in enumerate(video_ids):
            for sec, rows in sorted(self._store[v].items()):
                feats = np.stack(rows)
                if len(feats) > self.capacity:
                    feats = feats[rng.choice(len(feats), self.capacity,
                                             replace=False)]
                pad = np.zeros((self.capacity, self.channels), np.float32)
                pad[:len(feats)] = feats
                table[vi, sec - sec_min[v]] = len(steps)
                steps.append(pad)
                counts.append(len(feats))
        features = (np.stack(steps) if steps else
                    np.zeros((1, self.capacity, self.channels), np.float32))
        return LongTermFeatureBank(
            features=torch.from_numpy(features).to(dev),
            step_table=torch.from_numpy(table).to(dev),
            start_sec=torch.tensor([sec_min[v] for v in video_ids] or [0],
                                   dtype=torch.int32, device=dev),
            counts=torch.tensor(counts or [0], dtype=torch.int32,
                                device=dev),
            video_index={v: i for i, v in enumerate(video_ids)},
            capacity=self.capacity)


@dataclasses.dataclass
class LongTermFeatureBank:
    """The bank on the device."""

    features: torch.Tensor         # (num_steps, capacity, C) f32
    step_table: torch.Tensor       # (V, S) int32 row ids, -1 = empty
    start_sec: torch.Tensor        # (V,) int32
    counts: torch.Tensor           # (num_steps,) int32
    video_index: Dict[str, int]
    capacity: int

    @property
    def channels(self) -> int:
        return self.features.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.features.device

    def sample_batch(self, video_idxs, timestamps, window_size: int = 60
                     ) -> torch.Tensor:
        """(M, window_size * capacity, C): each (video, timestamp)'s
        window centred on the timestamp (start = ts - window // 2), zeros
        where a second holds no features, in one gather."""
        dev = self.device
        v = torch.as_tensor(np.asarray(video_idxs), dtype=torch.long,
                            device=dev).reshape(-1)
        t = torch.as_tensor(np.asarray(timestamps), dtype=torch.long,
                            device=dev).reshape(-1)
        start = t - window_size // 2 - self.start_sec[v].long()
        offs = start[:, None] + torch.arange(window_size, device=dev)
        S = self.step_table.shape[1]
        in_range = (offs >= 0) & (offs < S)
        rows = self.step_table[v[:, None], offs.clamp(0, S - 1)].long()
        rows = torch.where(in_range, rows, -1)
        r = rows.clamp_min(0)
        slot_ok = (torch.arange(self.capacity, device=dev)
                   < self.counts[r].long()[..., None])        # (M, w, cap)
        keep = (rows >= 0)[..., None] & slot_ok
        feats = torch.where(keep[..., None], self.features[r], 0.0)
        return feats.reshape(v.shape[0], window_size * self.capacity, -1)

    def sample_window(self, video_idx, timestamp, window_size: int = 60
                      ) -> torch.Tensor:
        """(window_size * capacity, C) for one (video, timestamp)."""
        return self.sample_batch([video_idx], [timestamp], window_size)[0]

    def save(self, path: str) -> None:
        """np.savez with the JAX bank's keys and dtypes."""
        np.savez(path, features=self.features.cpu().numpy(),
                 step_table=self.step_table.cpu().numpy(),
                 start_sec=self.start_sec.cpu().numpy(),
                 counts=self.counts.cpu().numpy(),
                 video_ids=np.array(sorted(self.video_index,
                                           key=self.video_index.get)),
                 capacity=self.capacity)

    @classmethod
    def load(cls, path: str, device=None) -> "LongTermFeatureBank":
        dev = resolve_device(device)
        z = np.load(path, allow_pickle=False)
        vids = [str(v) for v in z["video_ids"]]
        return cls(features=torch.from_numpy(z["features"]).to(dev),
                   step_table=torch.from_numpy(z["step_table"]).to(dev),
                   start_sec=torch.from_numpy(z["start_sec"]).to(dev),
                   counts=torch.from_numpy(z["counts"]).to(dev),
                   video_index={v: i for i, v in enumerate(vids)},
                   capacity=int(z["capacity"]))


# -- FBO operators ---------------------------------------------------------------

class NonLocalLayer(nn.Module):
    """fbo_head.py:21-170 channels-last: st (N, S, C_st), lt (N, L, C_lt)
    -> (N, S, out_channels)."""

    def __init__(self, st_channels: int, lt_channels: int,
                 latent_channels: int, out_channels: int,
                 use_scale: bool = True, pre_activate: bool = True,
                 dropout: float = 0.2, device=None):
        super().__init__()
        c = latent_channels
        self.latent_channels, self.use_scale = c, use_scale
        self.pre_activate = pre_activate
        self.st_feat_conv = nn.Linear(st_channels, c, device=device)
        self.lt_feat_conv = nn.Linear(lt_channels, c, device=device)
        self.global_conv = nn.Linear(lt_channels, c, device=device)
        self.ln = LayerNorm(c if pre_activate else out_channels,
                            device=device)
        self.out_conv = nn.Linear(c, out_channels, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, st_feat: torch.Tensor,
                lt_feat: torch.Tensor) -> torch.Tensor:
        theta = self.st_feat_conv(st_feat)                    # (N, S, c)
        phi = self.lt_feat_conv(lt_feat)                      # (N, L, c)
        g = self.global_conv(lt_feat)                         # (N, L, c)
        attn = torch.bmm(theta, phi.transpose(1, 2))          # (N, S, L)
        if self.use_scale:
            attn = attn / math.sqrt(self.latent_channels)
        out = torch.bmm(torch.softmax(attn, -1), g)
        if self.pre_activate:
            out = F.relu(self.ln(out))
        out = self.out_conv(out)
        if not self.pre_activate:
            out = self.ln(out)
        return self.dropout(out)


class FBONonLocal(nn.Module):
    """fbo_head.py:173-283: st and lt projected to the latent width, then a
    residual stack of non-local layers."""

    def __init__(self, st_channels: int, lt_channels: int,
                 latent_channels: int = 512, num_non_local_layers: int = 2,
                 st_feat_dropout: float = 0.2, lt_feat_dropout: float = 0.2,
                 pre_activate: bool = True, device=None):
        super().__init__()
        c = latent_channels
        self.out_channels, self.pre_activate = c, pre_activate
        self.st_feat_conv = nn.Linear(st_channels, c, device=device)
        self.st_dropout = Dropout(st_feat_dropout)
        self.lt_feat_conv = nn.Linear(lt_channels, c, device=device)
        self.lt_dropout = Dropout(lt_feat_dropout)
        self.num_layers = num_non_local_layers
        for i in range(num_non_local_layers):
            self.add_module(f"non_local_layer_{i + 1}", NonLocalLayer(
                c, c, c, c, pre_activate=pre_activate, device=device))

    def forward(self, st_feat: torch.Tensor,
                lt_feat: torch.Tensor) -> torch.Tensor:
        st = self.st_dropout(self.st_feat_conv(st_feat))
        lt = self.lt_dropout(self.lt_feat_conv(lt_feat))
        for i in range(self.num_layers):
            st = st + getattr(self, f"non_local_layer_{i + 1}")(st, lt)
            if not self.pre_activate:
                st = F.relu(st)
        return st


class FBOAvg(nn.Module):
    def forward(self, st_feat, lt_feat):
        return lt_feat.mean(1, keepdim=True)


class FBOMax(nn.Module):
    def forward(self, st_feat, lt_feat):
        return lt_feat.amax(1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class FBOHeadConfig:
    fbo_type: str = "non_local"    # | 'avg' | 'max'
    latent_channels: int = 512
    num_non_local_layers: int = 2
    temporal_pool: str = "avg"
    spatial_pool: str = "max"


class FBOHead(nn.Module):
    """fbo_head.py:324-401: RoI feature (N, T, H, W, C) and long-term
    window (N, L, C_lt) -> concat([identity, fbo]) (N, 1, 1, 1, C')."""

    def __init__(self, cfg: FBOHeadConfig, in_channels: int, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.fbo_type == "non_local":
            self.fbo = FBONonLocal(in_channels, in_channels,
                                   cfg.latent_channels,
                                   cfg.num_non_local_layers, device=device)
            fbo_out = cfg.latent_channels
        else:
            self.fbo = FBOAvg() if cfg.fbo_type == "avg" else FBOMax()
            fbo_out = in_channels
        self.out_channels = in_channels + fbo_out

    def forward(self, roi_feat: torch.Tensor,
                lt_feat: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = roi_feat.mean(1) if cfg.temporal_pool == "avg" \
            else roi_feat.amax(1)                             # (N, H, W, C)
        x = x.amax((1, 2)) if cfg.spatial_pool == "max" else x.mean((1, 2))
        st = x[:, None, :]                                    # (N, 1, C)
        out = torch.cat([st, self.fbo(st, lt_feat)], -1)      # (N, 1, C')
        return out.reshape(out.shape[0], 1, 1, 1, -1)


@dataclasses.dataclass(frozen=True)
class ACRNHeadConfig:
    out_channels: int = 512
    stride: int = 1
    num_convs: int = 1


class ACRNHead(nn.Module):
    """misc_head.py:16-134: roi_feat (N, T, H, W, C) max-pooled to a
    vector, tiled over the context map's (T, H, W), concatenated with the
    RoI's batch element `feat[batch_idx]` (B, T, H, W, C_ctx), then the
    conv stack; channels-last in and out."""

    def __init__(self, cfg: ACRNHeadConfig, in_channels: int, device=None):
        super().__init__()
        self.cfg = cfg
        o, s = cfg.out_channels, cfg.stride
        self.out_channels = o
        # the RoI vector and its map, both the backbone's width
        self.conv1 = nn.Conv3d(2 * in_channels, o, 1, bias=False,
                               device=device)
        self.bn1 = FlaxBatchNorm(o, device=device)
        self.conv2 = nn.Conv3d(o, o, (1, 3, 3), (1, s, s), (0, 1, 1),
                               bias=False, device=device)
        self.bn2 = FlaxBatchNorm(o, device=device)
        for i in range(cfg.num_convs - 1):
            self.add_module(f"conv_extra{i}", nn.Conv3d(
                o, o, (1, 3, 3), 1, (0, 1, 1), bias=False, device=device))
            self.add_module(f"bn_extra{i}", FlaxBatchNorm(o, device=device))

    def forward(self, roi_feat: torch.Tensor, feat: torch.Tensor,
                rois: torch.Tensor) -> torch.Tensor:
        x = roi_feat.amax((1, 2, 3))                          # (N, C)
        ctx = feat[rois[:, 0].long()]                         # (N, T, H, W, Cc)
        N, T, H, W = ctx.shape[:4]
        y = torch.cat([x[:, None, None, None, :].expand(N, T, H, W, -1),
                       ctx], -1)
        # a channels_last_3d view: cuDNN's NDHWC kernels
        y = y.permute(0, 4, 1, 2, 3)
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.relu(self.bn2(self.conv2(y)))
        for i in range(self.cfg.num_convs - 1):
            y = F.relu(getattr(self, f"bn_extra{i}")(
                getattr(self, f"conv_extra{i}")(y)))
        return y.permute(0, 2, 3, 4, 1)

"""TANet: the Temporal Adaptive Module on 2-D ResNet blocks, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/tanet.py (mmaction's
TANet and common/tam.py):

* `TAM`: the clip's spatially pooled context (B, T, C) drives two
  branches.  The global one, over the B*C rows of (time) values:
  Linear(T, T*alpha) -> BatchNorm over those (B*C, T*alpha) rows -> ReLU
  -> Linear(T*alpha, K) -> softmax, a K-tap temporal kernel per video and
  channel; the local one: Conv1d(C, C/beta, 3) -> BatchNorm -> ReLU ->
  Conv1d(C/beta, C, 1) -> sigmoid, a gate per frame and channel.  The
  gated maps take the kernel as a depthwise temporal conv, written as K
  shifted multiply-adds over the zero-padded clip (no biases anywhere);
* `TABlock`: the 2-D bottleneck (`block`) with the TAM (`tam`) between
  conv1 and conv2;
* `TANet`: the ResNet-50 stem and stages of TABlocks; (B, T, H, W, 3) ->
  per-frame features (B, T, C).

Keys are mmaction's that convert_tanet reads: `layer{s}.{j}.block.
{conv1,conv2,conv3,downsample}.{conv,bn}`, `layer{s}.{j}.tam.G.{0,1,3}`,
`.tam.L.{0,1,3}`.  The global branch's first Linear has T inputs, so the
port's config carries the clip length (`num_segments`, 8 in the shipped
recipe), which the JAX module reads off its input at init.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import BACKBONES
from .backbones2d import (Bottleneck2d, frames, per_frame, resnet_layers,
                          run_layers, stem2d, stem_pool)
from .layers import FlaxBatchNorm


class TAM(nn.Module):
    """x: (B*T, C, H, W) -> the same, mixed over time."""

    def __init__(self, channels: int, num_segments: int, kernel: int = 3,
                 alpha: int = 2, beta: int = 4, conv1d_kernel: int = 3,
                 device=None):
        super().__init__()
        t, self.kernel, self.num_segments = num_segments, kernel, num_segments
        self.G = nn.Sequential(
            nn.Linear(t, t * alpha, bias=False, device=device),
            FlaxBatchNorm(t * alpha, device=device), nn.ReLU(),
            nn.Linear(t * alpha, kernel, bias=False, device=device))
        self.L = nn.Sequential(
            nn.Conv1d(channels, channels // beta, conv1d_kernel,
                      padding=conv1d_kernel // 2, bias=False, device=device),
            FlaxBatchNorm(channels // beta, device=device), nn.ReLU(),
            nn.Conv1d(channels // beta, channels, 1, bias=False,
                      device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T, K = self.num_segments, self.kernel
        _, C, H, W = x.shape
        v = x.reshape(-1, T, C, H, W)
        B = v.shape[0]
        ctx = v.mean(dim=(3, 4)).transpose(1, 2)           # (B, C, T)
        g = torch.softmax(self.G(ctx.reshape(B * C, T)), -1).reshape(B, C, K)
        gate = torch.sigmoid(self.L(ctx))                  # (B, C, T)
        v = v * gate.transpose(1, 2)[..., None, None]
        pad = K // 2
        vp = F.pad(v, (0, 0, 0, 0, 0, 0, pad, pad))
        out = torch.zeros_like(v)
        for k in range(K):
            out = out + vp[:, k:k + T] * g[:, None, :, k, None, None]
        return out.reshape(x.shape)


class TABottleneck(Bottleneck2d):
    """The bottleneck whose TAM (held by the TABlock) runs after conv1."""

    def forward(self, x: torch.Tensor, tam: TAM) -> torch.Tensor:
        out = tam(F.relu(self.conv1(x)))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class TABlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, num_segments: int,
                 device=None):
        super().__init__()
        self.block = TABottleneck(cin, planes, stride, device)
        self.tam = TAM(planes, num_segments, device=device)

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        return self.block(x, self.tam)


@dataclasses.dataclass(frozen=True)
class TANetConfig:
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    base_channels: int = 64
    num_segments: int = 8


@BACKBONES.register("TANet")
class TANet(nn.Module):
    def __init__(self, cfg: TANetConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        self.conv1 = stem2d(3, cfg.base_channels, device)
        self.feat_dim = resnet_layers(
            self, cfg, lambda cin, planes, s: TABlock(
                cin, planes, s, cfg.num_segments, device))
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> per-frame features (B, T, C)."""
        B, T = videos.shape[:2]
        if T != self.cfg.num_segments:
            raise ValueError(f"TANet built for {self.cfg.num_segments} "
                             f"frames got {T}")
        x = stem_pool(self.conv1(frames(videos)))
        x = run_layers(self, x, T, len(self.cfg.stage_blocks))
        return per_frame(x, B)

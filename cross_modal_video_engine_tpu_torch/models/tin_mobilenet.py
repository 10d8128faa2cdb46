"""TIN (Temporal Interlace) and MobileNetV2-TSM backbones, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/tin_mobilenet.py:

* `TemporalInterlace` and `TINResNet`: the learned fractional shift of
  the first C/shift_div channels (per group an offset in [-1, 1] and a
  sigmoid gate from fcs over the clip's pooled context), sampled between
  the clamped frames floor(t + offset) and floor + 1, before each stage
  of a 2-D ResNet whose own shift is off.  No importer reads it; its
  keys are `interlace{i}.{off_fc1,off_fc2,gate_fc}` and the ResNet's;
* `tin_shift`, `linear_sampler`, `TINOffsetNet`, `TINWeightNet`,
  `TemporalInterlaceExact`, `TINBlock`, `TINResNetExact`: mmaction's
  ResNetTIN.  `tin_shift` gathers frame t - shift (zero out of range);
  `linear_sampler` blends the floor and floor + 1 shifts by the
  fractional part, the offset's only gradient; the two offsets act as
  [+o0, +o1, -o0, -o1] over four channel groups and the two gates tile
  the channels as [g0, g1, g0, g1] quarters.  Every block interlaces the
  input of its conv1, whose keys are mmaction's CombineNet's
  (`conv1.conv.net1.{offset_net,weight_net}`, `conv1.conv.net2`);
* `InvertedResidual` and `MobileNetV2TSM`: MobileNetV2 (relu6, the
  expand conv left out at expand ratio 1, depthwise 3x3) with the
  temporal shift before each residual block; keys `conv1`,
  `layer{i}.{j}.conv.{k}`, `conv2`.

The TIN modules that read the clip length off their weights' shapes
(TINResNet's fcs; TINResNetExact's offset fc) take it as the config's
`num_segments`; the JAX modules read it off the input at init.  Each
backbone maps (B, T, H, W, 3) to per-frame features (B, T, C).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import BACKBONES
from .backbones2d import (Bottleneck2d, ConvModule2d, frames, per_frame,
                          resnet_layers, run_layers, shift_frames, stem2d,
                          stem_pool)


class TemporalInterlace(nn.Module):
    """x: (B*T, C, H, W).  The first C/shift_div channels, in `groups`
    groups, sampled at t + offset (linear between the clamped floor and
    floor + 1 frames) and scaled by the group's gate."""

    def __init__(self, channels: int, num_segments: int, shift_div: int = 4,
                 groups: int = 2, device=None):
        super().__init__()
        t = num_segments
        self.shift_div, self.groups, self.num_segments = shift_div, groups, t
        self.off_fc1 = nn.Linear(channels * t, t * 4, device=device)
        self.off_fc2 = nn.Linear(t * 4, groups, device=device)
        self.gate_fc = nn.Linear(t * 4, groups, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = self.num_segments
        _, C, H, W = x.shape
        v = x.reshape(-1, T, C, H, W)
        B = v.shape[0]
        fold = C // self.shift_div
        ctx = v.mean(dim=(3, 4))                           # (B, T, C)
        h = F.relu(self.off_fc1(ctx.transpose(1, 2).reshape(B, C * T)))
        offsets = torch.tanh(self.off_fc2(h))              # (B, G)
        gates = torch.sigmoid(self.gate_fc(h))
        per_group = fold // self.groups
        t_idx = torch.arange(T, device=x.device, dtype=torch.float32)
        rows = torch.arange(B, device=x.device)[:, None]
        outs = []
        for gi in range(self.groups):
            pos = t_idx[None, :] + offsets[:, gi:gi + 1]    # (B, T)
            floor = torch.floor(pos)
            lo = floor.long().clamp(0, T - 1)
            hi = (lo + 1).clamp(0, T - 1)
            frac = (pos - floor)[:, :, None, None, None]
            sl = v[:, :, gi * per_group:(gi + 1) * per_group]
            interp = (1 - frac) * sl[rows, lo] + frac * sl[rows, hi]
            outs.append(interp * gates[:, gi, None, None, None, None])
        y = torch.cat(outs + [v[:, :, fold:]], 2)
        return y.reshape((-1,) + y.shape[2:])


@dataclasses.dataclass(frozen=True)
class TINConfig:
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    base_channels: int = 64
    shift_div: int = 4
    num_segments: int = 8


@BACKBONES.register("TIN")
class TINResNet(nn.Module):
    """A 2-D ResNet-50 with a TemporalInterlace before each stage."""

    def __init__(self, cfg: TINConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        self.conv1 = stem2d(3, cfg.base_channels, device)
        self.feat_dim = resnet_layers(
            self, cfg, lambda cin, planes, s: Bottleneck2d(cin, planes, s,
                                                           device))
        cin = cfg.base_channels
        for i in range(len(cfg.stage_blocks)):
            setattr(self, f"interlace{i}", TemporalInterlace(
                cin, cfg.num_segments, cfg.shift_div, device=device))
            cin = cfg.base_channels * 2 ** i * Bottleneck2d.expansion
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        B, T = videos.shape[:2]
        if T != self.cfg.num_segments:
            raise ValueError(f"TIN built for {self.cfg.num_segments} "
                             f"frames got {T}")
        x = stem_pool(self.conv1(frames(videos)))
        for i in range(len(self.cfg.stage_blocks)):
            x = getattr(self, f"interlace{i}")(x)
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x, T)
        return per_frame(x, B)


# -- mmaction's ResNetTIN -----------------------------------------------------

def tin_shift(data: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """mmcv's tin_shift: data (N, T, C, HW), shift (N, G) integers, the
    channels in G contiguous groups; out[n, t, c] = data[n, t - shift[n,
    g(c)], c], zero where that frame is outside the clip."""
    N, T, C, _ = data.shape
    group_of_c = torch.arange(C, device=data.device) // (C // shift.shape[1])
    t_src = (torch.arange(T, device=data.device)[None, :, None]
             - shift[:, None, :][:, :, group_of_c])        # (N, T, C)
    valid = (t_src >= 0) & (t_src < T)
    gathered = torch.gather(data, 1, t_src.clamp(0, T - 1)[..., None]
                            .expand(data.shape))
    return torch.where(valid[..., None], gathered, 0.0)


def linear_sampler(data: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """data (N, T, F, H, W), offset (N, G) fractional shifts: the floor
    and floor + 1 tin_shifts blended by the fractional part, written
    d1 + w0 (d0 - d1) so that the offset's gradient sums g (d0 - d1): the
    form w0 d0 + (1 - w0) d1 has it sum g d0 and g d1 apart and subtract
    two near-equal totals (neighbouring frames), losing most of its f32
    digits."""
    n, t, f, h, w = data.shape
    floor = torch.floor(offset)
    off0 = floor.long()
    flat = data.reshape(n, t, f, h * w)
    d0 = tin_shift(flat, off0)
    d1 = tin_shift(flat, off0 + 1)
    w0 = 1.0 - (offset - floor)                            # (N, G)
    w0c = torch.repeat_interleave(w0, f // offset.shape[1], 1)
    w0c = w0c[:, None, :, None]
    return (d1 + w0c * (d0 - d1)).reshape(n, t, f, h, w)


class TINOffsetNet(nn.Module):
    """conv1d(F, 1, 3) over time, fc(T, T), ReLU, fc(T, G); 4 (sigmoid -
    0.5) in (-2, 2)."""

    def __init__(self, channels: int, num_segments: int, groups: int = 2,
                 device=None):
        super().__init__()
        self.conv = nn.Conv1d(channels, 1, 3, padding=1, device=device)
        self.fc1 = nn.Linear(num_segments, num_segments, device=device)
        self.fc2 = nn.Linear(num_segments, groups, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (N, F, T)
        h = F.relu(self.fc1(self.conv(x)[:, 0]))
        return 4.0 * (torch.sigmoid(self.fc2(h)) - 0.5)


class TINWeightNet(nn.Module):
    """conv1d(F, G, 3) over time; 2 sigmoid in (0, 2), as (N, T, G)."""

    def __init__(self, channels: int, groups: int = 2, device=None):
        super().__init__()
        self.conv = nn.Conv1d(channels, groups, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:     # (N, F, T)
        return 2.0 * torch.sigmoid(self.conv(x)).transpose(1, 2)


class TemporalInterlaceExact(nn.Module):
    """x: (B*T, C, H, W); the first C/shift_div channels deformed."""

    def __init__(self, channels: int, num_segments: int, shift_div: int = 4,
                 deform_groups: int = 2, device=None):
        super().__init__()
        self.num_segments, self.shift_div = num_segments, shift_div
        folds = channels // shift_div
        self.offset_net = TINOffsetNet(folds, num_segments, deform_groups,
                                       device)
        self.weight_net = TINWeightNet(folds, deform_groups, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = self.num_segments
        n, C, H, W = x.shape
        folds = C // self.shift_div
        desc = x[:, :folds].reshape(n // T, T, folds, H, W)
        pooled = desc.mean(dim=(3, 4)).transpose(1, 2)      # (nb, F, T)
        off = self.offset_net(pooled)                       # (nb, 2)
        wgt = self.weight_net(pooled)                       # (nb, T, 2)
        shifted = linear_sampler(desc, torch.cat([off, -off], 1))
        wchan = torch.repeat_interleave(wgt.repeat(1, 1, 2), folds // 4, 2)
        shifted = shifted * wchan[..., None, None]
        return torch.cat([shifted.reshape(n, folds, H, W), x[:, folds:]], 1)


class CombineNet(nn.Module):
    """mmaction's CombineNet: net2(net1(x))."""

    def __init__(self, net1: nn.Module, net2: nn.Module):
        super().__init__()
        self.net1, self.net2 = net1, net2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net2(self.net1(x))


class TINBlock(Bottleneck2d):
    """The 2-D bottleneck with conv1's input interlaced (the shortcut
    takes the block's input as it came)."""

    def __init__(self, cin: int, planes: int, stride: int, num_segments: int,
                 shift_div: int = 4, device=None):
        super().__init__(cin, planes, stride, device)
        self.conv1.conv = CombineNet(
            TemporalInterlaceExact(cin, num_segments, shift_div,
                                   device=device), self.conv1.conv)


@dataclasses.dataclass(frozen=True)
class TINExactConfig:
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    base_channels: int = 64
    num_segments: int = 8
    shift_div: int = 4


@BACKBONES.register("TINResNetExact")
class TINResNetExact(nn.Module):
    def __init__(self, cfg: TINExactConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        self.conv1 = stem2d(3, cfg.base_channels, device)
        self.feat_dim = resnet_layers(
            self, cfg, lambda cin, planes, s: TINBlock(
                cin, planes, s, cfg.num_segments, cfg.shift_div, device))
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        B, T = videos.shape[:2]
        x = stem_pool(self.conv1(frames(videos)))
        x = run_layers(self, x, T, len(self.cfg.stage_blocks))
        return per_frame(x, B)


# -- MobileNetV2-TSM ----------------------------------------------------------

class ConvModuleRelu6(ConvModule2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu6(super().forward(x))


class InvertedResidual(nn.Module):
    """`conv`: [expand 1x1 (relu6)], depthwise 3x3 with the stride
    (relu6), project 1x1; residual when the stride is 1 and the width
    stays, with the temporal shift of the block's input first."""

    def __init__(self, cin: int, cout: int, stride: int = 1, expand: int = 6,
                 use_tsm: bool = True, shift_div: int = 8, device=None):
        super().__init__()
        mid = cin * expand
        self.expand = expand
        self.residual = stride == 1 and cin == cout
        self.shift_div = shift_div if use_tsm and self.residual else 0
        convs = [ConvModuleRelu6(cin, mid, 1, device=device)] \
            if expand != 1 else []
        convs += [ConvModuleRelu6(mid, mid, 3, stride, 1, groups=mid,
                                  device=device),
                  ConvModule2d(mid, cout, 1, device=device)]
        self.conv = nn.Sequential(*convs)

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        y = self.conv(shift_frames(x, t, self.shift_div) if self.shift_div
                      else x)
        return x + y if self.residual else y


@dataclasses.dataclass(frozen=True)
class MobileNetV2TSMConfig:
    # (expand, out_ch, blocks, stride) per stage: MobileNetV2
    stages: Tuple = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                     (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                     (6, 320, 1, 1))
    last_channels: int = 1280
    shift_div: int = 8


@BACKBONES.register("MobileNetV2TSM")
class MobileNetV2TSM(nn.Module):
    def __init__(self, cfg: MobileNetV2TSMConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        self.conv1 = ConvModuleRelu6(3, 32, 3, 2, 1, device=device)
        cin = 32
        for si, (e, c, n, s) in enumerate(cfg.stages):
            layer = []
            for j in range(n):
                layer.append(InvertedResidual(cin, c, s if j == 0 else 1, e,
                                              shift_div=cfg.shift_div,
                                              device=device))
                cin = c
            setattr(self, f"layer{si + 1}", nn.ModuleList(layer))
        self.conv2 = ConvModuleRelu6(cin, cfg.last_channels, 1,
                                     device=device)
        self.feat_dim = cfg.last_channels
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        B, T = videos.shape[:2]
        x = self.conv1(frames(videos))
        x = run_layers(self, x, T, len(self.cfg.stages))
        return per_frame(self.conv2(x), B)

"""Per-frame and light 3D backbones: TSM-ResNet (and TSN), C3D, R(2+1)D,
in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/backbones2d.py (the
mmaction ResNetTSM, C3D and ResNet2Plus1d backbones), module for module,
with the same config dataclasses:

* `temporal_shift`: on (B, T, C, ...) the first C/div channels take
  frame t+1's values, the next C/div frame t-1's, the rest stay; zeros
  at the clip's edges (what the JAX function computes; its docstring
  names the two directions the other way round);
* `TSMResNet`: the 2D ResNet-50 (7x7 stem, -inf padded 3x3 max pool,
  bottlenecks with the stride on the 3x3) over the B*T frames, each
  block shifting its input in time first; `shift_div=0` is TSN's plain
  per-frame ResNet.  (B, T, H, W, 3) -> per-frame features (B, T, C);
* `C3D`: eight biased 3x3x3 convs, fc6 and fc7 (4096) with dropout
  between; `exact_head` is mmaction's pool5 (padding (0, 1, 1)) and
  fc6 over the channel-first flattened map, else a global mean;
* `conv2plus1d_mid`, `Conv2Plus1D`, `R2Plus1DBlock`, `R2Plus1D`: every
  3-D conv (the 1x1x1 downsample too) factorised into a (1, kh, kw)
  spatial conv, BatchNorm, ReLU and a (kt, 1, 1) temporal conv, the mid
  width by mmaction's integer formula; blocks stride time and space
  alike.  (B, T, H, W, 3) -> pooled (B, C).

Every BatchNorm is `layers.FlaxBatchNorm` (flax's momentum 0.9, eps
1e-5, biased running variance).  State-dict keys are the mmaction
checkpoints' that cross_modal_video_engine_tpu.convert.torch_import reads
(`convert_tsm`, `convert_c3d`, `convert_r2plus1d`): ConvModules as
`<name>.conv` / `<name>.bn`, blocks as `layer{s}.{j}`, the factorised
convs as `<name>.conv.{conv_s,bn_s,conv_t}`.  The 2-D nets fold time
into the batch: a (B*T, C, H, W) view with torch's channels_last
strides, as models/resnet3d.py runs its maps.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import BACKBONES
from .layers import Dropout, FlaxBatchNorm
from .resnet3d import ConvModule, _channels_first, _pool


def temporal_shift(x: torch.Tensor, shift_div: int = 8) -> torch.Tensor:
    """x: (B, T, C, ...).  Channels [0, C/div) at t take frame t+1's,
    [C/div, 2C/div) frame t-1's, zero past the clip's ends; the rest
    stay."""
    fold = x.shape[2] // shift_div
    if fold == 0:
        return x
    zero = x.new_zeros((x.shape[0], 1, fold) + x.shape[3:])
    left = torch.cat([x[:, 1:, :fold], zero], 1)
    right = torch.cat([zero, x[:, :-1, fold:2 * fold]], 1)
    return torch.cat([left, right, x[:, :, 2 * fold:]], 2)


def shift_frames(x: torch.Tensor, t: int, shift_div: int) -> torch.Tensor:
    """temporal_shift of the (B*T, C, H, W) frames of clips of t."""
    return temporal_shift(x.reshape((-1, t) + x.shape[1:]),
                          shift_div).reshape(x.shape)


def frames(videos: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> the (B*T, C, H, W) view (channels_last)."""
    return videos.reshape((-1,) + videos.shape[2:]).permute(0, 3, 1, 2)


def per_frame(x: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*T, C, H, W) -> the spatial mean (B, T, C)."""
    return x.mean(dim=(2, 3)).reshape(batch, -1, x.shape[1])


class ConvModule2d(nn.Module):
    """mmcv's 2-D ConvModule without its activation: `conv` (Conv2d, no
    bias), then `bn` (flax's BatchNorm)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding,
                              groups=groups, bias=False, device=device)
        self.bn = FlaxBatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


def stem2d(cin: int, cout: int, device=None) -> ConvModule2d:
    return ConvModule2d(cin, cout, 7, 2, 3, device=device)


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """ReLU, then the 3x3 stride-2 max pool (padding -inf, as flax's)."""
    return F.max_pool2d(F.relu(x), 3, 2, 1)


class Bottleneck2d(nn.Module):
    """mmaction's 2-D Bottleneck: 1x1 conv1, 3x3 conv2 with the stride,
    1x1 conv3 to 4 x planes; a strided 1x1 `downsample` + BN when the
    stride or width changes.  forward(x, t): x (B*T, C, H, W), t the
    clip length (for the temporal module before conv1)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = ConvModule2d(cin, planes, 1, device=device)
        self.conv2 = ConvModule2d(planes, planes, 3, stride, 1,
                                  device=device)
        self.conv3 = ConvModule2d(planes, out, 1, device=device)
        self.downsample = (ConvModule2d(cin, out, 1, stride, device=device)
                           if stride != 1 or cin != out else None)

    def temporal(self, x: torch.Tensor, t: int) -> torch.Tensor:
        return x

    def forward(self, x: torch.Tensor, t: int) -> torch.Tensor:
        out = F.relu(self.conv1(self.temporal(x, t)))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class TSMBlock(Bottleneck2d):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 shift_div: int = 8, device=None):
        super().__init__(cin, planes, stride, device)
        self.shift_div = shift_div

    def temporal(self, x: torch.Tensor, t: int) -> torch.Tensor:
        return shift_frames(x, t, self.shift_div) if self.shift_div else x


def resnet_layers(module: nn.Module, cfg, make_block) -> int:
    """Sets `layer{i}` (ModuleLists of make_block(cin, planes, stride))
    on module for the four stages of cfg; returns the output width."""
    cin, planes = cfg.base_channels, cfg.base_channels
    for i, blocks in enumerate(cfg.stage_blocks):
        layer = []
        for j in range(blocks):
            layer.append(make_block(cin, planes, 2 if i and not j else 1))
            cin = planes * Bottleneck2d.expansion
        setattr(module, f"layer{i + 1}", nn.ModuleList(layer))
        planes *= 2
    return cin


def run_layers(module: nn.Module, x: torch.Tensor, t: int,
               n_stages: int) -> torch.Tensor:
    for i in range(n_stages):
        for block in getattr(module, f"layer{i + 1}"):
            x = block(x, t)
    return x


@dataclasses.dataclass(frozen=True)
class TSMConfig:
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    base_channels: int = 64
    shift_div: int = 8


@BACKBONES.register("TSMResNet")
class TSMResNet(nn.Module):
    def __init__(self, cfg: TSMConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        self.conv1 = stem2d(3, cfg.base_channels, device)
        self.feat_dim = resnet_layers(
            self, cfg, lambda cin, planes, s: TSMBlock(
                cin, planes, s, cfg.shift_div, device))
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> per-frame features (B, T, C)."""
        B, T = videos.shape[:2]
        x = stem_pool(self.conv1(frames(videos)))
        x = run_layers(self, x, T, len(self.cfg.stage_blocks))
        return per_frame(x, B)


@BACKBONES.register("C3D")
class C3D(nn.Module):
    """mmaction's C3D: conv1a .. conv5b (biased, no BatchNorm), then fc6,
    dropout 0.5, fc7, each fc with ReLU.  exact_head: pool5 and fc6 on
    the 8192 flattened values of a 16x112² clip (mmaction's head);
    otherwise fc6 on the global mean, any input size."""

    CONVS = (("conv1a", 3, 64), ("conv2a", 64, 128), ("conv3a", 128, 256),
             ("conv3b", 256, 256), ("conv4a", 256, 512),
             ("conv4b", 512, 512), ("conv5a", 512, 512),
             ("conv5b", 512, 512))

    def __init__(self, fc_dim: int = 4096, exact_head: bool = False,
                 device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.exact_head = exact_head
        for name, cin, cout in self.CONVS:
            setattr(self, name, ConvModule(cin, cout, 3, padding=1,
                                           bias=True, norm=False,
                                           device=device))
        self.fc6 = nn.Linear(8192 if exact_head else 512, fc_dim,
                             device=device)
        self.dropout = Dropout(0.5)
        self.fc7 = nn.Linear(fc_dim, fc_dim, device=device)
        self.feat_dim = fc_dim
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> (B, fc_dim)."""
        x = _channels_first(videos)
        pools = {"conv1a": (1, 2, 2), "conv2a": (2, 2, 2),
                 "conv3b": (2, 2, 2), "conv4b": (2, 2, 2)}
        for name, _, _ in self.CONVS:
            x = F.relu(getattr(self, name)(x))
            if name in pools:
                x = F.max_pool3d(x, pools[name], pools[name])
        if self.exact_head:
            x = F.max_pool3d(x, 2, 2, (0, 1, 1)).flatten(1)   # C, T, H, W
        else:
            x = _pool(x)
        x = self.dropout(F.relu(self.fc6(x)))
        return F.relu(self.fc7(x))


def conv2plus1d_mid(in_c: int, out_c: int, kt: int, kh: int, kw: int
                    ) -> int:
    """mmaction's Conv2plus1d mid width: floor(t d² N_in N_out /
    (d² N_in + t N_out)), at least 1 (integer division)."""
    return max(int(kt * kh * kw * in_c * out_c
                   // (kh * kw * in_c + kt * out_c)), 1)


class Conv2Plus1D(nn.Module):
    """conv_s (1, kh, kw) with the spatial stride, bn_s, ReLU, conv_t
    (kt, 1, 1) with the temporal stride; no biases."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3),
                 stride=(1, 1, 1), device=None):
        super().__init__()
        kt, kh, kw = kernel
        t, s1, s2 = stride
        mid = conv2plus1d_mid(cin, cout, kt, kh, kw)
        self.conv_s = nn.Conv3d(cin, mid, (1, kh, kw), (1, s1, s2),
                                (0, kh // 2, kw // 2), bias=False,
                                device=device)
        self.bn_s = FlaxBatchNorm(mid, device=device)
        self.conv_t = nn.Conv3d(mid, cout, (kt, 1, 1), (t, 1, 1),
                                (kt // 2, 0, 0), bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_t(F.relu(self.bn_s(self.conv_s(x))))


class ConvModule2Plus1D(nn.Module):
    """A ConvModule whose conv is a Conv2Plus1D: `conv`, then `bn`."""

    def __init__(self, cin: int, cout: int, kernel, stride, device=None):
        super().__init__()
        self.conv = Conv2Plus1D(cin, cout, kernel, stride, device)
        self.bn = FlaxBatchNorm(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class R2Plus1DBlock(nn.Module):
    """mmaction's BasicBlock3d over Conv2plus1d: conv1 strided in time
    and space, conv2 at stride 1, a factorised 1x1x1 `downsample` when
    the stride or width changes."""

    def __init__(self, cin: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        s = (stride,) * 3
        self.conv1 = ConvModule2Plus1D(cin, planes, (3, 3, 3), s, device)
        self.conv2 = ConvModule2Plus1D(planes, planes, (3, 3, 3), (1, 1, 1),
                                       device)
        self.downsample = (ConvModule2Plus1D(cin, planes, (1, 1, 1), s,
                                             device)
                           if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(F.relu(self.conv1(x)))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


@dataclasses.dataclass(frozen=True)
class R2Plus1DConfig:
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)   # R(2+1)D-34
    base_channels: int = 64


@BACKBONES.register("R2Plus1D")
class R2Plus1D(nn.Module):
    """The factorised (3, 7, 7) stem (mid width 83 for 3 -> 64), the
    (1, 3, 3) stride (1, 2, 2) max pool, four stages of R2Plus1DBlock."""

    def __init__(self, cfg: R2Plus1DConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        self.conv1 = ConvModule2Plus1D(3, cfg.base_channels, (3, 7, 7),
                                       (1, 2, 2), device)
        cin, planes = cfg.base_channels, cfg.base_channels
        for i, blocks in enumerate(cfg.stage_blocks):
            layer = []
            for j in range(blocks):
                layer.append(R2Plus1DBlock(cin, planes, 2 if i and not j
                                           else 1, device))
                cin = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            planes *= 2
        self.feat_dim = cin
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> pooled (B, C)."""
        x = F.relu(self.conv1(_channels_first(videos)))
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for i in range(len(self.cfg.stage_blocks)):
            x = getattr(self, f"layer{i + 1}")(x)
        return _pool(x)

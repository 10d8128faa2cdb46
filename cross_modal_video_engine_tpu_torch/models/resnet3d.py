"""3D-CNN video backbones: ResNet3D (SlowOnly, I3D, with non-local
blocks), CSN, SlowFast and X3D, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/resnet3d.py (the
mmaction ResNet3d, ResNet3dCSN, ResNet3dSlowFast and X3D backbones),
module for module, with the same config dataclasses:

* `ResNet3D`: the inflated ResNet of `ResNet3DConfig` (stem conv and
  max pool, four stages of `Bottleneck3D`; `non_local` flags put an
  embedded-Gaussian `NonLocal3D` after a block; `s2d_stem` computes the
  stem through ops/s2d_stem.py);
* `CSN`: channel-separated bottlenecks, the 3x3x3 conv depthwise
  (`groups=planes`), 'ir' or 'ip' (a pointwise conv + BN before it),
  stage transitions strided in time and space, BatchNorm eps 1e-3;
* `SlowFast`: the slow pathway takes `videos[:, ::alpha]`, the fast one
  is a `ResNet3D` with `channel_ratio=beta_inv`; four time-strided
  lateral convs (optionally BN + ReLU) bring the fast stem and stages
  1-3 to the slow rate, concatenated before each slow stage and trimmed
  to the shorter time; `return_stages` gives the AVA map;
* `X3D`: `se_round_width`, `SEModule`, `X3DBlock` (depthwise 3x3x3, SE
  on every other block or all, swish after SE) and the stem and conv5.

Every BatchNorm is `layers.FlaxBatchNorm` (flax's momentum 0.9 and biased
running variance).  State-dict keys are the mmaction checkpoints' that
cross_modal_video_engine_tpu.convert.torch_import reads
(`convert_resnet3d`, `_non_local3d`, `convert_slowfast`, `convert_x3d`,
`convert_csn`): ConvModules as `<name>.conv` / `<name>.bn`, blocks as
`layer{s}.{j}`, the non-local block as `layer{s}.{j}.non_local_block`
with `g.0.conv` and `phi.0.conv` (conv then max pool), the SlowFast
pathways as `slow_path` and `fast_path` with `conv1_lateral` and
`layer{i}_lateral`, the X3D stem as `conv1_s` / `conv1_t` and its SE as
`se_module.fc{1,2}` (1x1x1 convs with bias).  One state dict loads into
the port and, through those converters, into the JAX package.

Layout: the input is channels-last (B, T, H, W, 3), as the JAX modules
take it.  The backbone permutes it to (B, 3, T, H, W) without a copy: the
view has torch's channels_last_3d strides, so cuDNN's convolutions,
batch norms and pools run channels-last (NDHWC), the layout of its
tensor-core kernels; the s2d stem's depth-to-space comes back NCDHW and
is turned to channels_last_3d.  Every padding is explicit zero padding,
as flax's 'SAME' on the 1x1x1 strided convs pads nothing; the max pools
pad with -inf, as flax's do.  Outputs: pooled (B, C) features; stage maps
(`return_stages`) channels-last, as the JAX modules give them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mixed_precision import acc_dtype
from ..ops.s2d_stem import s2d_stem_conv
from ..utils.device import resolve_device
from ..utils.registry import BACKBONES
from .layers import FlaxBatchNorm


def _triple(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


class ConvModule(nn.Module):
    """mmcv's ConvModule without its activation: `conv` (Conv3d), then
    `bn` (flax's BatchNorm) unless norm=False.  The caller applies the
    activation."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 groups: int = 1, bias: bool = False, norm: bool = True,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, _triple(kernel), _triple(stride),
                              _triple(padding), groups=groups, bias=bias,
                              device=device)
        self.bn = FlaxBatchNorm(cout, eps=eps, device=device) if norm \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


def _max_pool_stem(x: torch.Tensor, stride_t: int = 1) -> torch.Tensor:
    return F.max_pool3d(x, (1, 3, 3), (stride_t, 2, 2), (0, 1, 1))


def _pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3, 4))                       # global average


def _channels_first(videos: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> a (B, C, T, H, W) view (channels_last_3d)."""
    return videos.permute(0, 4, 1, 2, 3)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class NonLocal3D(nn.Module):
    """mmcv NonLocal3d, embedded Gaussian (the slowonly_r50_nl recipe:
    sub_sample, use_scale, BN on conv_out): g, theta and phi are biased
    1x1x1 convs to C/2, g and phi max-pooled spatially by 2; the softmax
    of theta·phi / sqrt(C/2) over the keys, in f32, weights g; conv_out
    (no bias) + BN projects back, added to the input.  The attention runs
    in f32 for f32 and bf16 input and in float64 for float64 input."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        inter = max(1, channels // 2)
        self.inter = inter

        def proj():
            return ConvModule(channels, inter, 1, bias=True, norm=False,
                              device=device)

        self.g = nn.Sequential(proj(), nn.MaxPool3d((1, 2, 2)))
        self.theta = proj()
        self.phi = nn.Sequential(proj(), nn.MaxPool3d((1, 2, 2)))
        self.conv_out = ConvModule(inter, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, T, H, W = x.shape
        acc = acc_dtype(x.dtype)                # f32, float64 staying so
        q = self.theta(x).flatten(2).transpose(1, 2).to(acc)   # (B, N, c)
        k = self.phi(x).flatten(2).to(acc)                      # (B, c, M)
        v = self.g(x).flatten(2).transpose(1, 2).to(acc)        # (B, M, c)
        attn = torch.softmax(torch.bmm(q, k) / (self.inter ** 0.5), -1)
        y = torch.bmm(attn, v).to(x.dtype)                      # (B, N, c)
        y = y.transpose(1, 2).reshape(B, self.inter, T, H, W)
        return x + self.conv_out(y)


class Bottleneck3D(nn.Module):
    """mmaction Bottleneck3d: (tk, 1, 1) conv1, (1, 3, 3) conv2 with the
    spatial stride, 1x1x1 conv3 to 4 x planes; a 1x1x1 strided
    `downsample` + BN when the stride or the width changes; a
    `non_local_block` after the block's ReLU where flagged."""

    expansion = 4

    def __init__(self, cin: int, planes: int, spatial_stride: int = 1,
                 temporal_kernel: int = 3, non_local: bool = False,
                 device=None):
        super().__init__()
        tk, s, out = temporal_kernel, spatial_stride, planes * 4
        self.conv1 = ConvModule(cin, planes, (tk, 1, 1),
                                padding=(tk // 2, 0, 0), device=device)
        self.conv2 = ConvModule(planes, planes, (1, 3, 3), (1, s, s),
                                (0, 1, 1), device=device)
        self.conv3 = ConvModule(planes, out, 1, device=device)
        self.downsample = (ConvModule(cin, out, 1, (1, s, s), device=device)
                           if s != 1 or cin != out else None)
        self.non_local_block = NonLocal3D(out, device) if non_local else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.downsample is None else self.downsample(x)
        out = F.relu(out + sc)
        if self.non_local_block is not None:
            out = self.non_local_block(out)
        return out


@dataclasses.dataclass(frozen=True)
class ResNet3DConfig:
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)       # depth 50
    base_channels: int = 64
    conv1_kernel_t: int = 1        # SlowOnly: 1; I3D/SlowFast-fast: 5
    conv1_stride_t: int = 1
    pool1_stride_t: int = 1
    stage_temporal_kernels: Tuple[int, ...] = (1, 1, 3, 3)  # SlowOnly
    channel_ratio: int = 1         # the fast pathway's 8x thinner channels
    stage_spatial_strides: Tuple[int, ...] = (1, 2, 2, 2)
    # per-stage per-block non-local flags; () = none
    non_local: Tuple[Tuple[int, ...], ...] = ()
    # the stem through ops/s2d_stem.py (same parameters, same outputs)
    s2d_stem: bool = False


@BACKBONES.register("ResNet3D")
class ResNet3D(nn.Module):
    """in_channels: the stem's input channels, 3 for RGB, the heatmap
    channels for PoseC3D (the JAX module reads them off its input; they
    are not a config field, since the JAX config has none)."""

    def __init__(self, cfg: ResNet3DConfig, device=None,
                 in_channels: int = 3):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        c0 = cfg.base_channels // cfg.channel_ratio
        kt = cfg.conv1_kernel_t
        self.conv1 = ConvModule(in_channels, c0, (kt, 7, 7),
                                (cfg.conv1_stride_t, 2, 2),
                                (kt // 2, 3, 3), device=device)
        cin, planes = c0, c0
        for i, (blocks, tk) in enumerate(zip(cfg.stage_blocks,
                                             cfg.stage_temporal_kernels)):
            nl = cfg.non_local[i] if i < len(cfg.non_local) else ()
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck3D(
                    cin, planes, cfg.stage_spatial_strides[i] if j == 0
                    else 1, tk, bool(j < len(nl) and nl[j]), device))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            planes *= 2
        self.feat_dim = cin
        self.eval()

    def stages(self, x: torch.Tensor,
               include_stem: bool = False) -> List[torch.Tensor]:
        """x: (B, 3, T, H, W) -> the stage maps (B, C, T', H', W'), the
        pooled stem first when include_stem."""
        cfg = self.cfg
        if cfg.s2d_stem:
            x = s2d_stem_conv(x, self.conv1.conv.weight,
                              stride_t=cfg.conv1_stride_t)
            x = self.conv1.bn(x.contiguous(
                memory_format=torch.channels_last_3d))
        else:
            x = self.conv1(x)
        x = _max_pool_stem(F.relu(x), cfg.pool1_stride_t)
        out = [x] if include_stem else []
        for i in range(len(cfg.stage_blocks)):
            x = getattr(self, f"layer{i + 1}")(x)
            out.append(x)
        return out

    def forward(self, videos: torch.Tensor, return_stages: bool = False,
                include_stem: bool = False):
        """videos: (B, T, H, W, 3) -> pooled (B, C), or the stage maps
        channels-last (the post-pool stem first when include_stem)."""
        maps = self.stages(_channels_first(videos), include_stem)
        if return_stages:
            return [_channels_last(m) for m in maps]
        return _pool(maps[-1])


SLOWONLY_CFG = ResNet3DConfig()


class CSNBottleneck(nn.Module):
    """mmaction CSNBottleneck3d: conv1 1x1x1; conv2 = [pointwise 1x1x1 +
    BN ('ip')] + depthwise 3x3x3 with the (temporal, spatial) stride;
    conv3 1x1x1 to 4 x planes; `downsample` when strided or widened.
    BatchNorm eps 1e-3."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 temporal_stride: int = 1, mode: str = "ir", device=None):
        super().__init__()
        s, t, out = stride, temporal_stride, planes * 4

        def conv(ci, co, *a, **k):
            return ConvModule(ci, co, *a, eps=1e-3, device=device, **k)

        self.conv1 = conv(cin, planes, 1)
        depth = conv(planes, planes, 3, (t, s, s), 1, groups=planes)
        self.conv2 = nn.Sequential(conv(planes, planes, 1), depth) \
            if mode == "ip" else nn.Sequential(depth)
        self.conv3 = conv(planes, out, 1)
        self.downsample = (conv(cin, out, 1, (t, s, s))
                           if s > 1 or t > 1 or cin != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


@dataclasses.dataclass(frozen=True)
class CSNConfig:
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    base_channels: int = 64
    mode: str = "ir"              # ir-CSN / ip-CSN
    temporal_strides: Tuple[int, ...] = (1, 2, 2, 2)


@BACKBONES.register("CSN")
class CSN(nn.Module):
    """Channel-Separated Network (ir/ip-CSN)."""

    def __init__(self, cfg: CSNConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        c0 = cfg.base_channels
        self.conv1 = ConvModule(3, c0, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                                eps=1e-3, device=device)
        cin, planes = c0, c0
        for i, blocks in enumerate(cfg.stage_blocks):
            layer = [CSNBottleneck(cin, planes, 1 if i == 0 else 2,
                                   cfg.temporal_strides[i], cfg.mode, device)]
            layer += [CSNBottleneck(planes * 4, planes, 1, 1, cfg.mode, device)
                      for _ in range(1, blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            cin = planes * 4
            planes *= 2
        self.feat_dim = cin
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> pooled (B, C)."""
        x = _max_pool_stem(F.relu(self.conv1(_channels_first(videos))))
        for i in range(len(self.cfg.stage_blocks)):
            x = getattr(self, f"layer{i + 1}")(x)
        return _pool(x)


@dataclasses.dataclass(frozen=True)
class SlowFastConfig:
    depth_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    alpha: int = 4                 # the slow pathway takes every alpha-th
    beta_inv: int = 8              # fast channel thinning
    base_channels: int = 64
    lateral_kernel_t: int = 5
    spatial_strides: Tuple[int, ...] = (1, 2, 2, 2)
    lateral_norm: bool = False     # BN + ReLU after each lateral conv
    fast_s2d_stem: bool = False    # the fast stem through ops/s2d_stem.py


LATERALS = ("conv1_lateral", "layer1_lateral", "layer2_lateral",
            "layer3_lateral")


class SlowPath(nn.Module):
    """The slow pathway with its lateral convs (mmaction's `slow_path`)."""

    def __init__(self, cfg: SlowFastConfig, fast_dims: Sequence[int],
                 device=None):
        super().__init__()
        self.cfg = cfg
        c0, lk = cfg.base_channels, cfg.lateral_kernel_t
        self.conv1 = ConvModule(3, c0, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                                device=device)
        for name, cf in zip(LATERALS, fast_dims):
            setattr(self, name, ConvModule(
                cf, 2 * cf, (lk, 1, 1), (cfg.alpha, 1, 1), (lk // 2, 0, 0),
                norm=cfg.lateral_norm, device=device))
        cin, planes = c0, c0
        for i, (blocks, tk) in enumerate(zip(cfg.depth_blocks,
                                             (1, 1, 3, 3))):
            cin += 2 * fast_dims[i]
            layer = []
            for j in range(blocks):
                layer.append(Bottleneck3D(
                    cin, planes, cfg.spatial_strides[i] if j == 0 else 1, tk,
                    device=device))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            planes *= 2
        self.feat_dim = cin

    def forward(self, x: torch.Tensor,
                fast_feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = _max_pool_stem(F.relu(self.conv1(x)))
        for i, name in enumerate(LATERALS[:len(self.cfg.depth_blocks)]):
            lateral = getattr(self, name)(fast_feats[i])
            if self.cfg.lateral_norm:
                lateral = F.relu(lateral)
            t = min(x.shape[2], lateral.shape[2])
            x = torch.cat([x[:, :, :t], lateral[:, :, :t]], 1)
            x = getattr(self, f"layer{i + 1}")(x)
        return x


@BACKBONES.register("SlowFast")
class SlowFast(nn.Module):
    def __init__(self, cfg: SlowFastConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        fast_cfg = ResNet3DConfig(
            stage_blocks=cfg.depth_blocks, base_channels=cfg.base_channels,
            conv1_kernel_t=5, stage_temporal_kernels=(3, 3, 3, 3),
            channel_ratio=cfg.beta_inv,
            stage_spatial_strides=cfg.spatial_strides,
            s2d_stem=cfg.fast_s2d_stem)
        self.fast_path = ResNet3D(fast_cfg, device)
        cf = cfg.base_channels // cfg.beta_inv
        # the fast pathway's channels at the four fusion points
        fast_dims = [cf] + [cf * 2 ** i * 4 for i in range(3)]
        self.slow_path = SlowPath(cfg, fast_dims, device)
        self.feat_dim = self.slow_path.feat_dim + self.fast_path.feat_dim
        self.eval()

    def forward(self, videos: torch.Tensor, return_stages: bool = False):
        """videos: (B, T, H, W, 3) at the fast rate -> the pooled (B,
        C_slow + C_fast), or with return_stages the one-element list of
        the time-pooled (B, 1, H', W', C_slow + C_fast) map of the AVA
        head, channels-last."""
        fast = self.fast_path.stages(_channels_first(videos),
                                     include_stem=True)
        slow = self.slow_path(_channels_first(videos[:, ::self.cfg.alpha]),
                              fast)
        if return_stages:
            return [_channels_last(torch.cat(
                [slow.mean(2, keepdim=True),
                 fast[-1].mean(2, keepdim=True)], 1))]
        return torch.cat([_pool(slow), _pool(fast[-1])], -1)


def se_round_width(width: float, min_width: int = 8,
                   divisor: int = 8) -> int:
    """mmaction x3d.py SEModule._round_width: the SE bottleneck is the
    scaled width rounded to a multiple of 8 (at least 8, plus 8 where the
    rounding lost more than 10%)."""
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


class SEModule(nn.Module):
    """Squeeze-excitation: the global mean through fc1 (ReLU) and fc2
    (sigmoid) scales the channels.  fc1 and fc2 are mmaction's 1x1x1
    convs with bias, applied as the products they are."""

    def __init__(self, channels: int, ratio: float = 1 / 16, device=None):
        super().__init__()
        mid = se_round_width(channels * ratio)
        self.fc1 = nn.Conv3d(channels, mid, 1, device=device)
        self.fc2 = nn.Conv3d(mid, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3, 4))
        s = F.relu(F.linear(s, self.fc1.weight.flatten(1), self.fc1.bias))
        s = torch.sigmoid(F.linear(s, self.fc2.weight.flatten(1),
                                   self.fc2.bias))
        return x * s[:, :, None, None, None]


class X3DBlock(nn.Module):
    def __init__(self, cin: int, planes: int, inner: int,
                 spatial_stride: int = 1, use_se: bool = True, device=None):
        super().__init__()
        s = spatial_stride
        self.conv1 = ConvModule(cin, inner, 1, device=device)
        self.conv2 = ConvModule(inner, inner, 3, (1, s, s), 1, groups=inner,
                                device=device)
        self.se_module = SEModule(inner, device=device) if use_se else None
        self.conv3 = ConvModule(inner, planes, 1, device=device)
        self.downsample = (ConvModule(cin, planes, 1, (1, s, s),
                                      device=device)
                           if s != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = self.conv2(out)
        if self.se_module is not None:
            out = self.se_module(out)
        out = self.conv3(F.silu(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


@dataclasses.dataclass(frozen=True)
class X3DConfig:
    stage_blocks: Tuple[int, ...] = (3, 5, 11, 7)      # X3D-M
    stage_channels: Tuple[int, ...] = (24, 48, 96, 192)
    expansion: float = 2.25
    feat_dim: int = 432
    se_style: str = "half"        # SE on every other block; "all"


@BACKBONES.register("X3D")
class X3D(nn.Module):
    def __init__(self, cfg: X3DConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.cfg = cfg
        c0 = cfg.stage_channels[0]
        self.conv1_s = ConvModule(3, c0, (1, 3, 3), (1, 2, 2), (0, 1, 1),
                                  norm=False, device=device)
        self.conv1_t = ConvModule(c0, c0, (5, 1, 1), padding=(2, 0, 0),
                                  groups=c0, device=device)
        cin = c0
        for i, (blocks, ch) in enumerate(zip(cfg.stage_blocks,
                                             cfg.stage_channels)):
            inner = int(ch * cfg.expansion)
            layer = []
            for j in range(blocks):
                layer.append(X3DBlock(
                    cin, ch, inner, 2 if j == 0 else 1,
                    cfg.se_style == "all" or j % 2 == 0, device))
                cin = ch
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.conv5 = ConvModule(cin, cfg.feat_dim, 1, device=device)
        self.feat_dim = cfg.feat_dim
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> pooled (B, feat_dim)."""
        x = self.conv1_s(_channels_first(videos))
        x = F.relu(self.conv1_t(x))
        for i in range(len(self.cfg.stage_blocks)):
            x = getattr(self, f"layer{i + 1}")(x)
        return _pool(F.relu(self.conv5(x)))


def forward_flops(model: nn.Module, videos: torch.Tensor) -> float:
    """Multiply-adds x 2 of the model's convolutions (1-, 2- and 3-D),
    linear layers and non-local attention products on `videos`, read off
    their shapes in one forward (no grad)."""
    total = [0.0]

    def non_local_hook(m, inp, _out):
        b, _, t, h, w = inp[0].shape
        n = t * h * w
        total[0] += 2.0 * 2 * b * n * (t * (h // 2) * (w // 2)) * m.inter

    def conv_hook(m, _inp, out):
        k = m.weight.shape[1] * m.weight[0, 0].numel()    # cin/groups x kernel
        total[0] += 2.0 * out.numel() * k

    def linear_hook(m, _inp, out):
        total[0] += 2.0 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, nn.modules.conv._ConvNd)]
    hooks += [m.register_forward_hook(linear_hook) for m in model.modules()
              if isinstance(m, nn.Linear)]
    hooks += [m.register_forward_hook(non_local_hook) for m in model.modules()
              if isinstance(m, NonLocal3D)]
    # an s2d stem calls F.conv3d itself: count its plain conv's products
    for m in model.modules():
        if isinstance(m, ResNet3D) and m.cfg.s2d_stem:
            w = m.conv1.conv.weight
            hooks.append(m.conv1.bn.register_forward_hook(
                lambda _m, inp, _out, k=w[0].numel():
                total.__setitem__(0, total[0] + 2.0 * inp[0].numel() * k)))
    try:
        with torch.no_grad():
            model(videos)
    finally:
        for h in hooks:
            h.remove()
    return total[0]

"""ModifiedResNet CLIP vision tower (RN50x4) in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/clip_resnet.py, the
rebuild of the reference's modified CLIP ResNet
(MultiFusion/src/model/model.py:120-188): 3-conv stem with avgpool,
anti-aliased Bottleneck blocks (avgpool before the 1x1 conv of the
stride-2 path and of the shortcut), AttentionPool2d head, and the
MultiFusion change that `forward` returns (pooled, middle) where middle is
the layer3 (or layer2) feature map.

The modules compute in NCHW (cuDNN's layout) and take NHWC images as the
JAX models do.  Parameter names follow the OpenAI CLIP-RN state dict that
the JAX package's `convert_clip_resnet` (convert/torch_import.py)
reads (`visual.layer{s}.{i}.downsample.{0,1}`, `visual.attnpool.*`; the
text tower at the top level), so one state dict loads into both packages.

BatchNorm: the models are built in eval mode, which normalizes by the
running statistics with eps 1e-5, as the JAX model's inference does (flax's
momentum 0.9 is torch's 0.1).  Nothing trains this tower: the Combiner's
trainer keeps the CLIP towers frozen.

Precision: every convolution and product is f32 (the JAX config's
dtype="float32"; the text tower follows `cfg.dtype`).  The images arrive
bf16 from ops/preprocess.clip_preprocess and are widened, as flax
promotes them against f32 kernels.  On the card cuDNN computes f32
convolutions in TF32 unless `torch.backends.cudnn.allow_tf32` is False;
the composed entry points turn TF32 off (utils/precision.no_tf32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .clip import CLIPConfig, TextTower


@dataclasses.dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: Tuple[int, int, int, int] = (4, 6, 10, 6)   # RN50x4
    width: int = 80                                     # RN50x4 base width
    output_dim: int = 640
    heads: int = 40
    image_resolution: int = 288
    # which stage's map is the 'middle' feature the Combiner consumes:
    # 3 = the raw layer3 map (16*width channels; RN50x4: 1280 at 18x18),
    # which the callers adaptive-avg-pool over (tokens, channels) to
    # (16, 640); 2 = the layer2 map (8*width channels)
    middle_stage: int = 3


def _bn(channels: int, device) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1, device=device)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False, device=device)
        self.bn1 = _bn(planes, device)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False,
                               device=device)
        self.bn2 = _bn(planes, device)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1,
                               bias=False, device=device)
        self.bn3 = _bn(planes * self.expansion, device)
        self.downsample = None
        if stride > 1 or inplanes != planes * self.expansion:
            # OpenAI's Sequential("-1": AvgPool2d, "0": conv, "1": bn); the
            # pool has no parameters, so it is applied in forward
            self.downsample = nn.Sequential()
            self.downsample.add_module("0", nn.Conv2d(
                inplanes, planes * self.expansion, 1, bias=False,
                device=device))
            self.downsample.add_module("1", _bn(planes * self.expansion,
                                                device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:       # anti-aliased downsample: avgpool, conv
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        sc = x
        if self.downsample is not None:
            if self.stride > 1:
                sc = F.avg_pool2d(sc, self.stride)
            sc = self.downsample(sc)
        return F.relu(out + sc)


class AttentionPool2d(nn.Module):
    """(B, C, H, W) -> (B, output_dim): one query, the mean token, over the
    mean and the H·W tokens with a learned positional embedding
    (model.py:76-118); scores by 1/sqrt(head dim), softmax in f32."""

    def __init__(self, spacial: int, embed_dim: int, heads: int,
                 output_dim: int, device=None):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial * spacial + 1, embed_dim, device=device))
        self.q_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.k_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.v_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.c_proj = nn.Linear(embed_dim, output_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)              # (B, HW, C)
        tokens = torch.cat([tokens.mean(1, keepdim=True), tokens], 1)
        tokens = tokens + self.positional_embedding
        heads, hd = self.heads, c // self.heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, heads, hd).transpose(
            1, 2)
        k = self.k_proj(tokens).reshape(b, -1, heads, hd).transpose(1, 2)
        v = self.v_proj(tokens).reshape(b, -1, heads, hd).transpose(1, 2)
        wts = torch.softmax((q.float() @ k.float().transpose(-1, -2))
                            / math.sqrt(hd), dim=-1)
        out = (wts @ v.float()).transpose(1, 2).reshape(b, c)
        return self.c_proj(out)


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ModifiedResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1 = nn.Conv2d(3, w // 2, 3, stride=2, padding=1, bias=False,
                               device=device)
        self.bn1 = _bn(w // 2, device)
        self.conv2 = nn.Conv2d(w // 2, w // 2, 3, padding=1, bias=False,
                               device=device)
        self.bn2 = _bn(w // 2, device)
        self.conv3 = nn.Conv2d(w // 2, w, 3, padding=1, bias=False,
                               device=device)
        self.bn3 = _bn(w, device)
        inplanes = w
        for s, (mult, stride) in enumerate(((1, 1), (2, 2), (4, 2), (8, 2))):
            blocks = []
            for i in range(cfg.layers[s]):
                blocks.append(BottleneckBlock(inplanes, w * mult,
                                              stride if i == 0 else 1,
                                              device))
                inplanes = w * mult * BottleneckBlock.expansion
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, w * 32,
                                        cfg.heads, cfg.output_dim, device)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: (B, H, W, 3), any float dtype -> (high (B, output_dim)
        f32, middle (B, C, h, w) f32 = the layer3 (or layer2) map)."""
        x = images.to(torch.float32).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        x = self.layer2(self.layer1(x))
        middle = x
        x = self.layer3(x)
        if self.cfg.middle_stage == 3:
            middle = x
        high = self.attnpool(self.layer4(x))
        return high, middle


@dataclasses.dataclass(frozen=True)
class CLIPResNetConfig:
    """The JAX package's CLIPResNetConfig, field for field: the full CLIP
    dual tower with the ModifiedResNet visual (the RN50x4 checkpoint
    MultiFusion loads, src/inference.py:179-196)."""
    embed_dim: int = 640
    vision_layers: Tuple[int, int, int, int] = (4, 6, 10, 6)
    vision_width: int = 80
    image_resolution: int = 288
    middle_stage: int = 3
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 640
    text_heads: int = 10
    text_layers: int = 12
    dtype: str = "float32"

    def vision_cfg(self) -> ModifiedResNetConfig:
        return ModifiedResNetConfig(
            layers=tuple(self.vision_layers), width=self.vision_width,
            output_dim=self.embed_dim,
            heads=self.vision_width * 32 // 64,
            image_resolution=self.image_resolution,
            middle_stage=self.middle_stage)

    def text_cfg(self) -> CLIPConfig:
        """The text tower's config; it runs unfused, as in the JAX
        package."""
        return CLIPConfig(
            embed_dim=self.embed_dim, context_length=self.context_length,
            vocab_size=self.vocab_size, text_width=self.text_width,
            text_heads=self.text_heads, text_layers=self.text_layers,
            dtype=self.dtype)


class CLIPResNetModel(TextTower):
    """CLIP with the ModifiedResNet visual and the causal text tower, in
    the OpenAI state-dict layout (text at the top level, `visual`,
    `logit_scale`).  Built in eval mode on `device` (None: the CUDA
    device)."""

    def __init__(self, cfg: CLIPResNetConfig, device=None):
        device = resolve_device(device)
        super().__init__(cfg.text_cfg(), device)
        self.rn_cfg = cfg
        self.visual = ModifiedResNet(cfg.vision_cfg(), device)
        self.logit_scale = nn.Parameter(
            torch.tensor(np.log(1 / 0.07), dtype=torch.float32,
                         device=device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def encode_image(self, images: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) -> (high (B, E), middle (B, h*w, C)).

        The middle "tokens" keep the reference's element order:
        inference.py:58 reshapes the torch NCHW layer3 buffer straight to
        (B, h*w, C) without a transpose, so each row mixes channels and
        positions; the Combiner checkpoint was trained on that order."""
        high, middle = self.visual(images)
        b, c, h, w = middle.shape
        return high, middle.reshape(b, h * w, c)

    def encode_video(self, frames: torch.Tensor):
        """(B, F, H, W, 3) -> (high (B, F, E), middle (B, F, h*w, C)),
        frames folded into the batch."""
        b, f = frames.shape[:2]
        high, middle = self.encode_image(frames.reshape(b * f,
                                                        *frames.shape[2:]))
        return high.reshape(b, f, -1), middle.reshape(b, f,
                                                      *middle.shape[1:])

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        return TextTower.forward(self, text_ids)

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor):
        """Contrastive logits (logits_per_image, logits_per_text)."""
        from ..ops.similarity import l2norm

        image_features = l2norm(self.encode_image(images)[0])
        text_features = l2norm(self.encode_text(text_ids))
        logits = self.logit_scale.exp() * image_features @ text_features.t()
        return logits, logits.t()


def random_state_dict(cfg: CLIPResNetConfig, seed: int
                      ) -> Dict[str, torch.Tensor]:
    """An OpenAI-layout CLIP-RN state dict of random f32 weights from a
    numpy seed: convolutions and matrices at fan-in scale, BatchNorm
    scales near 1 with biases, running means and running variances away
    from (0, 1), LayerNorms near unit, embeddings as in
    clip.random_state_dict.  Both packages load it (the JAX one through
    convert_clip_resnet)."""
    rng = np.random.default_rng(seed)
    shapes = CLIPResNetModel(cfg, device="meta").state_dict()
    out = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        last = name.rsplit(".", 1)[-1]
        is_bn = (".bn" in name or ".downsample.1." in name) \
            and "attnpool" not in name
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64)
            continue
        z = rng.standard_normal(shape, dtype=np.float32) \
            if name != "logit_scale" else None
        if name == "logit_scale":
            a = np.full(shape, np.log(1 / 0.07))
        elif is_bn and last == "running_mean":
            a = 0.1 * z
        elif is_bn and last == "running_var":
            a = 1.0 + 0.4 * np.tanh(z)              # in (0.6, 1.4)
        elif is_bn and last == "weight":
            a = 1.0 + 0.1 * z
        elif ".ln_" in name or name.startswith("ln_"):
            a = (1.0 if last == "weight" else 0.0) + 0.1 * z
        elif last == "bias" or name == "token_embedding.weight":
            a = 0.02 * z
        elif name == "text_projection":                    # x @ proj
            a = shape[0] ** -0.5 * z
        elif name in ("visual.attnpool.positional_embedding",
                      "positional_embedding"):
            a = shape[-1] ** -0.5 * z
        else:                           # Linear (out, in), Conv2d (O, I, k, k)
            a = int(np.prod(shape[1:])) ** -0.5 * z
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out

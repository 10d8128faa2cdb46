"""VideoCLIP: a contrastive video-text model with per-second video tokens,
in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/videoclip.py (the
in-tree rebuild of the reference's fairseq MMPT VideoCLIP):

* `S3DLite`: a separable (2+1)-D conv stack, one feature per second of
  `fps` frames (explicit symmetric paddings, a VALID 1x2x2 max pool);
* the video side: [CLS] and the second tokens, a learned position table,
  a CLIP transformer (models/clip.py's `Transformer`, fp32 layers), its
  CLS token through `ln_video`;
* the text side: a token table, a position table, the same transformer
  with each example's pad keys masked by an additive -1e9 (B, 1, 1, S)
  mask (id 0 is padding), `ln_text`, the mean over the non-pad tokens;
* `forward(videos, text_ids)`: the contrastive logits at
  exp(logit_scale), logit_scale starting at log(1/0.07);
  `forward(videos)` the pooled video embedding (`encode_video`, the
  backbone contract).
`encode_video` truncates the frames to secs·fps with secs =
max(T // fps, 1).  No importer reads a reference VideoCLIP, so the keys
follow the JAX tree (`video_encoder.conv_*`, `video_cls`, `video_pos`,
`token_embedding`, `text_pos`, `logit_scale`), the transformers and their
LayerNorms in the port's CLIP layout; `convert/from_jax.py` carries them
both ways.  Parameters stay fp32; the convs and `proj` compute in the
dtype flax would (models/flax_nn.py), the transformers in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import BACKBONES
from .clip import LayerNormF32, Transformer
from .flax_nn import Conv3d, Dense


@dataclasses.dataclass(frozen=True)
class VideoCLIPConfig:
    fps: int = 4                   # frames folded into one video token
    s3d_channels: int = 64
    width: int = 256               # transformer / embedding width
    layers: int = 4
    heads: int = 4
    vocab_size: int = 30522        # BERT-style text vocab
    max_text_len: int = 32
    max_video_len: int = 32        # max seconds


class S3DLite(nn.Module):
    """(B, S, fps, H, W, 3) -> (B, S, width): one pooled feature a
    second."""

    def __init__(self, channels: int, width: int, device=None):
        super().__init__()
        c = channels
        self.conv_s1 = Conv3d(3, c, (1, 7, 7), (1, 2, 2),
                              ((0, 0), (3, 3), (3, 3)), device=device)
        self.conv_t1 = Conv3d(c, c, (3, 1, 1), (1, 1, 1),
                              ((1, 1), (0, 0), (0, 0)), device=device)
        self.conv_s2 = Conv3d(c, 2 * c, (1, 3, 3), (1, 1, 1),
                              ((0, 0), (1, 1), (1, 1)), device=device)
        self.conv_t2 = Conv3d(2 * c, 2 * c, (3, 1, 1), (1, 1, 1),
                              ((1, 1), (0, 0), (0, 0)), device=device)
        self.proj = Dense(2 * c, width, device=device)
        self.width = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[:2]
        x = x.reshape(B * S, *x.shape[2:])            # (BS, fps, H, W, 3)
        x = F.relu(self.conv_t1(self.conv_s1(x)))
        x = F.max_pool3d(x.permute(0, 4, 1, 2, 3), (1, 2, 2),
                         (1, 2, 2)).permute(0, 2, 3, 4, 1)
        x = F.relu(self.conv_t2(self.conv_s2(x)))
        return self.proj(x.mean(dim=(1, 2, 3))).reshape(B, S, self.width)


@BACKBONES.register("VideoCLIP")
class VideoCLIP(nn.Module):
    def __init__(self, cfg: VideoCLIPConfig, device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.video_encoder = S3DLite(c.s3d_channels, c.width, device)
        self.video_cls = nn.Parameter(torch.zeros(c.width, device=device))
        self.video_pos = nn.Parameter(torch.zeros(c.max_video_len + 1,
                                                  c.width, device=device))
        self.video_transformer = Transformer(c.width, c.layers, c.heads,
                                             torch.float32, device)
        self.ln_video = LayerNormF32(c.width, device)
        self.token_embedding = nn.Parameter(torch.zeros(
            c.vocab_size, c.width, device=device))
        self.text_pos = nn.Parameter(torch.zeros(c.max_text_len, c.width,
                                                 device=device))
        self.text_transformer = Transformer(c.width, c.layers, c.heads,
                                            torch.float32, device)
        self.ln_text = LayerNormF32(c.width, device)
        self.logit_scale = nn.Parameter(torch.tensor(
            float(np.log(1 / 0.07)), device=device))
        self.feat_dim = c.width

    def encode_video(self, videos: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> the pooled video embedding (B, width): the
        frames folded into max(T // fps, 1) second tokens."""
        c = self.cfg
        B, T = videos.shape[:2]
        secs = max(T // c.fps, 1)
        videos = videos[:, :secs * c.fps]
        tokens = self.video_encoder(
            videos.reshape(B, secs, c.fps, *videos.shape[2:]))
        cls = self.video_cls.expand(B, 1, c.width)
        h = torch.cat([cls, tokens], 1)
        h = h + self.video_pos[:h.shape[1]]
        return self.ln_video(self.video_transformer(h)[:, 0])

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) int ids -> the pooled text embedding (B, width): id 0 is
        padding, masked out of the attention and of the mean."""
        h = self.token_embedding[text_ids]
        h = h + self.text_pos[:h.shape[1]]
        pad = text_ids == 0
        mask = torch.where(pad[:, None, None, :], -1e9, 0.0).to(
            h.device, torch.float32)
        h = self.ln_text(self.text_transformer(h, mask))
        keep = (~pad).to(h.dtype)[..., None]
        return (h * keep).sum(1) / keep.sum(1).clamp_min(1.0)

    def forward(self, videos: torch.Tensor,
                text_ids: Optional[torch.Tensor] = None):
        """With text_ids: (logits_per_video, logits_per_text) at
        exp(logit_scale); without: encode_video(videos)."""
        v = self.encode_video(videos)
        if text_ids is None:
            return v
        t = self.encode_text(text_ids)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
        logits = self.logit_scale.exp() * v @ t.t()
        return logits, logits.t()


class VideoCLIPPooled(nn.Module):
    """The backbone contract over VideoCLIP.encode_video (videos -> (B,
    width)), its parameters under `videoclip` (the JAX CLI's
    `_VideoCLIPPooled`)."""

    def __init__(self, cfg: VideoCLIPConfig, device=None):
        super().__init__()
        self.videoclip = VideoCLIP(cfg, device)
        self.feat_dim = cfg.width

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        return self.videoclip.encode_video(videos)

"""Video recognizers on the TimeSformer backbone: classification and
label-sequence (caption) heads, in PyTorch.

Counterpart of the TimeSformer recognizers of
cross_modal_video_engine_tpu/models/recognizer.py:

* `TimeSformerHead`: a linear classifier on the backbone's CLS feature;
* `average_clip`: scores (or probabilities) averaged over test clips;
* `Recognizer3D`: backbone -> head -> class scores, plus the explain
  surface (`forward_with_capture`, `score_from_layer`);
* `Recognizer3DRelseq`: backbone -> RNNDecoderHead, greedy feedback at
  inference, per-step probabilities averaged over clips.

The heads compute in fp32 on the parameters' values: the backbone's CLS
feature is fp32, and the JAX heads promote to it.  State-dict keys are
`backbone.*` (models/timesformer.py) and `cls_head.*` (`fc_cls` for
classification, the reference RNN head's names for captions).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .decoder_head import RNNDecoderConfig, RNNDecoderHead
from .timesformer import LN, TimeSformer, TimeSformerConfig


class TimeSformerHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fc_cls = nn.Linear(in_channels, num_classes, dtype=dtype,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.fc_cls.weight.float(),
                        self.fc_cls.bias.float())


def average_clip(scores: torch.Tensor, num_segs: int,
                 average_clips: Optional[str] = "prob") -> torch.Tensor:
    """(B*num_segs, ...) -> (B, ...), mmaction's base.py semantics."""
    scores = scores.reshape(-1, num_segs, *scores.shape[1:])
    if average_clips == "prob":
        return torch.softmax(scores, dim=-1).mean(1)
    if average_clips == "score":
        return scores.mean(1)
    if average_clips is None:
        return scores
    raise ValueError(average_clips)


class Recognizer3D(nn.Module):
    def __init__(self, backbone_cfg: TimeSformerConfig, num_classes: int,
                 device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.backbone = TimeSformer(backbone_cfg, device)
        self.cls_head = TimeSformerHead(num_classes, backbone_cfg.embed_dims,
                                        backbone_cfg.torch_dtype(), device)
        self.eval()   # the JAX default (train=False); .train() for dropout

    def extract_feat(self, videos: torch.Tensor) -> torch.Tensor:
        return self.backbone(videos)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> class scores (B, num_classes)."""
        return self.cls_head(self.backbone(videos))

    def forward_test(self, videos: torch.Tensor, num_segs: int = 1,
                     average_clips: Optional[str] = "prob") -> torch.Tensor:
        return average_clip(self(videos), num_segs, average_clips)

    def forward_with_capture(self, videos: torch.Tensor,
                             layers: Sequence[int]):
        """Class scores and the token sequences after blocks `layers`."""
        feat, captured = self.backbone(videos, capture_layers=tuple(layers))
        return self.cls_head(feat), captured

    def score_from_layer(self, tokens: torch.Tensor,
                         layer: int) -> torch.Tensor:
        """Class scores recomputed from the tokens after block `layer`."""
        return self.cls_head(self.backbone.forward_from(tokens, layer))


class Recognizer3DRelseq(nn.Module):
    def __init__(self, backbone_cfg: TimeSformerConfig,
                 decoder_cfg: RNNDecoderConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.backbone = TimeSformer(backbone_cfg, device)
        self.cls_head = RNNDecoderHead(decoder_cfg,
                                       backbone_cfg.torch_dtype(), device)
        self.eval()   # the JAX default (train=False); .train() for dropout

    def extract_feat(self, videos: torch.Tensor) -> torch.Tensor:
        return self.backbone(videos)

    def forward(self, videos: torch.Tensor,
                targets_emb: Optional[torch.Tensor] = None,
                mode: str = "inference") -> torch.Tensor:
        return self.cls_head(self.backbone(videos), targets_emb, mode=mode)

    def forward_test(self, videos: torch.Tensor,
                     num_segs: int = 1) -> torch.Tensor:
        """Greedy decode, per-step probabilities averaged over clips."""
        probs = self(videos, mode="inference")
        return probs.reshape(-1, num_segs, *probs.shape[1:]).mean(1)


def random_state_dict(backbone_cfg: TimeSformerConfig, seed: int, *,
                      num_classes: Optional[int] = None,
                      decoder_cfg: Optional[RNNDecoderConfig] = None
                      ) -> Dict[str, torch.Tensor]:
    """A Recognizer3D (num_classes) or Recognizer3DRelseq (decoder_cfg)
    state dict of random fp32 weights made from a numpy seed: LayerNorms
    near unit, biases small, matrices and convs at lecun-normal scale,
    token embeddings at 0.02, the start embedding at 1.  The divided
    layout also loads into the JAX package through convert_timesformer,
    so tests and smoke runs need no downloaded weights."""
    if (num_classes is None) == (decoder_cfg is None):
        raise ValueError("give num_classes or decoder_cfg")
    model = (Recognizer3D(backbone_cfg, num_classes, device="meta")
             if decoder_cfg is None else
             Recognizer3DRelseq(backbone_cfg, decoder_cfg, device="meta"))
    norms = {n for n, m in model.named_modules() if isinstance(m, LN)}
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        owner, leaf = name.rsplit(".", 1)
        if owner in norms:
            a = (1.0 if leaf == "weight" else 0.0) \
                + 0.1 * rng.standard_normal(shape)
        elif leaf in ("cls_token", "pos_embed", "time_embed"):
            a = 0.02 * rng.standard_normal(shape)
        elif name.endswith("start_emb.weight"):
            a = rng.standard_normal(shape)
        elif leaf.startswith("bias"):
            a = 0.02 * rng.standard_normal(shape)
        else:                          # Linear (out, in), GRU, convs
            a = int(np.prod(shape[1:])) ** -0.5 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out

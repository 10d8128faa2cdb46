"""Video recognizers: classification and label-sequence (caption) heads
on the TimeSformer and on the 3D-CNN backbones, in PyTorch.

Counterpart of the TimeSformer and 3D-CNN recognizers of
cross_modal_video_engine_tpu/models/recognizer.py:

* `TimeSformerHead`: a linear classifier on the backbone's CLS feature;
* `average_clip`: scores (or probabilities) averaged over test clips;
* `Recognizer3D`: backbone -> head -> class scores, plus the explain
  surface (`forward_with_capture`, `score_from_layer`);
* `Recognizer3DShuffleEmb`, `Recognizer3DShuffleSoft`,
  `Recognizer3DShuffleExtra`: Recognizer3Ds whose `forward_train(videos,
  shuffle_videos, labels)` contrasts ordered and frame-shuffled clips
  (losses/shuffle.py);
* `Recognizer3DRelseq`: backbone -> RNNDecoderHead, greedy feedback at
  inference, per-step probabilities averaged over clips; `forward_train`
  is the teacher-forced SeqMLL loss in train mode;
* `Recognizer3DCaption`: backbone tokens -> the word-level
  CaptionTransformer (models/caption_transformer.py), teacher forcing
  and greedy or beam `generate`;
* `BackboneClassifier`: a 3D-CNN backbone's pooled feature into an
  I3DHead (dropout 0.5, also for SlowFast); `X3DClassifier`: X3D into
  the two-layer X3DHead; `RecognizerRelseq`: any pooled backbone into
  the RNNDecoderHead, `forward_train` and `forward_test` as
  Recognizer3DRelseq's (models/resnet3d.py, models/heads.py);
* `Recognizer2D`: a per-frame backbone's (B, T, C) features into a
  TSNHead or TRNHead, `forward_test` its softmax (models/backbones2d.py,
  tin_mobilenet.py, tanet.py);
* `TPNRecognizer`: a ResNet3D's last stage maps through the TPN neck
  (models/tpn.py), the global mean, dropout and `cls_head.fc_cls`; in
  train mode it returns (scores, {"loss_aux"}) given the labels;
* `Recognizer3DCLIP`: the B·T frames through the CLIP vision tower
  (models/clip.py, fp32 masters, the config's dtype and fused flags),
  the time mean of its `high` feature and `fc_cls`; like the JAX class it
  has no `forward_test`;
* `init_state_dict`: a training init drawn from a numpy seed with flax's
  init schemes (what the JAX package's `model.init` draws), and
  `conv_init_state_dict` the same for the 3D-CNN recognizers and for the
  transformer backbones of models/{swin3d,mvit,videomae_vit,videoclip}.py
  and Recognizer3DCLIP.

The TimeSformer recognizers keep f32 masters, as the JAX package's init
does (a serving loader casts the whole model to bf16 where the config
says so); their heads compute in fp32 on the parameters' values: the
backbone's CLS feature is fp32, and the JAX heads promote to it; the
3D-CNN heads compute in their parameters' dtype, as flax's Dense does on
the pooled feature.  State-dict keys are `backbone.*`
(models/timesformer.py, models/resnet3d.py) and `cls_head.*` (`fc_cls`
for classification, `fc1`/`fc2` for X3DHead, the reference RNN head's
names for captions).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..losses.seqmll import seq_mll_loss
from ..utils.device import resolve_device
from ..utils.registry import RECOGNIZERS
from .caption_transformer import CaptionConfig, CaptionTransformer
from .clip import MHA, CLIPConfig, LayerNormF32, PatchEmbed, VisionTower
from ..ops.mixed_precision import acc_dtype
from .flax_nn import Dense, LayerNorm
from .decoder_head import RNNDecoderConfig, RNNDecoderHead
from .heads import I3DHead, TRNHead, TSNHead, X3DHead
from .layers import FlaxBatchNorm
from .timesformer import LN, TimeSformer, TimeSformerConfig
from .tpn import TPN, TPNConfig, stage_maps


class TimeSformerHead(nn.Module):
    def __init__(self, num_classes: int, in_channels: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fc_cls = nn.Linear(in_channels, num_classes, dtype=dtype,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = acc_dtype(x.dtype, self.fc_cls.weight.dtype)   # fp32 or wider
        return F.linear(x.to(dt), self.fc_cls.weight.to(dt),
                        self.fc_cls.bias.to(dt))


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


@RECOGNIZERS.register("Recognizer3D")
class Recognizer3D(nn.Module):
    def __init__(self, backbone_cfg: TimeSformerConfig, num_classes: int,
                 device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.num_classes = num_classes
        self.backbone = TimeSformer(backbone_cfg, device)
        self.cls_head = TimeSformerHead(num_classes, backbone_cfg.embed_dims,
                                        device=device)
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


class _ShuffleBase(Recognizer3D):
    """The shuffle-contrast recognizers (JAX recognizer.py:57-143, MCT
    recognizer_shuffle.py:13, 141, 269): a Recognizer3D (the same
    `backbone` and `cls_head` state dict) whose `forward_train` also runs
    a frame-shuffled copy of each clip through the backbone and contrasts
    the two; inference is Recognizer3D's.  forward_train switches to
    train mode, as the JAX method runs with train=True, and returns
    {"loss_cls", ..., "loss"}."""

    def _features(self, videos, shuffle_videos):
        self.train()
        return self.backbone(videos), self.backbone(shuffle_videos)


@RECOGNIZERS.register("Recognizer3DShuffleEmb")
class Recognizer3DShuffleEmb(_ShuffleBase):
    """Cross entropy on the ordered clip plus cos_weight times the cosine
    push-away between the ordered and shuffled CLS features
    (ce_cos_loss.py shuffle_score)."""

    def __init__(self, backbone_cfg: TimeSformerConfig, num_classes: int,
                 device=None, margin: float = 0.5, cos_weight: float = 0.5):
        super().__init__(backbone_cfg, num_classes, device)
        self.margin, self.cos_weight = margin, cos_weight

    def forward_train(self, videos, shuffle_videos, labels):
        from ..losses.shuffle import cosine_away_loss
        x, sx = self._features(videos, shuffle_videos)
        loss_cls = F.cross_entropy(self.cls_head(x), labels)
        loss_cos = self.cos_weight * cosine_away_loss(x, sx, self.margin)
        return {"loss_cls": loss_cls, "loss_cos": loss_cos,
                "loss": loss_cls + loss_cos}


@RECOGNIZERS.register("Recognizer3DShuffleSoft")
class Recognizer3DShuffleSoft(_ShuffleBase):
    """Cross entropy on the ordered clip plus soft_weight times the
    soft-label cross entropy of the shuffled clip's scores: the true
    class at `margin`, the rest (1 - margin) / C (ce_soft_loss.py)."""

    def __init__(self, backbone_cfg: TimeSformerConfig, num_classes: int,
                 device=None, margin: float = 0.5, soft_weight: float = 0.5):
        super().__init__(backbone_cfg, num_classes, device)
        self.margin, self.soft_weight = margin, soft_weight

    def forward_train(self, videos, shuffle_videos, labels):
        from ..losses.shuffle import soft_cross_entropy, soft_label_smooth
        x, sx = self._features(videos, shuffle_videos)
        loss_cls = F.cross_entropy(self.cls_head(x), labels)
        soft = soft_label_smooth(labels, self.num_classes, self.margin)
        loss_soft = self.soft_weight * soft_cross_entropy(self.cls_head(sx),
                                                          soft)
        return {"loss_cls": loss_cls, "loss_soft": loss_soft,
                "loss": loss_cls + loss_soft}


@RECOGNIZERS.register("Recognizer3DShuffleExtra")
class Recognizer3DShuffleExtra(_ShuffleBase):
    """Shuffled clips are their own class, the last of num_classes (build
    with the real classes + 1): one cross entropy over the ordered clips'
    scores with their labels and the shuffled clips' with label
    num_classes - 1 (recognizer_shuffle.py:289-297)."""

    def forward_train(self, videos, shuffle_videos, labels):
        x, sx = self._features(videos, shuffle_videos)
        scores = torch.cat([self.cls_head(x), self.cls_head(sx)])
        shuffle_labels = torch.full((sx.shape[0],), self.num_classes - 1,
                                    dtype=labels.dtype, device=labels.device)
        loss = F.cross_entropy(scores, torch.cat([labels, shuffle_labels]))
        return {"loss_cls": loss, "loss": loss}


SHUFFLE_RECOGNIZERS = (Recognizer3DShuffleEmb, Recognizer3DShuffleSoft,
                       Recognizer3DShuffleExtra)


@RECOGNIZERS.register("Recognizer3DRelseq")
class Recognizer3DRelseq(nn.Module):
    def __init__(self, backbone_cfg: TimeSformerConfig,
                 decoder_cfg: RNNDecoderConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.backbone = TimeSformer(backbone_cfg, device)
        self.cls_head = RNNDecoderHead(decoder_cfg, device=device)
        self.eval()   # the JAX default (train=False); .train() for dropout

    def extract_feat(self, videos: torch.Tensor) -> torch.Tensor:
        return self.backbone(videos)

    def forward(self, videos: torch.Tensor,
                targets_emb: Optional[torch.Tensor] = None,
                mode: str = "inference") -> torch.Tensor:
        return self.cls_head(self.backbone(videos), targets_emb, mode=mode)

    def forward_train(self, videos: torch.Tensor, targets_emb: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        """The SeqMLL loss of a teacher-forced forward (JAX
        recognizer.py:296-299).  Switches the model to train mode, as the
        JAX method always runs with train=True: DropPath, the embedding
        dropouts and the decoder's input dropout act.  The loss takes the
        decoder's sigmoid probabilities, not logits, as the reference's
        does (recognizer3d_relseq.py:75-91)."""
        self.train()
        probs = self(videos, targets_emb, mode="train")
        return seq_mll_loss(probs, targets_emb, mask)

    def forward_test(self, videos: torch.Tensor,
                     num_segs: int = 1) -> torch.Tensor:
        """Greedy decode, per-step probabilities averaged over clips."""
        probs = self(videos, mode="inference")
        return probs.reshape(-1, num_segs, *probs.shape[1:]).mean(1)


@RECOGNIZERS.register("Recognizer3DCaption")
class Recognizer3DCaption(nn.Module):
    """The backbone's final token sequence (fp32, CLS first) into the
    word-level caption transformer (JAX recognizer.py:249-276).  State-dict
    keys: `backbone.*` and `caption_head.<JAX parameter name>`."""

    def __init__(self, backbone_cfg: TimeSformerConfig,
                 caption_cfg: CaptionConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.backbone = TimeSformer(backbone_cfg, device)
        self.caption_head = CaptionTransformer(caption_cfg, device)
        self.eval()

    def _enc_tokens(self, videos: torch.Tensor) -> torch.Tensor:
        return self.backbone(videos, return_tokens=True)[1]

    def forward(self, videos: torch.Tensor,
                token_ids: torch.Tensor) -> torch.Tensor:
        """Teacher forcing: (B, T, vocab) logits."""
        return self.caption_head(self._enc_tokens(videos), token_ids,
                                 mode="train")

    def generate(self, videos: torch.Tensor, mode: str = "greedy",
                 beam_width: int = 4):
        """(ids (B, max_len), logprob (B,)) of the greedy decode or of the
        best beam."""
        return self.caption_head(self._enc_tokens(videos), None, mode=mode,
                                 beam_width=beam_width)


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


@RECOGNIZERS.register("BackboneClassifier")
class BackboneClassifier(nn.Module):
    """A 3D-CNN backbone's pooled feature -> I3DHead class scores (JAX
    recognizer.py:146-173).  The head's dropout is 0.5 for every family,
    SlowFast included, as the JAX module has it.  Any (T, H, W) the
    backbone takes."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 dropout_ratio: float = 0.5):
        super().__init__()
        self.backbone = backbone
        self.cls_head = I3DHead(backbone.feat_dim, num_classes, dropout_ratio,
                                device=_device_of(backbone))
        self.eval()

    def extract_feat(self, videos: torch.Tensor) -> torch.Tensor:
        return self.backbone(videos)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> class scores (B, num_classes)."""
        return self.cls_head(self.backbone(videos))

    def forward_test(self, videos: torch.Tensor, num_segs: int = 1,
                     average_clips: Optional[str] = "prob") -> torch.Tensor:
        return average_clip(self(videos), num_segs, average_clips)


@RECOGNIZERS.register("X3DClassifier")
class X3DClassifier(BackboneClassifier):
    """X3D and the two-layer X3DHead (fc1 -> ReLU -> dropout -> fc2; JAX
    recognizer.py:342-362), mmaction's x3d checkpoint layout."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 mid_channels: int = 2048, dropout_ratio: float = 0.5):
        nn.Module.__init__(self)
        self.backbone = backbone
        self.cls_head = X3DHead(backbone.feat_dim, num_classes, mid_channels,
                                dropout_ratio, device=_device_of(backbone))
        self.eval()


@RECOGNIZERS.register("RecognizerRelseq")
class RecognizerRelseq(nn.Module):
    """Any pooled (B, D) backbone into the RNN decoder head (JAX
    recognizer.py:310-339), the seq_generate family's 3D-CNN members."""

    def __init__(self, backbone: nn.Module, decoder_cfg: RNNDecoderConfig):
        super().__init__()
        self.backbone = backbone
        self.cls_head = RNNDecoderHead(decoder_cfg, torch.float32,
                                       _device_of(backbone))
        self.eval()

    def extract_feat(self, videos: torch.Tensor) -> torch.Tensor:
        return self.backbone(videos)

    def forward(self, videos: torch.Tensor,
                targets_emb: Optional[torch.Tensor] = None,
                mode: str = "inference") -> torch.Tensor:
        return self.cls_head(self.backbone(videos), targets_emb, mode=mode)

    def forward_train(self, videos: torch.Tensor, targets_emb: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
        """The SeqMLL loss of a teacher-forced forward in train mode: the
        BatchNorms normalize by the batch and move their statistics, the
        decoder's input dropout acts."""
        self.train()
        probs = self(videos, targets_emb, mode="train")
        return seq_mll_loss(probs, targets_emb, mask)

    def forward_test(self, videos: torch.Tensor,
                     num_segs: int = 1) -> torch.Tensor:
        """Greedy decode, per-step probabilities averaged over clips."""
        probs = self(videos, mode="inference")
        return probs.reshape(-1, num_segs, *probs.shape[1:]).mean(1)


@RECOGNIZERS.register("Recognizer2D")
class Recognizer2D(nn.Module):
    """A per-frame backbone (B, T, H, W, 3) -> (B, T, C) and a consensus
    head (TSNHead, or TRNHead with trn=dict(...) of its options; JAX
    recognizer.py:210-228)."""

    def __init__(self, backbone: nn.Module, num_classes: int,
                 trn: Optional[dict] = None, dropout_ratio: float = 0.4):
        super().__init__()
        self.backbone = backbone
        dev = _device_of(backbone)
        self.cls_head = (TSNHead(backbone.feat_dim, num_classes,
                                 dropout_ratio, device=dev)
                         if trn is None else
                         TRNHead(backbone.feat_dim, num_classes, **trn,
                                 device=dev))
        self.eval()

    def extract_feat(self, videos: torch.Tensor) -> torch.Tensor:
        return self.backbone(videos)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> class scores (B, num_classes)."""
        return self.cls_head(self.backbone(videos))

    def forward_test(self, videos: torch.Tensor,
                     average_clips: Optional[str] = "prob",
                     num_segs: int = 1) -> torch.Tensor:
        """The softmax of the scores ("prob") or the scores, averaged over
        num_segs clips a video (1: JAX's forward_test)."""
        return average_clip(self(videos), num_segs,
                            "prob" if average_clips == "prob" else "score")


@RECOGNIZERS.register("TPNRecognizer")
class TPNRecognizer(nn.Module):
    """A ResNet3D whose last len(in_channels) stage maps go through the
    TPN neck, then the global mean, dropout and `cls_head.fc_cls` (JAX
    recognizer.py:365-401, mmaction's TPNHead)."""

    def __init__(self, backbone: nn.Module, tpn_cfg: TPNConfig,
                 num_classes: int, dropout_ratio: float = 0.5):
        super().__init__()
        if not hasattr(backbone, "stages"):
            raise ValueError("the TPN neck takes a ResNet3D's stage maps")
        self.backbone = backbone
        dev = _device_of(backbone)
        self.neck = TPN(tpn_cfg, dev)
        self.cls_head = I3DHead(tpn_cfg.fusion_channels, num_classes,
                                dropout_ratio, device=dev)
        self.eval()

    def forward(self, videos: torch.Tensor,
                target: Optional[torch.Tensor] = None):
        """videos: (B, T, H, W, 3) -> class scores; in train mode (scores,
        aux), aux {"loss_aux"} when the neck has its aux head and target
        (int64 labels) is given."""
        n = len(self.neck.cfg.in_channels)
        feat, aux = self.neck(stage_maps(self.backbone, videos)[-n:],
                              target)
        scores = self.cls_head(feat.mean(dim=(2, 3, 4)))
        return (scores, aux) if self.training else scores

    def forward_test(self, videos: torch.Tensor, num_segs: int = 1,
                     average_clips: Optional[str] = "prob") -> torch.Tensor:
        return average_clip(self(videos), num_segs, average_clips)


@RECOGNIZERS.register("Recognizer3DCLIP")
class Recognizer3DCLIP(nn.Module):
    """Recognition over a CLIP vision tower (JAX recognizer.py:230-247):
    the B·T frames through `clip_vision` (fp32 parameters; the tower
    computes in its config's dtype, through the fused sublayers where the
    config sets fused_attn/fused_mlp), the time mean of `high` and the
    linear `fc_cls`, computed as flax's Dense(dtype=None) would.  The JAX
    class has no forward_test, and neither has this one."""

    def __init__(self, clip_cfg: CLIPConfig, num_classes: int, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        self.clip_vision = VisionTower(clip_cfg, device,
                                       param_dtype=torch.float32)
        self.fc_cls = Dense(clip_cfg.embed_dim, num_classes, device=device)
        self.eval()

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        """videos: (B, T, H, W, 3) -> class scores (B, num_classes)."""
        b, t = videos.shape[:2]
        high, _low, _mid = self.clip_vision(
            videos.reshape(b * t, *videos.shape[2:]))
        return self.fc_cls(high.reshape(b, t, -1).mean(1))


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


# -- the training init: flax's init schemes, drawn with numpy ---------------

# Φ(-2): the standard normal's mass below the truncation at -2
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))


def _truncated_normal(rng, shape, std: float) -> torch.Tensor:
    """jax.random.truncated_normal(-2, 2) * std (a standard normal
    truncated to [-2, 2], then scaled, not renormalised), by the inverse
    CDF of numpy uniforms."""
    u = torch.from_numpy(rng.random(tuple(shape), dtype=np.float32))
    x = torch.special.erfinv(2.0 * (_PHI_LO + u * (1.0 - 2.0 * _PHI_LO))
                             - 1.0) * math.sqrt(2.0)
    return x.clamp_(-2.0, 2.0).mul_(std)


def _lecun_normal(rng, shape, fan_in: int) -> torch.Tensor:
    """flax's default kernel init, variance_scaling(1, 'fan_in',
    'truncated_normal')."""
    return _truncated_normal(rng, shape,
                             (1.0 / fan_in) ** 0.5 / .87962566103423978)


def _orthogonal(rng, rows: int, cols: int) -> torch.Tensor:
    """jax.nn.initializers.orthogonal() of a (rows, cols) matrix (the QR
    in float64)."""
    a = rng.standard_normal((cols, rows) if rows < cols else (rows, cols))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    return torch.from_numpy(q.T if rows < cols else q)


def _decoder_init(out: Dict[str, torch.Tensor], rng, pre: str,
                  cfg: RNNDecoderConfig) -> None:
    """The RNN decoder's init (JAX decoder_head.py:82-94)."""
    c, h = cfg.num_classes, cfg.in_channels
    out[pre + "start_emb.weight"] = torch.from_numpy(
        rng.standard_normal((1, c)))
    out[pre + "rnn.weight_ih_l0"] = _lecun_normal(rng, (3 * h, c + h), c + h)
    out[pre + "rnn.weight_hh_l0"] = _orthogonal(rng, h, 3 * h).T
    out[pre + "rnn.bias_ih_l0"] = torch.zeros(3 * h)
    out[pre + "rnn.bias_hh_l0"] = torch.zeros(3 * h)


def init_state_dict(backbone_cfg: TimeSformerConfig, seed: int, *,
                    num_classes: Optional[int] = None,
                    decoder_cfg: Optional[RNNDecoderConfig] = None
                    ) -> Dict[str, torch.Tensor]:
    """The fp32 state dict of a Recognizer3D (num_classes) or
    Recognizer3DRelseq (decoder_cfg) as training starts, drawn from a
    numpy seed with the schemes the JAX modules init with: Dense and conv
    kernels lecun-normal (fan-in: the input width times the receptive
    field) with zero biases (the attention projections included),
    LayerNorm ones and zeros, `temporal_fc` zeros (JAX timesformer.py
    :111-112), `cls_token`, `pos_embed`, `time_embed` and the class head
    truncated-normal 0.02; the RNN decoder's start embedding normal(1),
    its input kernel lecun-normal, its recurrent kernel orthogonal, its
    output kernel truncated-normal 0.02, its biases zero
    (decoder_head.py:82-94).  The same distributions as `model.init`,
    not the same numbers; `random_state_dict` is the parity tests'
    perturbed draw."""
    if (num_classes is None) == (decoder_cfg is None):
        raise ValueError("give num_classes or decoder_cfg")
    model = (Recognizer3D(backbone_cfg, num_classes, device="meta")
             if decoder_cfg is None else
             Recognizer3DRelseq(backbone_cfg, decoder_cfg, device="meta"))
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}
    for owner, mod in model.named_modules():
        pre = f"{owner}." if owner else ""
        if isinstance(mod, LN):
            out[pre + "weight"] = torch.ones(mod.weight.shape)
            out[pre + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, MHA):
            d = mod.width
            out[pre + "in_proj_weight"] = torch.cat(
                [_lecun_normal(rng, (d, d), d) for _ in range(3)])
            out[pre + "in_proj_bias"] = torch.zeros(3 * d)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            if owner in ("cls_head.fc_cls", "cls_head.out"):
                w = _truncated_normal(rng, mod.weight.shape, 0.02)
            elif owner.endswith("temporal_fc"):
                w = torch.zeros(mod.weight.shape)
            else:
                w = _lecun_normal(rng, mod.weight.shape,
                                  int(np.prod(mod.weight.shape[1:])))
            out[pre + "weight"] = w
            out[pre + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, RNNDecoderHead):
            _decoder_init(out, rng, pre, mod.cfg)
    backbone = model.backbone
    for name in ("cls_token", "pos_embed", "time_embed"):
        if hasattr(backbone, name):
            out[f"backbone.{name}"] = _truncated_normal(
                rng, getattr(backbone, name).shape, 0.02)
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise KeyError(f"no init for {sorted(missing)[:5]}")
    return {k: out[k].to(torch.float32).contiguous()
            for k in model.state_dict()}


def _normal(rng, shape, std: float) -> torch.Tensor:
    return torch.from_numpy(
        std * rng.standard_normal(tuple(shape)).astype(np.float32))


def _transformer_init(out: Dict[str, torch.Tensor], rng, pre: str,
                      mod: nn.Module) -> None:
    """The parameters the transformer modules hold themselves (not in a
    Linear, conv or LayerNorm), by the JAX modules' init schemes."""
    from .swin3d import WindowAttention3D
    from .videoclip import VideoCLIP
    from .videomae_vit import _MAEAttention, _MAEBlock
    if isinstance(mod, WindowAttention3D):
        out[pre + "relative_position_bias_table"] = _truncated_normal(
            rng, mod.relative_position_bias_table.shape, 0.02)
    elif isinstance(mod, _MAEAttention):
        out[pre + "qkv.weight"] = _normal(rng, mod.qkv.weight.shape, 0.02)
        out[pre + "q_bias"] = torch.zeros(mod.dim)
        out[pre + "v_bias"] = torch.zeros(mod.dim)
    elif isinstance(mod, _MAEBlock) and mod.gamma_1 is not None:
        for g in ("gamma_1", "gamma_2"):
            out[pre + g] = torch.full(mod.gamma_1.shape, mod.init_values)
    elif isinstance(mod, VideoCLIP):
        for name, std in (("video_cls", 0.02), ("video_pos", 0.01),
                          ("token_embedding", 0.02), ("text_pos", 0.01)):
            out[pre + name] = _normal(rng, getattr(mod, name).shape, std)
        out[pre + "logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    elif isinstance(mod, MHA):
        d = mod.width
        out[pre + "in_proj_weight"] = torch.cat(
            [_lecun_normal(rng, (d, d), d) for _ in range(3)])
        out[pre + "in_proj_bias"] = torch.zeros(3 * d)
    elif isinstance(mod, PatchEmbed):
        out[pre + "weight"] = _lecun_normal(
            rng, mod.weight.shape, int(np.prod(mod.weight.shape[1:])))
    elif isinstance(mod, VisionTower):
        std = mod.cfg.vision_width ** -0.5
        for name in ("class_embedding", "positional_embedding", "proj"):
            out[pre + name] = _normal(rng, getattr(mod, name).shape, std)


def conv_init_state_dict(model: nn.Module, seed: int
                         ) -> Dict[str, torch.Tensor]:
    """The fp32 state dict of a CNN recognizer (BackboneClassifier,
    X3DClassifier, RecognizerRelseq, Recognizer2D, TPNRecognizer) or
    backbone as training starts, drawn from a numpy seed with the JAX
    modules' init schemes: conv kernels (1-, 2- and 3-D) lecun-normal
    with fan-in (input channels / groups) x kernel volume, Dense kernels
    (the SE's, X3DHead's fc1, the TAM's, TIN's and TRN's relation layers)
    lecun-normal, biases zero; BatchNorm scales 1, biases 0, running
    means 0 and variances 1; the class layer (`fc_cls`, X3DHead's `fc2`)
    normal(0.01), TRNHead's per-frame `fc_cls` normal(0.001); the RNN
    decoder as `init_state_dict` draws it (its output layer
    truncated-normal 0.02).  The same for the transformer backbones
    (Swin3D, MViT, VideoMAEViT, VideoCLIP) and Recognizer3DCLIP: Dense
    and conv kernels lecun-normal (each of CLIP's q, k and v on its own),
    LayerNorms 1 and 0, Swin's relative-position tables truncated-normal
    0.02, VideoMAE's qkv weight normal(0.02), its q and v biases 0 and
    gammas `init_values`, VideoCLIP's CLS and token tables normal(0.02),
    its position tables normal(0.01), CLIP's class and position
    embeddings and projection normal(width^-0.5), Recognizer3DCLIP's
    `fc_cls` normal(0.01).  The same for the localizers (BMN, TEM, PEM,
    SSNHead): every conv and Dense kernel lecun-normal (BMN's `pem_3d`
    with fan-in C x N), biases zero.  The same for the AVA detector
    (train/detection_trainer.AVAFastRCNN): its backbone's, ACRN's convs
    and BatchNorms and the FBO's Dense kernels (lecun-normal) and
    LayerNorms (1 and 0), the RoI head's `fc_cls` normal(0.01).  The same
    for the skeleton models (models/stgcn.py): convs lecun-normal, the
    graph from the config, edge masks 1, PA 1e-6, AGCN's `gcn.bn` scale
    1e-6, the head's `fc` normal(0.01).  The same distributions as
    `model.init`, not the same numbers."""
    from .stgcn import SkeletonHead
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}
    head = getattr(model, "cls_head", None)
    for owner, mod in model.named_modules():
        pre = f"{owner}." if owner else ""
        if isinstance(mod, (LayerNorm, LayerNormF32)):
            out[pre + "weight"] = torch.ones(mod.weight.shape)
            out[pre + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
            shape = tuple(mod.weight.shape)
            std = (0.001 if isinstance(head, TRNHead) else 0.01) \
                if owner.endswith("cls_head.fc_cls") else \
                0.01 if owner.endswith("cls_head.fc2") \
                and isinstance(head, X3DHead) else \
                0.01 if owner == "fc_cls" \
                and isinstance(model, Recognizer3DCLIP) else \
                0.01 if owner == "roi_head.fc_cls" else \
                0.01 if owner.endswith("cls_head.fc") \
                and isinstance(head, SkeletonHead) else None
            if std is not None:
                w = torch.from_numpy(
                    std * rng.standard_normal(shape).astype(np.float32))
            elif isinstance(model, RecognizerRelseq) \
                    and owner == "cls_head.out":
                w = _truncated_normal(rng, shape, 0.02)
            else:
                w = _lecun_normal(rng, shape, int(np.prod(shape[1:])))
            out[pre + "weight"] = w
            if mod.bias is not None:
                out[pre + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, FlaxBatchNorm):
            c = mod.num_features
            out[pre + "weight"] = torch.full((c,), getattr(mod, "init_scale",
                                                           1.0))
            out[pre + "bias"] = torch.zeros(c)
            out[pre + "running_mean"] = torch.zeros(c)
            out[pre + "running_var"] = torch.ones(c)
            out[pre + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
        elif isinstance(mod, RNNDecoderHead):
            _decoder_init(out, rng, pre, mod.cfg)
        elif hasattr(mod, "init_extras"):      # the skeleton backbones
            out.update({pre + k: v for k, v in mod.init_extras().items()})
        else:
            _transformer_init(out, rng, pre, mod)
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise KeyError(f"no init for {sorted(missing)[:5]}")
    return {k: (out[k] if out[k].dtype == torch.int64
                else out[k].to(torch.float32)).contiguous()
            for k in model.state_dict()}

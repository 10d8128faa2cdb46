"""Support-set distilled dual encoder for text->video retrieval.

Counterpart of cross_modal_video_engine_tpu/models/dual_encoding.py, with
the same config (field names and defaults, so one config.json configures
both packages), the same towers and the same entry points:

* `VideoMultilevelEncoding`: mean of the raw frame features (level 1), the
  biGRU mean-pooled (level 2), the conv bank over the masked GRU outputs
  (level 3), concatenated.
* `TextMultilevelEncoding`: the same three levels over word embeddings and
  the BoW, and with `with_support=True` the support-set attention (k/q
  projections, softmax-gated sum of the support captions' features).
* `DualEncoding`: the teacher towers and the student towers of the style,
  `forward` (the reference forward_emb) and `embed_vis`,
  `embed_vis_distill`, `embed_txt_distill`, `embed_txt_GT`.

Submodules carry the reference torch model's names and keys
(LINAS-engine/model.py), so `reference_state_dicts` in convert/from_jax.py
can hand out the sub state dicts in the reference checkpoint's order.  The
model is built in eval mode, as the JAX towers default to, with its weights
at zero and the BN running variance at one: load a state dict
(`restore_dual_encoding` reads a checkpoint, `seeded_state_dict` draws one
from a numpy seed).  Everything computes in f32, as the JAX model does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from .layers import BiGRU, ConvBank1D, Dropout, LatentMapping


class VideoBatch(NamedTuple):
    frames: torch.Tensor       # (B, T, D) float32
    mean_origin: torch.Tensor  # (B, D) mean-pooled raw feature
    lengths: torch.Tensor      # (B,) int32
    mask: torch.Tensor         # (B, T) float32


class TextBatch(NamedTuple):
    ids: torch.Tensor          # (B, L) int64   (or (B, S, L) for support sets)
    bows: torch.Tensor         # (B, V) float32 (or (B, S, V))
    lengths: torch.Tensor      # (B,)           (or (B, S))
    mask: torch.Tensor         # (B, L)         (or (B, S, L))


@dataclasses.dataclass(frozen=True)
class DualEncodingConfig:
    # sizes (defaults = reference trainer.py:27-106 defaults)
    visual_feat_dim: int = 2048
    visual_rnn_size: int = 512
    visual_kernel_num: int = 512
    visual_kernel_sizes: Tuple[int, ...] = (2, 3, 4, 5)
    vocab_size: int = 7807
    bow_vocab_size: int = 7183
    word_dim: int = 500
    text_rnn_size: int = 512
    text_kernel_num: int = 512
    text_kernel_sizes: Tuple[int, ...] = (2, 3, 4)
    hidden_size: int = 1024          # support-set attention k/q dim
    common_dim: int = 1536           # latent space
    text_resblock_number: int = 0
    dropout: float = 0.2
    concate: str = "full"            # 'full' (levels 1+2+3) | 'reduced' (2+3)
    gru_pool: str = "mean"           # 'mean' | 'max'
    # architecture style
    style: str = "distill_from_best_model"   # | 'GT'
    teacher_model: str = "GT"                # | 'student'
    student_model: str = "de+map"            # 'map' | 'de+map' | 'text+video'

    @property
    def video_feature_dim(self) -> int:
        gru = 2 * self.visual_rnn_size
        conv = self.visual_kernel_num * len(self.visual_kernel_sizes)
        return gru + conv + (self.visual_feat_dim if self.concate == "full" else 0)

    @property
    def text_feature_dim(self) -> int:
        gru = 2 * self.text_rnn_size
        conv = self.text_kernel_num * len(self.text_kernel_sizes)
        return gru + conv + (self.bow_vocab_size if self.concate == "full" else 0)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Mean over valid timesteps: sum(x * mask) / max(length, 1)."""
    s = torch.sum(x * mask[..., None], dim=1)
    return s / torch.clamp_min(lengths[..., None].to(x.dtype), 1.0)


def _pool(cfg: DualEncodingConfig, seq: torch.Tensor, mask: torch.Tensor,
          lengths: torch.Tensor) -> torch.Tensor:
    if cfg.gru_pool == "mean":
        return _masked_mean(seq, mask, lengths)
    return torch.amax(seq * mask[..., None], dim=1)


class VideoMultilevelEncoding(nn.Module):
    def __init__(self, cfg: DualEncodingConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.rnn = BiGRU(cfg.visual_feat_dim, cfg.visual_rnn_size,
                         packed=False, device=device)
        self.convs1 = ConvBank1D(2 * cfg.visual_rnn_size,
                                 cfg.visual_kernel_num,
                                 cfg.visual_kernel_sizes, device=device)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, videos: VideoBatch) -> torch.Tensor:
        cfg = self.cfg
        # level 2: biGRU over the (unpacked) padded batch, like the reference
        gru_seq = self.rnn(videos.frames)
        gru_out = self.dropout(_pool(cfg, gru_seq, videos.mask,
                                     videos.lengths))
        # level 3: conv bank over the masked GRU outputs
        con_out = self.dropout(self.convs1(gru_seq * videos.mask[..., None]))
        parts = [gru_out, con_out]
        if cfg.concate == "full":
            parts.append(videos.mean_origin)                 # level 1
        return torch.cat(parts, dim=1)


class TextMultilevelEncoding(nn.Module):
    """Text tower; with `with_support=True` adds the support-set attention
    (teacher).  `with_support=False` is the student encoder."""

    def __init__(self, cfg: DualEncodingConfig, with_support: bool = False,
                 style: str = "distill_from_best_model", device=None):
        super().__init__()
        self.cfg = cfg
        self.with_support = with_support
        self.style = style
        self.embed = nn.Embedding(cfg.vocab_size, cfg.word_dim, device=device)
        self.rnn = BiGRU(cfg.word_dim, cfg.text_rnn_size, packed=True,
                         device=device)
        self.convs1 = ConvBank1D(2 * cfg.text_rnn_size, cfg.text_kernel_num,
                                 cfg.text_kernel_sizes, device=device)
        self.dropout = Dropout(cfg.dropout)
        if with_support:
            feat = cfg.text_feature_dim
            self.k = nn.Linear(feat, cfg.hidden_size, device=device)
            self.q = nn.Linear(feat, cfg.hidden_size, device=device)

    def encode_text(self, text: TextBatch) -> torch.Tensor:
        cfg = self.cfg
        wemb = self.embed(text.ids)                             # (B, L, Dw)
        gru_seq = self.rnn(wemb, text.lengths)                  # zeroed pads
        gru_out = self.dropout(_pool(cfg, gru_seq, text.mask, text.lengths))
        con_out = self.dropout(self.convs1(gru_seq))            # level 3
        parts = [gru_out, con_out]
        if cfg.concate == "full":
            parts.append(text.bows)                             # level 1
        return torch.cat(parts, dim=1)

    def forward(self, text: TextBatch, support: Optional[TextBatch] = None):
        feature = self.encode_text(text)
        if support is None or not self.with_support:
            return feature
        B, S = support.ids.shape[0], support.ids.shape[1]
        flat = TextBatch(ids=support.ids.reshape(B * S, -1),
                         bows=support.bows.reshape(B * S, -1),
                         lengths=support.lengths.reshape(B * S),
                         mask=support.mask.reshape(B * S, -1))
        s_feature = self.encode_text(flat).reshape(B, S, -1)
        key = self.k(s_feature)                                 # (B, S, Hk)
        query = self.q(feature)                                 # (B, Hk)
        w = torch.softmax(torch.einsum("bsh,bh->bs", key, query),
                          dim=1)[..., None]
        gated_feature = torch.sum(w * s_feature, dim=1)
        if self.style == "distill_from_best_model":
            return feature, gated_feature
        return feature + gated_feature                          # 'GT'


class DualEncoding(nn.Module):
    """Teacher + student dual encoder (ref Dual_Encoding, model.py:512-705).
    `device=None` builds it on the CUDA device."""

    def __init__(self, cfg: DualEncodingConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        meta = torch.device("meta")
        map_dims = (cfg.common_dim,)
        vdim, tdim = cfg.video_feature_dim, cfg.text_feature_dim
        self.vid_encoding = VideoMultilevelEncoding(cfg, meta)
        self.vid_mapping = LatentMapping(vdim, map_dims, cfg.dropout,
                                         device=meta)
        self.text_encoding = TextMultilevelEncoding(
            cfg, with_support=cfg.teacher_model != "student",
            style=cfg.style, device=meta)
        self.text_mapping = LatentMapping(tdim, map_dims, cfg.dropout,
                                          device=meta)
        if cfg.style == "distill_from_best_model":
            if cfg.student_model in ("de+map", "text+video"):
                self.student_text_encoding = TextMultilevelEncoding(
                    cfg, with_support=False, device=meta)
            student_dims = map_dims + (cfg.common_dim,) * \
                cfg.text_resblock_number
            self.student_text_mapping = LatentMapping(
                tdim, student_dims if cfg.student_model == "text+video"
                else map_dims, cfg.dropout, device=meta)
            if cfg.student_model == "text+video":
                self.student_vid_encoding = VideoMultilevelEncoding(cfg, meta)
                self.student_vid_mapping = LatentMapping(
                    vdim, map_dims, cfg.dropout, device=meta)
        # built on the meta device, so construction draws no random
        # numbers; then zero weights and unit running variances
        self.to_empty(device=device)
        with torch.no_grad():
            for name, t in self.state_dict().items():
                t.fill_(1.0 if name.endswith("running_var") else 0.0)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.vid_mapping.mapping.fc1.weight.device

    def forward(self, videos: VideoBatch, text: TextBatch,
                support: Optional[TextBatch] = None, *,
                detach_teacher_feature: bool = False
                ) -> Dict[str, torch.Tensor]:
        """forward_emb (model.py:609-705). Returns a dict of embeddings."""
        cfg = self.cfg
        out = {"vid_emb": self.vid_mapping(self.vid_encoding(videos))}
        if cfg.style == "distill_from_best_model":
            if cfg.teacher_model == "GT":
                enc = self.text_encoding(text, support)
                # with no support set the teacher degrades to feature-only
                cap_enc, gated = enc if isinstance(enc, tuple) else (enc, 0.0)
                out["cap_emb"] = self.text_mapping(cap_enc + gated)
                if cfg.student_model == "map":
                    feat = cap_enc.detach() if detach_teacher_feature \
                        else cap_enc
                    out["student_cap_emb"] = self.student_text_mapping(feat)
                else:
                    out["student_cap_emb"] = self.student_text_mapping(
                        self.student_text_encoding(text))
            else:  # teacher_model == 'student'
                out["cap_emb"] = self.text_mapping(self.text_encoding(text))
                out["student_cap_emb"] = self.student_text_mapping(
                    self.student_text_encoding(text))
            if cfg.student_model == "text+video":
                out["student_vid_emb"] = self.student_vid_mapping(
                    self.student_vid_encoding(videos))
        else:  # 'GT'
            out["cap_emb"] = self.text_mapping(
                self.text_encoding(text, support))
        return out

    # -- inference entry points (model.py:707-832) -------------------------
    def embed_vis(self, videos: VideoBatch) -> torch.Tensor:
        return self.vid_mapping(self.vid_encoding(videos))

    def embed_vis_distill(self, videos: VideoBatch) -> torch.Tensor:
        if self.cfg.style == "distill_from_best_model" and \
                self.cfg.student_model == "text+video":
            return self.student_vid_mapping(self.student_vid_encoding(videos))
        return self.embed_vis(videos)

    def embed_txt_distill(self, text: TextBatch) -> torch.Tensor:
        if self.cfg.student_model == "map":
            return self.student_text_mapping(self.text_encoding(text, None))
        return self.student_text_mapping(self.student_text_encoding(text))

    def embed_txt_GT(self, text: TextBatch,
                     support: TextBatch) -> torch.Tensor:
        enc = self.text_encoding(text, support)
        if isinstance(enc, tuple):
            enc = enc[0] + enc[1]
        return self.text_mapping(enc)


def seeded_state_dict(cfg: DualEncodingConfig, seed: int = 0
                      ) -> Dict[str, torch.Tensor]:
    """A state dict of random f32 weights from np.random.default_rng(seed),
    in state-dict order: matrices at 1/sqrt(fan-in) scale, biases and
    embeddings small, BN scales near 1, running means N(0, 0.1) and
    running variances in [0.5, 1.5), so that loading it exercises every
    tensor.  No checkpoint is read."""
    rng = np.random.default_rng(seed)
    shapes = DualEncoding(cfg, device="meta").state_dict()
    out = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64)
            continue
        if name.endswith("running_var"):
            a = 0.5 + rng.random(shape)
        elif name.endswith("running_mean"):
            a = 0.1 * rng.standard_normal(shape)
        elif ".bn_1.weight" in name:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias") or ".bias_" in name:
            a = 0.02 * rng.standard_normal(shape)
        elif name.endswith("embed.weight"):
            a = 0.1 * rng.standard_normal(shape)
        else:              # (out, in, ...): fan-in is every axis but the first
            a = int(np.prod(shape[1:])) ** -0.5 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def make_video_batch(frame_features: Sequence[np.ndarray],
                     max_frames: int = 64, device=None) -> VideoBatch:
    """Pad a list of (T_i, D) frame-feature arrays into a VideoBatch on
    `device` (None: the CUDA device), mirroring collate_frame_gru_fn
    (tag_data_provider.py:24-88): frames are subsampled to at most
    `max_frames` uniformly, mean_origin is the mean of ALL original
    frames."""
    B = len(frame_features)
    D = frame_features[0].shape[1]
    frames = np.zeros((B, max_frames, D), np.float32)
    mask = np.zeros((B, max_frames), np.float32)
    lengths = np.zeros((B,), np.int32)
    origin = np.zeros((B, D), np.float32)
    for i, f in enumerate(frame_features):
        origin[i] = f.mean(axis=0)
        if len(f) > max_frames:
            idx = np.round(np.linspace(0, len(f) - 1, max_frames)).astype(int)
            f = f[idx]
        n = len(f)
        frames[i, :n] = f
        mask[i, :n] = 1.0
        lengths[i] = n
    dev = resolve_device(device)
    return VideoBatch(*(torch.from_numpy(a).to(dev)
                        for a in (frames, origin, lengths, mask)))


def make_text_batch(ids_list: Sequence[Sequence[int]], bows: np.ndarray,
                    max_words: int = 0, device=None) -> TextBatch:
    """Pad tokenized captions into a TextBatch on `device` (None: the CUDA
    device)."""
    B = len(ids_list)
    L = max_words or max(len(x) for x in ids_list)
    ids = np.zeros((B, L), np.int64)
    mask = np.zeros((B, L), np.float32)
    lengths = np.zeros((B,), np.int32)
    for i, x in enumerate(ids_list):
        x = list(x)[:L]
        ids[i, :len(x)] = x
        mask[i, :len(x)] = 1.0
        lengths[i] = len(x)
    dev = resolve_device(device)
    return TextBatch(*(torch.from_numpy(a).to(dev) for a in (
        ids, np.asarray(bows, np.float32), lengths, mask)))

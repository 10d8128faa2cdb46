"""CLIP dual tower (vision transformer + text transformer) in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/clip.py, with the same
classes, methods and numerics:

* `VisionTower` returns (high, low, middle): `low` the patch tokens before
  the transformer, `middle` the post-transformer tokens without CLS,
  `high` the projected CLS feature (fp32).
* `TextTower` is the causal text transformer with EOT pooling and the
  optional image-token splice of compositional queries.
* Every matrix, bias and embedding is stored in the compute dtype
  (`cfg.dtype`), which is where the JAX package rounds them before use;
  LayerNorm parameters and `logit_scale` stay fp32, as flax applies them.

Parameter names follow the OpenAI CLIP state dict that
`cross_modal_video_engine_tpu.convert.torch_import.convert_clip_vit` reads,
so one state dict loads into both packages.  That layout keeps the text
tower's parameters at the top level, so `CLIPModel` extends `TextTower`
and adds `visual` and `logit_scale`.

With `cfg.fused_attn` / `cfg.fused_mlp` each block's halves run through
ops/attention_sublayer.py: the vision tower on flat (B·L, D) rows through
the compact entry, the text tower on (B, L, D) through the rank-3 entry
with valid_len=L and causal=True.  On a CUDA device those are the
hand-written kernels; on the CPU, their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_sublayer import (fused_attention_sublayer,
                                      fused_attention_sublayer_compact,
                                      fused_mlp_sublayer)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """The JAX package's CLIPConfig, field for field, so its config dicts
    load here."""

    embed_dim: int = 512
    # vision
    image_resolution: int = 224
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    patch_size: int = 32
    # text
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    dtype: str = "float32"    # 'bfloat16' for production
    # a TPU tile layout the port does not carry: True raises
    flatten_tokens: bool = False
    # run each block's attention half through the fused sublayer
    fused_attn: bool = False
    # run each block's MLP half through the fused sublayer
    fused_mlp: bool = False

    @property
    def grid(self) -> int:
        return self.image_resolution // self.patch_size

    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def enable_fused_inference(cfg: CLIPConfig, enable: Optional[bool] = None,
                           device="cpu") -> CLIPConfig:
    """Turn on the fused sublayers for inference.

    Exact math and identical parameters, so configs saved without the
    flags still load.  enable=None selects: on when the model's `device`
    is CUDA (the hand-written kernels), off elsewhere (on the CPU the
    fused path runs the plain versions, which buy nothing there)."""
    if enable is None:
        enable = torch.device(device).type == "cuda"
    if not enable:
        return cfg
    return dataclasses.replace(cfg, fused_attn=True, fused_mlp=True,
                               flatten_tokens=False)


def _refuse_flatten(cfg: CLIPConfig) -> None:
    if cfg.flatten_tokens:
        raise ValueError("flatten_tokens is a TPU tile layout the port does "
                         "not carry; use fused_attn/fused_mlp")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class LayerNormF32(nn.Module):
    """LayerNorm with fp32 statistics and fp32 scale/bias, output in the
    activation dtype (flax LayerNorm with force_float32_reductions)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                            self.bias.float(), 1e-5).to(x.dtype)


class MHA(nn.Module):
    """Self-attention in nn.MultiheadAttention's parameter layout
    (in_proj_weight (3D, D), in_proj_bias, out_proj), unfused: scores and
    softmax in fp32, probabilities rounded to the compute dtype."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * width, width, dtype=dtype, device=device))
        self.in_proj_bias = nn.Parameter(
            torch.zeros(3 * width, dtype=dtype, device=device))
        self.out_proj = nn.Linear(width, width, dtype=dtype, device=device)

    def qkv_params(self) -> Tuple[torch.Tensor, ...]:
        """(wq, bq, wk, bk, wv, bv): contiguous views of in_proj."""
        d = self.width
        w, b = self.in_proj_weight, self.in_proj_bias
        return (w[:d], b[:d], w[d:2 * d], b[d:2 * d], w[2 * d:], b[2 * d:])

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, L, D); mask: (L, L) additive fp32 mask."""
        b, l, d = x.shape
        h, hd, dt = self.heads, d // self.heads, self.dtype
        wq, bq, wk, bk, wv, bv = (p.to(dt) for p in self.qkv_params())

        def heads_first(t):
            return t.reshape(b, l, h, hd).transpose(1, 2)

        q = heads_first(F.linear(x, wq, bq))
        k = heads_first(F.linear(x, wk, bk))
        v = heads_first(F.linear(x, wv, bv))
        logits = (q.float() @ k.float().transpose(-1, -2)) * float(hd ** -0.5)
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1).to(dt)
        out = (w.float() @ v.float()).to(dt)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, d))


class MLP(nn.Module):
    def __init__(self, width: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width, dtype=dtype, device=device)
        self.c_proj = nn.Linear(4 * width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.heads = heads
        self.attn = MHA(width, heads, dtype, device)
        self.ln_1 = LayerNormF32(width, device)
        self.mlp = MLP(width, dtype, device)
        self.ln_2 = LayerNormF32(width, device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                *, fused_attn: bool = False, fused_mlp: bool = False,
                valid_len: Optional[int] = None,
                causal: bool = False) -> torch.Tensor:
        """x: (B, L, D), or flat (B·L, D) on the compact fused path, where
        valid_len is the sequence length."""
        if fused_attn:
            wargs = (self.ln_1.weight, self.ln_1.bias, *self.attn.qkv_params(),
                     self.attn.out_proj.weight, self.attn.out_proj.bias)
            if x.dim() == 2:
                x = fused_attention_sublayer_compact(
                    x, *wargs, heads=self.heads, seq_len=valid_len,
                    causal=causal)
            else:
                x = fused_attention_sublayer(
                    x, *wargs, heads=self.heads, valid_len=valid_len,
                    causal=causal)
        else:
            x = x + self.attn(self.ln_1(x), mask)
        if fused_mlp:
            return fused_mlp_sublayer(
                x, self.ln_2.weight, self.ln_2.bias,
                self.mlp.c_fc.weight, self.mlp.c_fc.bias,
                self.mlp.c_proj.weight, self.mlp.c_proj.bias)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype, device)
            for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                *, fused_attn: bool = False, fused_mlp: bool = False,
                causal: bool = False, compact: bool = False) -> torch.Tensor:
        """x: (B, L, D).  fused_attn runs the fused attention sublayer:
        on flat (B·L, D) rows through the compact entry when `compact`,
        else on (B, L, D) through the rank-3 entry with valid_len=L;
        `causal` then replaces the additive `mask`, which must be the
        triangular one.  fused_mlp composes with either layout."""
        if not fused_attn:
            for blk in self.resblocks:
                x = blk(x, mask, fused_mlp=fused_mlp)
            return x
        if mask is not None and not causal:
            raise ValueError("fused_attn supports only the causal mask")
        b, l, d = x.shape
        if compact:
            x = x.reshape(b * l, d)
        for blk in self.resblocks:
            x = blk(x, fused_attn=True, fused_mlp=fused_mlp, valid_len=l,
                    causal=causal)
        return x.reshape(b, l, d)


class PatchEmbed(nn.Module):
    """The patch-embedding conv (OpenAI `conv1`: weight (W, 3, p, p), no
    bias), also applicable to pre-patchified (p, p, C)-ordered tokens."""

    def __init__(self, width: int, patch: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.width, self.patch, self.dtype = width, patch, dtype
        self.weight = nn.Parameter(
            torch.empty(width, 3, patch, patch, dtype=dtype, device=device))

    def forward(self, images: Optional[torch.Tensor] = None,
                tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        if tokens is not None:                          # (B, L, p*p*3)
            return tokens.to(self.dtype) @ w.permute(2, 3, 1, 0).reshape(
                -1, self.width)
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        out = F.conv2d(x, w, stride=self.patch)         # (B, W, G, G)
        return out.flatten(2).transpose(1, 2)


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        _refuse_flatten(cfg)
        self.cfg = cfg
        dt, w = cfg.torch_dtype(), cfg.vision_width
        self.conv1 = PatchEmbed(w, cfg.patch_size, dt, device)
        self.class_embedding = nn.Parameter(
            torch.empty(w, dtype=dt, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.grid ** 2 + 1, w, dtype=dt, device=device))
        self.ln_pre = LayerNormF32(w, device)
        self.transformer = Transformer(w, cfg.vision_layers,
                                       cfg.vision_heads, dt, device)
        self.ln_post = LayerNormF32(w, device)
        self.proj = nn.Parameter(
            torch.empty(w, cfg.embed_dim, dtype=dt, device=device))

    def forward(self, images: Optional[torch.Tensor] = None, *,
                tokens: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3), or pre-patchified tokens (B, G², p*p*3)
        -> (high (B, E) fp32, low (B, G², W), middle (B, G², W))."""
        cfg = self.cfg
        dt, w = cfg.torch_dtype(), cfg.vision_width
        x = self.conv1(images, tokens)                  # (B, G², W)
        low = x
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, w)
        x = torch.cat([cls, x], 1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x)
        x = self.transformer(x, fused_attn=cfg.fused_attn,
                             fused_mlp=cfg.fused_mlp, compact=True)
        middle = x[:, 1:, :]
        pooled = self.ln_post(x[:, 0, :])
        # fp32 product of the rounded operands (preferred_element_type)
        high = pooled.float() @ self.proj.to(dt).float()
        return high, low, middle


class TextTower(nn.Module):
    """The causal text transformer with EOT pooling; its parameters use
    the top-level names of the OpenAI CLIP state dict."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        _refuse_flatten(cfg)
        self.cfg = cfg
        dt, w = cfg.torch_dtype(), cfg.text_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, w, dtype=dt,
                                            device=device)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, w, dtype=dt, device=device))
        self.transformer = Transformer(w, cfg.text_layers, cfg.text_heads,
                                       dt, device)
        self.ln_final = LayerNormF32(w, device)
        self.text_projection = nn.Parameter(
            torch.empty(w, cfg.embed_dim, dtype=dt, device=device))

    def forward(self, text_ids: torch.Tensor,
                img_tokens: Optional[torch.Tensor] = None,
                split_ind: int = 4) -> torch.Tensor:
        """text_ids: (B, L) int; the EOT token is the highest id of a row.
        img_tokens: optional (B, text_width) image features spliced in at
        the FIRST occurrence of `split_ind` only.  -> (B, E) fp32."""
        cfg = self.cfg
        dt = cfg.torch_dtype()
        b, l = text_ids.shape
        x = self.token_embedding.weight.to(dt)[text_ids]
        if img_tokens is not None:
            is_split = text_ids == split_ind
            first = is_split.int().argmax(-1)
            onehot = ((torch.arange(l, device=x.device)[None, :]
                       == first[:, None]) & is_split.any(-1)[:, None])
            x = torch.where(onehot[..., None],
                            img_tokens[:, None, :].to(dt), x)
        x = x + self.positional_embedding[:l].to(dt)
        mask = None
        if not cfg.fused_attn:
            mask = torch.full((l, l), float("-inf"),
                              device=x.device).triu(1)
        x = self.transformer(x, mask, fused_attn=cfg.fused_attn,
                             fused_mlp=cfg.fused_mlp, causal=True)
        x = self.ln_final(x)
        pooled = x[torch.arange(b, device=x.device), text_ids.argmax(-1)]
        return pooled.float() @ self.text_projection.to(dt).float()


class CLIPModel(TextTower):
    """Both towers and the logit scale, in the OpenAI state-dict layout."""

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__(cfg, device)
        self.visual = VisionTower(cfg, device)
        self.logit_scale = nn.Parameter(
            torch.tensor(np.log(1 / 0.07), dtype=torch.float32,
                         device=device))
        self.init_weights()

    @torch.no_grad()
    def init_weights(self):
        """The JAX package's initializer scales, from torch's global RNG:
        lecun-normal matrices, zero biases, unit LayerNorms, normal
        embeddings.  Real weights come from a state dict."""
        cfg = self.cfg

        def normal(p, std):
            p.normal_(0.0, std)

        for name, p in self.named_parameters():
            if name.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight",
                              "ln_post.weight", "ln_final.weight")):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif p.dim() >= 2 and "transformer" in name:   # Linear (out, in)
                normal(p, p.shape[1] ** -0.5)
        normal(self.visual.conv1.weight, (3 * cfg.patch_size ** 2) ** -0.5)
        for p in (self.visual.class_embedding,
                  self.visual.positional_embedding, self.visual.proj):
            normal(p, cfg.vision_width ** -0.5)
        normal(self.token_embedding.weight, 0.02)
        normal(self.positional_embedding, 0.01)
        normal(self.text_projection, cfg.text_width ** -0.5)
        self.logit_scale.fill_(float(np.log(1 / 0.07)))

    def encode_image(self, images: torch.Tensor):
        """(B, H, W, 3) -> (high (B, E), middle (B, G², W))."""
        high, _low, middle = self.visual(images)
        return high, middle

    def encode_video(self, frames: torch.Tensor):
        """(B, F, H, W, 3) -> (high (B, F, E), middle (B, F, G², W)),
        frames folded into the batch."""
        b, f = frames.shape[:2]
        high, _low, middle = self.visual(frames.reshape(b * f,
                                                        *frames.shape[2:]))
        return high.reshape(b, f, -1), middle.reshape(b, f, *middle.shape[1:])

    def encode_video_u8(self, frames_u8: torch.Tensor):
        """uint8 (B, F, H, W, 3) -> the outputs of encode_video on the
        normalized frames, through u8_to_patches into the patch-embedding
        GEMM (no float frame tensor)."""
        from ..ops.pallas_preprocess import u8_to_patches

        b, f = frames_u8.shape[:2]
        toks = u8_to_patches(frames_u8.reshape(b * f, *frames_u8.shape[2:]),
                             self.cfg.patch_size,
                             out_dtype=self.cfg.torch_dtype())
        high, _low, middle = self.visual(tokens=toks)
        return high.reshape(b, f, -1), middle.reshape(b, f, *middle.shape[1:])

    def encode_text(self, text_ids: torch.Tensor) -> torch.Tensor:
        return TextTower.forward(self, text_ids)

    def encode_text_img_retrieval(self, text_ids: torch.Tensor,
                                  img_tokens: torch.Tensor,
                                  split_ind: int = 4) -> torch.Tensor:
        """Compositional query: the image feature replaces the placeholder
        token."""
        if text_ids.shape[0] == 1 and img_tokens.shape[0] > 1:
            text_ids = text_ids.expand(img_tokens.shape[0], -1)
        return TextTower.forward(self, text_ids, img_tokens, split_ind)

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor):
        """Contrastive logits (logits_per_image, logits_per_text)."""
        from ..ops.similarity import l2norm

        image_features = l2norm(self.encode_image(images)[0])
        text_features = l2norm(self.encode_text(text_ids))
        logits = self.logit_scale.exp() * image_features @ text_features.t()
        return logits, logits.t()


def random_state_dict(cfg: CLIPConfig, seed: int) -> Dict[str, torch.Tensor]:
    """A CLIP state dict of random fp32 weights made from a numpy seed:
    LayerNorms near unit, biases small, matrices at lecun-normal scale.
    Both packages can load it (this one directly, the JAX one through
    convert_clip_vit), so tests and smoke runs need no downloaded
    weights."""
    rng = np.random.default_rng(seed)
    shapes = CLIPModel(cfg, device="meta").state_dict()
    out = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        if name == "logit_scale":
            a = np.full(shape, np.log(1 / 0.07))
        elif ".ln_" in name or name.startswith("ln_"):
            a = (1.0 if name.endswith("weight") else 0.0) \
                + 0.1 * rng.standard_normal(shape)
        elif name.endswith("bias"):
            a = 0.02 * rng.standard_normal(shape)
        elif name == "token_embedding.weight":
            a = 0.02 * rng.standard_normal(shape)
        elif name in ("visual.proj", "text_projection"):   # x @ proj
            a = shape[0] ** -0.5 * rng.standard_normal(shape)
        elif name in ("visual.class_embedding",
                      "visual.positional_embedding", "positional_embedding"):
            a = shape[-1] ** -0.5 * rng.standard_normal(shape)
        else:                                  # Linear (out, in) and conv1
            a = int(np.prod(shape[1:])) ** -0.5 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out

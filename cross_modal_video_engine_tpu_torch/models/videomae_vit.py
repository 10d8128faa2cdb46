"""VideoMAE ViT backbone (the finetuned checkpoint's contract) in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/videomae_vit.py, in
the key grammar that the JAX package's `convert_videomae` reads:
`patch_embed.proj`, `blocks.{i}.{norm1, attn.qkv.weight, attn.q_bias,
attn.v_bias, attn.proj, norm2, mlp.fc1, mlp.fc2, gamma_1, gamma_2}` and
`fc_norm`.

As the JAX module computes it:
* a tubelet patch embed (flax's 'SAME' padding), no CLS token, the fixed
  sinusoid position table (recomputed, not a parameter);
* attention with a bias-less fused qkv weight and separate q and v
  biases, the k bias pinned to zero; `q * scale` before the product, the
  logits in fp32, the softmax cast to the compute dtype, the value
  product in it;
* optional layer-scale `gamma_1`/`gamma_2` (init_values > 0);
* LayerNorms at eps 1e-6 in fp32, the tokens' mean in fp32 and `fc_norm`.
Parameters stay fp32.  The layers name the config's dtype, as the JAX
module's do: with dtype='float32' (the shipped config) every layer runs in
fp32, on bf16-rounded parameters under the bf16 trainer too; with
'bfloat16' the blocks run in bf16, the norms in fp32, and the output is
fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import BACKBONES
from .flax_nn import Conv3d, Dense, LayerNorm, acc_dtype


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """The transformer sinusoid table, (1, n_position, d_hid) fp32."""
    pos = np.arange(n_position)[:, None]
    i = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (i // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table[None]


@dataclasses.dataclass(frozen=True)
class VideoMAEConfig:
    num_frames: int = 16
    img_size: int = 224
    patch_size: int = 16
    tubelet_size: int = 2
    embed_dims: int = 768
    num_heads: int = 12
    num_layers: int = 12
    mlp_ratio: float = 4.0
    init_values: float = 0.0          # > 0: layer-scale gammas
    dtype: str = "float32"

    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float64": torch.float64}.get(self.dtype, torch.float32)

    @property
    def num_patches(self) -> int:
        return ((self.img_size // self.patch_size) ** 2
                * (self.num_frames // self.tubelet_size))


class _MAEAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dim, self.heads, self.dtype = dim, heads, dtype
        self.qkv = nn.Module()
        self.qkv.weight = nn.Parameter(torch.zeros(3 * dim, dim,
                                                   device=device))
        self.q_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.v_bias = nn.Parameter(torch.zeros(dim, device=device))
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, dt = self.dim, self.heads, self.dtype
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt), bias.to(dt))
        B, N, _ = qkv.shape
        q, k, v = qkv.reshape(B, N, 3, h, d // h).permute(2, 0, 3, 1, 4)
        scale = (d // h) ** -0.5
        acc = acc_dtype(dt)
        attn = torch.softmax((q * scale).to(acc) @ k.to(acc).transpose(-1, -2),
                             -1).to(dt)
        out = (attn @ v).transpose(1, 2).reshape(B, N, d)
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)


class _MAEBlock(nn.Module):
    def __init__(self, cfg: VideoMAEConfig, device=None):
        super().__init__()
        dt, d = cfg.torch_dtype(), cfg.embed_dims
        self.dtype, self.init_values = dt, cfg.init_values
        norm_dt = acc_dtype(dt)
        self.norm1 = LayerNorm(d, 1e-6, norm_dt, device)
        self.attn = _MAEAttention(d, cfg.num_heads, dt, device)
        self.norm2 = LayerNorm(d, 1e-6, norm_dt, device)
        self.mlp = _Mlp(d, int(d * cfg.mlp_ratio), dt, device)
        if cfg.init_values > 0:
            self.gamma_1 = nn.Parameter(torch.full((d,), cfg.init_values,
                                                   device=device))
            self.gamma_2 = nn.Parameter(torch.full((d,), cfg.init_values,
                                                   device=device))
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        a = self.attn(self.norm1(x).to(dt))
        if self.gamma_1 is not None:
            a = self.gamma_1.to(a.dtype) * a
        x = x + a
        m = self.mlp.fc1(self.norm2(x.to(acc_dtype(dt))).to(dt))
        m = self.mlp.fc2(F.gelu(m))
        if self.gamma_2 is not None:
            m = self.gamma_2.to(m.dtype) * m
        return (x + m).to(dt)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: VideoMAEConfig, device=None):
        super().__init__()
        k = (cfg.tubelet_size, cfg.patch_size, cfg.patch_size)
        self.proj = Conv3d(3, cfg.embed_dims, k, k, dtype=cfg.torch_dtype(),
                           device=device)


@BACKBONES.register("VideoMAEViT")
class VideoMAEViT(nn.Module):
    """(B, T, H, W, 3) videos -> the mean-pooled, fc_norm'd feature (B, D),
    fp32 (float64 for a float64 config)."""

    def __init__(self, cfg: VideoMAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg, device)
        self.blocks = nn.ModuleList(_MAEBlock(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.fc_norm = LayerNorm(cfg.embed_dims, 1e-6,
                                 acc_dtype(cfg.torch_dtype()), device)
        self.feat_dim = cfg.embed_dims
        self._table: Optional[torch.Tensor] = None

    def pos_table(self, device) -> torch.Tensor:
        if self._table is None or self._table.device != torch.device(device):
            self._table = torch.from_numpy(sinusoid_table(
                self.cfg.num_patches, self.cfg.embed_dims)).to(device)
        return self._table

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.torch_dtype()
        x = self.patch_embed.proj(videos.to(dt))
        x = x.reshape(x.shape[0], -1, cfg.embed_dims)
        x = x + self.pos_table(x.device).to(dt)
        for blk in self.blocks:
            x = blk(x)
        return self.fc_norm(x.to(acc_dtype(dt)).mean(1))


def videomae_config_from_sd(sd: dict, num_frames: int = 16,
                            img_size: int = 224,
                            num_heads: Optional[int] = None) -> dict:
    """VideoMAEConfig keywords read off a checkpoint's shapes: num_heads
    defaults to embed_dims // 64 (it is not in the shapes); keys under
    `backbone.` (mmaction's layout) are found too."""
    p = ("backbone." if ("patch_embed.proj.weight" not in sd
                         and "backbone.patch_embed.proj.weight" in sd)
         else "")
    pe = sd[p + "patch_embed.proj.weight"]          # (D, 3, t, p, p)
    n_layers = 0
    while f"{p}blocks.{n_layers}.attn.qkv.weight" in sd:
        n_layers += 1
    embed_dims = int(pe.shape[0])
    if num_heads is None:
        num_heads = max(1, embed_dims // 64)
    return dict(
        num_frames=num_frames, img_size=img_size,
        patch_size=int(pe.shape[-1]), tubelet_size=int(pe.shape[2]),
        embed_dims=embed_dims, num_layers=n_layers, num_heads=num_heads,
        init_values=(0.1 if "blocks.0.gamma_1" in sd else 0.0),
    )

"""MViT (multiscale vision transformer, MViTv2 pooling attention) in
PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/mvit.py.  No importer
reads a reference MViT checkpoint (the reference wraps an unvendored
package), so the state-dict keys follow the JAX tree: `patch_embed`,
`stage{i}_block{j}.{norm1, attn.{q,k,v,proj}, attn.pool_{q,k,v}.{conv,
norm}, shortcut_proj, norm2, fc1, fc2}` and `norm`;
`convert/from_jax.py` carries them both ways.

As the JAX module computes it:
* a tubelet patch embed with flax's 'SAME' padding;
* q, k and v pooled by strided depthwise 3x3x3 convolutions (pad 1, no
  bias) each followed by a LayerNorm; a pool of stride 1 is no pool and
  has no parameters, so `pool_q` exists only at a stage's first block
  (q stride (1, 2, 2) from stage 1 on), `pool_k`/`pool_v` everywhere
  (kv stride (1, 2, 2));
* softmax attention in fp32, then the v2 residual pooling (the pooled q
  added after the value product), then `proj`;
* the shortcut projected only where the channels change, and max-pooled
  (kernel 3, pad 1 with -inf, the q stride) to the q grid;
* LayerNorms at flax's eps 1e-6, exact GELU, the tokens' mean after the
  final norm.
Parameters stay fp32; each layer computes in the dtype flax would
(models/flax_nn.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import BACKBONES
from .flax_nn import Conv3d, Dense, LayerNorm, acc_dtype

Grid = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class MViTConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (1, 2, 11, 2)
    num_heads: Tuple[int, ...] = (1, 2, 4, 8)
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    mlp_ratio: float = 4.0


def _pooled_grid(grid: Sequence[int], stride: Sequence[int]) -> Grid:
    """The grid after a kernel-3/pad-1 pooling at `stride`."""
    return tuple((g - 1) // s + 1 for g, s in zip(grid, stride))


def _pool_skip(x: torch.Tensor, grid: Grid,
               stride: Sequence[int]) -> Tuple[torch.Tensor, Grid]:
    """The shortcut's parameterless max pool (kernel 3, pad 1) onto the
    pooled q grid."""
    if all(s == 1 for s in stride):
        return x, grid
    B, N, C = x.shape
    x = x.reshape(B, *grid, C).permute(0, 4, 1, 2, 3)
    x = F.max_pool3d(x, 3, tuple(stride), 1)
    return x.permute(0, 2, 3, 4, 1).reshape(B, -1, C), \
        _pooled_grid(grid, stride)


class _PoolConv(nn.Module):
    """Strided depthwise 3x3x3 convolution and a LayerNorm on the token
    grid (MViTv2's learnable pooling)."""

    def __init__(self, dim: int, stride: Sequence[int], device=None):
        super().__init__()
        self.stride = tuple(stride)
        self.conv = Conv3d(dim, dim, (3, 3, 3), self.stride,
                           ((1, 1), (1, 1), (1, 1)), groups=dim, bias=False,
                           device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor, grid: Grid):
        B, N, C = x.shape
        x = self.norm(self.conv(x.reshape(B, *grid, C)))
        return x.reshape(B, -1, C), _pooled_grid(grid, self.stride)


def _pool(pool: Optional[_PoolConv], x: torch.Tensor, grid: Grid):
    return (x, grid) if pool is None else pool(x, grid)


class PoolingAttention(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, heads: int,
                 q_stride: Sequence[int] = (1, 1, 1),
                 kv_stride: Sequence[int] = (1, 2, 2), device=None):
        super().__init__()
        self.dim_out, self.heads = dim_out, heads
        self.q = Dense(dim_in, dim_out, device=device)
        self.k = Dense(dim_in, dim_out, device=device)
        self.v = Dense(dim_in, dim_out, device=device)

        def pool(stride):
            return (None if all(s == 1 for s in stride)
                    else _PoolConv(dim_out, stride, device))

        self.pool_q, self.pool_k, self.pool_v = (
            pool(q_stride), pool(kv_stride), pool(kv_stride))
        self.proj = Dense(dim_out, dim_out, device=device)

    def forward(self, x: torch.Tensor, grid: Grid):
        """x: (B, N, C) on `grid` -> (B, N_q, dim_out), the q grid."""
        h = self.heads
        hd = self.dim_out // h
        q, q_grid = _pool(self.pool_q, self.q(x), grid)
        k, _ = _pool(self.pool_k, self.k(x), grid)
        v, _ = _pool(self.pool_v, self.v(x), grid)
        B, nq, _ = q.shape
        nk = k.shape[1]
        qh = q.reshape(B, nq, h, hd).transpose(1, 2)
        kh = k.reshape(B, nk, h, hd).transpose(1, 2)
        vh = v.reshape(B, nk, h, hd).transpose(1, 2)
        acc = acc_dtype(qh.dtype, kh.dtype)
        logits = (qh.to(acc) @ kh.to(acc).transpose(-1, -2)) / math.sqrt(hd)
        w = torch.softmax(logits, -1)
        o = w @ vh.to(acc_dtype(w.dtype, vh.dtype))
        o = o.transpose(1, 2).reshape(B, nq, self.dim_out)
        # MViTv2's residual pooling: the pooled queries added back
        return self.proj(o + q), q_grid


class MViTBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, heads: int,
                 q_stride: Sequence[int] = (1, 1, 1), mlp_ratio: float = 4.0,
                 device=None):
        super().__init__()
        self.q_stride = tuple(q_stride)
        self.norm1 = LayerNorm(dim_in, device=device)
        self.attn = PoolingAttention(dim_in, dim_out, heads, q_stride,
                                     device=device)
        self.shortcut_proj = (Dense(dim_in, dim_out, device=device)
                              if dim_in != dim_out else None)
        self.norm2 = LayerNorm(dim_out, device=device)
        self.fc1 = Dense(dim_out, int(dim_out * mlp_ratio), device=device)
        self.fc2 = Dense(int(dim_out * mlp_ratio), dim_out, device=device)

    def forward(self, x: torch.Tensor, grid: Grid):
        attn, new_grid = self.attn(self.norm1(x), grid)
        sc = x if self.shortcut_proj is None else self.shortcut_proj(x)
        sc, _ = _pool_skip(sc, grid, self.q_stride)
        x = sc + attn
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)))), new_grid


@BACKBONES.register("MViT")
class MViT(nn.Module):
    """(B, T, H, W, 3) videos -> the pooled feature (B, embed_dim·2^(S-1))."""

    def __init__(self, cfg: MViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = Conv3d(3, cfg.embed_dim, cfg.patch_size,
                                  cfg.patch_size, device=device)
        self.block_names = []
        dim = cfg.embed_dim
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            for j in range(depth):
                first = j == 0 and i > 0
                dim_out = dim * 2 if first else dim
                name = f"stage{i}_block{j}"
                self.add_module(name, MViTBlock(
                    dim, dim_out, heads, (1, 2, 2) if first else (1, 1, 1),
                    cfg.mlp_ratio, device))
                self.block_names.append(name)
                dim = dim_out
        self.norm = LayerNorm(dim, device=device)
        self.feat_dim = dim

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(videos)
        B, T, H, W, C = x.shape
        grid = (T, H, W)
        x = x.reshape(B, -1, C)
        for name in self.block_names:
            x, grid = getattr(self, name)(x, grid)
        return self.norm(x).mean(1)

"""Video Swin Transformer (3-D shifted-window attention) in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/swin3d.py, in the
mmaction key layout that the JAX package's `convert_swin3d` reads:
`patch_embed.{proj,norm}`, `layers.{i}.blocks.{j}.{norm1, attn.qkv,
attn.proj, attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}`,
`layers.{i}.downsample.{norm,reduction}` and `norm`.

As the JAX module computes it:
* a tubelet patch embed (flax's 'SAME' padding where the grid does not
  divide), LayerNorms at flax's eps 1e-6, exact GELU;
* each stage's window clipped to its grid, and the shift 0 along an axis
  the window covers; the grid padded to window multiples before every
  block and stripped after it, so padded positions are fresh zeros in
  each block;
* the shift a roll by minus the shift before the attention and by plus
  it after, the shifted windows' mask from the region ids of the padded
  grid;
* the logits an fp32 product divided by √hd, plus the bias table in
  fp32, softmax and the value product in fp32;
* PatchMerging pads odd H/W at the end and concatenates [0::2, 0::2],
  [1::2, 0::2], [0::2, 1::2], [1::2, 1::2].
The config's `drop_path_max` is read by nothing, as in the JAX module.

Parameters stay fp32; each layer computes in the dtype flax would
(models/flax_nn.py).  The relative-position table's size depends on the
clipped window, which depends on the input's size, as the JAX module's
init does: build with `input_shape=(T, H, W)` of the videos (None: the
windows unclipped), and a state dict's tables are taken at their own
shape.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import BACKBONES
from .flax_nn import Conv3d, Dense, LayerNorm, acc_dtype

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class Swin3DConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    mlp_ratio: float = 4.0
    drop_path_max: float = 0.1


def window_partition(x: torch.Tensor, w: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, wd*wh*ww, C)."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // w[0], w[0], H // w[1], w[1], W // w[2], w[2], C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, w[0] * w[1] * w[2], C)


def window_reverse(x: torch.Tensor, w: Sequence[int], B: int, D: int,
                   H: int, W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.reshape(B, D // w[0], H // w[1], W // w[2], w[0], w[1], w[2], C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, C)


def relative_position_index(w: Sequence[int]) -> np.ndarray:
    """(N, N) int index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(w[0]), np.arange(w[1]),
                                  np.arange(w[2]), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w[0] - 1
    rel[:, :, 1] += w[1] - 1
    rel[:, :, 2] += w[2] - 1
    rel[:, :, 0] *= (2 * w[1] - 1) * (2 * w[2] - 1)
    rel[:, :, 1] *= (2 * w[2] - 1)
    return rel.sum(-1)


def shifted_window_mask(dims: Sequence[int], w: Sequence[int],
                        shift: Sequence[int]) -> np.ndarray:
    """(nW, N, N) additive mask of the shifted windows (region ids)."""
    D, H, W = dims
    img = np.zeros((1, D, H, W, 1), np.int32)
    cnt = 0
    for d in (slice(0, -w[0]), slice(-w[0], -shift[0] or None),
              slice(-shift[0] or -w[0], None)):
        for h in (slice(0, -w[1]), slice(-w[1], -shift[1] or None),
                  slice(-shift[1] or -w[1], None)):
            for ww_ in (slice(0, -w[2]), slice(-w[2], -shift[2] or None),
                        slice(-shift[2] or -w[2], None)):
                img[:, d, h, ww_, :] = cnt
                cnt += 1
    x = img.reshape(1, D // w[0], w[0], H // w[1], w[1], W // w[2], w[2], 1)
    win = x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, w[0] * w[1] * w[2])
    return (win[:, None, :] != win[:, :, None]).astype(np.float32) * NEG


def table_rows(w: Sequence[int]) -> int:
    return (2 * w[0] - 1) * (2 * w[1] - 1) * (2 * w[2] - 1)


def stage_windows(cfg: Swin3DConfig,
                  input_shape: Optional[Sequence[int]] = None
                  ) -> Tuple[Tuple[int, int, int], ...]:
    """Each stage's window: the configured one clipped to the stage's
    grid for videos of `input_shape` (T, H, W); None: unclipped."""
    window = tuple(cfg.window_size)
    if input_shape is None:
        return (window,) * len(cfg.depths)
    grid = [-(-n // p) for n, p in zip(input_shape, cfg.patch_size)]
    out = []
    for _ in cfg.depths:
        out.append(tuple(min(w, s) for w, s in zip(window, grid)))
        grid = [grid[0], -(-grid[1] // 2), -(-grid[2] // 2)]
    return tuple(out)


_CACHE: Dict[tuple, torch.Tensor] = {}


def _cached(key: tuple, make, device) -> torch.Tensor:
    key = key + (str(device),)
    if key not in _CACHE:
        _CACHE[key] = torch.from_numpy(make()).to(device)
    return _CACHE[key]


class WindowAttention3D(nn.Module):
    def __init__(self, dim: int, heads: int, window: Sequence[int],
                 device=None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = Dense(dim, 3 * dim, device=device)
        self.proj = Dense(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_rows(window), heads, device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the table's size follows the window the checkpoint was made for
        key = prefix + "relative_position_bias_table"
        table = self.relative_position_bias_table
        if key in state_dict and state_dict[key].shape != table.shape:
            self.relative_position_bias_table = nn.Parameter(torch.zeros(
                state_dict[key].shape, dtype=table.dtype,
                device=table.device), requires_grad=table.requires_grad)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, window: Sequence[int],
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (nB, N, C) windows; mask: (nW, N, N) with nB = B*nW."""
        n, h = x.shape[1], self.heads
        hd = self.dim // h
        table = self.relative_position_bias_table
        if table.shape[0] != table_rows(window):
            raise ValueError(
                f"the relative-position table has {table.shape[0]} rows, "
                f"the window {tuple(window)} needs {table_rows(window)}: "
                f"build Swin3D with the input_shape of these videos")
        q, k, v = self.qkv(x).split(self.dim, -1)
        q, k, v = (t.reshape(-1, n, h, hd).transpose(1, 2) for t in (q, k, v))
        acc = acc_dtype(q.dtype, k.dtype)
        logits = (q.to(acc) @ k.to(acc).transpose(-1, -2)) / math.sqrt(hd)
        idx = _cached(("rel", tuple(window)),
                      lambda: relative_position_index(window).reshape(-1),
                      x.device)
        bias = table[idx].reshape(n, n, h).permute(2, 0, 1)
        logits = logits + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(-1, nw, h, n, n)
                      + mask[None, :, None]).reshape(-1, h, n, n)
        attn = torch.softmax(logits, -1)
        out = attn @ v.to(acc_dtype(attn.dtype, v.dtype))
        return self.proj(out.transpose(1, 2).reshape(-1, n, self.dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, device=device)
        self.fc2 = Dense(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock3D(nn.Module):
    """odd: the block shifts its windows by half a window (the stage's
    odd-numbered blocks)."""

    def __init__(self, dim: int, heads: int, window: Sequence[int],
                 odd: bool, mlp_ratio: float = 4.0, device=None):
        super().__init__()
        self.odd = odd
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention3D(dim, heads, window, device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device)

    def forward(self, x: torch.Tensor,
                window: Sequence[int]) -> torch.Tensor:
        """x: (B, D, H, W, C), its grid padded to multiples of the stage's
        window."""
        B, D, H, W, C = x.shape
        dims = (D, H, W)
        win = tuple(min(w, s) for w, s in zip(window, dims))
        shift = tuple(0 if w >= s or not self.odd else w // 2
                      for w, s in zip(window, dims))
        h = self.norm1(x)
        mask = None
        if any(shift):
            h = torch.roll(h, tuple(-s for s in shift), (1, 2, 3))
            mask = _cached(("mask", dims, win, shift),
                           lambda: shifted_window_mask(dims, win, shift),
                           x.device)
        h = window_reverse(self.attn(window_partition(h, win), win, mask),
                           win, B, D, H, W)
        if any(shift):
            h = torch.roll(h, shift, (1, 2, 3))
        x = x + h
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) -> (B, D, ceil(H/2), ceil(W/2), 2C)."""
        H, W = x.shape[2], x.shape[3]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchEmbed3D(nn.Module):
    def __init__(self, dim: int, patch: Sequence[int], device=None):
        super().__init__()
        self.proj = Conv3d(3, dim, patch, patch, device=device)
        self.norm = LayerNorm(dim, device=device)


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


@BACKBONES.register("Swin3D")
class Swin3D(nn.Module):
    """(B, T, H, W, 3) videos -> the pooled feature (B, embed_dim·2^(S-1))."""

    def __init__(self, cfg: Swin3DConfig, device=None,
                 input_shape: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed3D(cfg.embed_dim, cfg.patch_size, device)
        wins = stage_windows(cfg, input_shape)
        stages, dim = [], cfg.embed_dim
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            win = wins[i]
            blocks = [SwinBlock3D(dim, heads, win, bool(j % 2),
                                  cfg.mlp_ratio, device)
                      for j in range(depth)]
            last = i == len(cfg.depths) - 1
            stages.append(_Stage(blocks, None if last
                                 else PatchMerging(dim, device)))
            if not last:
                dim *= 2
        self.layers = nn.ModuleList(stages)
        self.norm = LayerNorm(dim, device=device)
        self.feat_dim = dim

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.patch_embed.norm(self.patch_embed.proj(videos))
        for stage in self.layers:
            B, D, H, W, C = x.shape
            win = tuple(min(w, s) for w, s in zip(cfg.window_size, (D, H, W)))
            pads = [(-s) % w for s, w in zip((D, H, W), win)]
            for blk in stage.blocks:
                # pad to window multiples before every block and strip
                # after it: padded positions are fresh zeros in each block
                if any(pads):
                    x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
                x = blk(x, win)
                if any(pads):
                    x = x[:, :D, :H, :W]
            if stage.downsample is not None:
                x = stage.downsample(x)
        return self.norm(x).mean(dim=(1, 2, 3))

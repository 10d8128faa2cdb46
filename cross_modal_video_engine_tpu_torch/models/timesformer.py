"""TimeSformer video backbone (divided / joint / space-only attention) in
PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/timesformer.py, with the
same token layout and numerics: one CLS token, then patch-major (p t)
patch tokens; the spatial position embedding added per frame and the
temporal one per patch; divided blocks run attention over time per patch
(through a zero-initialised `temporal_fc`), then over the patches of each
frame with the CLS token broadcast in and its responses averaged; joint
and space-only blocks are pre-norm ViT blocks.  With
`use_flash_attention` the joint and space-only blocks' attention runs
through ops/flash_attention (the CUDA kernel on the card), as in the JAX
package.

Parameters are float32 masters whatever `cfg.dtype` says, as the JAX
package's `init` makes them, and each layer computes in the dtype flax
gives it (models/flax_nn.py): `embed_tokens` rounds the videos and the
cls, pos and time embeddings to `cfg.dtype` where the JAX module does;
the patch embedding, `temporal_fc` and the FFN promote their input with
their parameters (flax's `dtype=None`); the attention computes in its
input's dtype (`MHA(D, H, h.dtype)`); LayerNorms take fp32 statistics
with their scale and bias applied in fp32 (eps 1e-6) and return the
input's dtype.  So a TimeSformer configured in bfloat16 on f32 masters
rounds its input and embeddings to bf16 and computes in f32 from the
patch embedding on; the serving loaders cast the whole model to bf16
(`utils/precision.maybe_cast_model_bf16`, the JAX package's
`maybe_cast_bf16`), and then every layer computes in bf16; a trainer's
bf16 copy of the masters computes in bf16 where the config says
bfloat16 and in f32 (on bf16-rounded values) where it says float32, as
the JAX step's `_cast_tree` does.

Parameter names follow the mmaction/mmcv TimeSformer state dict:
`patch_embed.projection`, `cls_token`, `pos_embed`, `time_embed`, `norm`
and `transformer_layers.layers.{i}`.  A divided block has the keys that
cross_modal_video_engine_tpu.convert.torch_import.convert_timesformer
reads (`attentions.0.{norm,attn,temporal_fc}`, `attentions.1.{norm,attn}`,
`ffns.0.{norm,layers.0.0,layers.1}`), so one state dict loads into both
packages.  A joint or space-only block is mmcv's BaseTransformerLayer
with operation order (norm, self_attn, norm, ffn): `norms.0`,
`attentions.0.attn`, `norms.1`, `ffns.0.layers.0.0`, `ffns.0.layers.1`.
Attention modules keep nn.MultiheadAttention's `in_proj_weight` layout.

Stochastic depth (`DropPath`) and the dropouts after the position and
time embeddings act in train mode, as `train=True` does in the JAX
package, and are the identity in eval mode, in which the model is built
(the JAX default, `train=False`).  Each draws from its module's
`generator` (None: torch's default generator), which a trainer sets.

`remat` recomputes each block's activations in the backward pass
(`torch.utils.checkpoint`, non-reentrant), as the JAX package's
`nn.remat` does, whenever the model runs in train mode with grad on.  The
recomputation replays torch's default generators only, so a block's
DropPath masks are drawn before the checkpointed call and handed to it
(`draw_keeps`): the recomputation applies the masks the forward applied,
and the generator advances as it does without remat.  A joint block with
flash attention then launches the kernel twice a step, once in the
forward and once in the recomputation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.mixed_precision import acc_dtype
from ..utils.device import resolve_device
from .clip import MHA
from .flax_nn import Dense, result_dtype
from .layers import Dropout


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig:
    """The JAX package's TimeSformerConfig, field for field, so its config
    dicts load here."""

    num_frames: int = 8
    img_size: int = 224
    patch_size: int = 16
    embed_dims: int = 768
    num_heads: int = 12
    num_layers: int = 12
    attention_type: str = "divided_space_time"  # | 'joint_space_time' | 'space_only'
    dropout_ratio: float = 0.0
    drop_path_max: float = 0.1
    dtype: str = "float32"
    # > 1: the patch embed is a 3D conv over (tubelet, p, p) and the
    # temporal axis shrinks to num_frames // tubelet_size
    tubelet_size: int = 1
    # joint / space-only attention through the flash kernel
    use_flash_attention: bool = False
    remat: bool = False

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def time_tokens(self) -> int:
        return self.num_frames // self.tubelet_size

    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float64": torch.float64}.get(self.dtype, torch.float32)


class DropPath(nn.Module):
    """Stochastic depth: in train mode each sample (leading index) is
    dropped whole with probability `rate` and the others are scaled by
    1/keep; the identity in eval mode or at rate 0.  The draw takes
    `generator` (None: torch's default generator)."""

    def __init__(self, rate: float,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def draw(self, rows: int, device) -> Optional[torch.Tensor]:
        """The keep mask (rows,) of one call on `rows` samples, or None
        where the module is the identity (eval mode, rate 0)."""
        if not self.training or self.rate == 0.0:
            return None
        return torch.rand(rows, generator=self.generator,
                          device=device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """keep: a mask from `draw` (None: drawn here)."""
        if keep is None:
            keep = self.draw(x.shape[0], x.device)
            if keep is None:
                return x
        keep = keep.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class LN(nn.Module):
    """flax LayerNorm(epsilon=1e-6, dtype=float32) on fp32 activations:
    fp32 statistics, scale and bias applied in fp32, output in x.dtype.
    Where the scale and bias are in x's dtype, torch's layer_norm, which
    computes in fp32 and rounds once, does exactly that in one pass,
    without an fp32 copy of x; otherwise x, scale and bias go to fp32."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if w.dtype == x.dtype:
            return F.layer_norm(x, w.shape, w, b.to(x.dtype), 1e-6)
        return F.layer_norm(x.float(), w.shape, w.float(), b.float(),
                            1e-6).to(x.dtype)


class _Attention(nn.Module):
    """One mmcv attention entry: the attention, with the divided blocks'
    pre-norm and (temporal only) the projection after it."""

    def __init__(self, cfg: TimeSformerConfig, device=None, *,
                 norm: bool = False, temporal_fc: bool = False,
                 use_flash: bool = False):
        super().__init__()
        d = cfg.embed_dims
        if norm:
            self.norm = LN(d, device)
        self.attn = MHA(d, cfg.num_heads, None, device, use_flash=use_flash,
                        param_dtype=torch.float32)
        if temporal_fc:
            self.temporal_fc = Dense(d, d, device=device)


class FFN(nn.Module):
    """Dense -> exact GELU -> Dense (flax's `dtype=None`), in mmcv FFN's
    key layout."""

    def __init__(self, cfg: TimeSformerConfig, device=None, *,
                 norm: bool = False):
        super().__init__()
        d = cfg.embed_dims
        if norm:
            self.norm = LN(d, device)
        self.layers = nn.Sequential(
            nn.Sequential(Dense(d, 4 * d, device=device)),
            Dense(4 * d, d, device=device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.layers[1](F.gelu(self.layers[0][0](h)))


class DividedSTBlock(nn.Module):
    def __init__(self, cfg: TimeSformerConfig, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.attentions = nn.ModuleList([
            _Attention(cfg, device, norm=True, temporal_fc=True),
            _Attention(cfg, device, norm=True)])
        self.ffns = nn.ModuleList([FFN(cfg, device, norm=True)])
        self.drop_path = DropPath(drop_path)

    def draw_keeps(self, b: int, device) -> Tuple:
        """The DropPath masks of one forward on b samples, in the order
        the forward draws them: temporal (b), spatial (b * frames), FFN
        (b)."""
        dp = self.drop_path
        return (dp.draw(b, device),
                dp.draw(b * self.cfg.time_tokens, device),
                dp.draw(b, device))

    def forward(self, x: torch.Tensor,
                keeps: Tuple = (None, None, None)) -> torch.Tensor:
        """x: (B, 1 + P*T, D), patch-major (p t) token order; keeps: the
        masks of `draw_keeps` (None: drawn here)."""
        cfg = self.cfg
        b = x.shape[0]
        p, t, d = cfg.num_patches, cfg.time_tokens, cfg.embed_dims
        temporal, spatial = self.attentions

        # attention over time, per patch
        cls0, patches = x[:, :1], x[:, 1:]
        rt = temporal.attn(temporal.norm(patches.reshape(b * p, t, d)))
        rt = temporal.temporal_fc(self.drop_path(rt.reshape(b, p * t, d),
                                                 keeps[0]))
        patches = patches + rt
        # the spatial residual includes the temporal update
        x = torch.cat([cls0, patches], 1)

        # attention over the patches of each frame, CLS broadcast in
        ps = patches.reshape(b, p, t, d).transpose(1, 2).reshape(b * t, p, d)
        cls_rep = cls0.expand(b, t, d).reshape(b * t, 1, d)
        rs = self.drop_path(spatial.attn(spatial.norm(
            torch.cat([cls_rep, ps], 1))), keeps[1])
        cls_res = rs[:, 0].reshape(b, t, d).mean(1, keepdim=True)
        patch_res = rs[:, 1:].reshape(b, t, p, d).transpose(1, 2) \
            .reshape(b, p * t, d)
        x = x + torch.cat([cls_res, patch_res], 1)

        ffn = self.ffns[0]
        return x + self.drop_path(ffn(ffn.norm(x)), keeps[2])


class JointBlock(nn.Module):
    """Pre-norm ViT block over all tokens (joint) or one frame's tokens
    (space-only)."""

    def __init__(self, cfg: TimeSformerConfig, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        d = cfg.embed_dims
        self.norms = nn.ModuleList([LN(d, device), LN(d, device)])
        self.attentions = nn.ModuleList([_Attention(
            cfg, device, use_flash=cfg.use_flash_attention)])
        self.ffns = nn.ModuleList([FFN(cfg, device)])
        self.drop_path = DropPath(drop_path)

    def draw_keeps(self, b: int, device) -> Tuple:
        """The DropPath masks of one forward on b samples: attention,
        FFN."""
        return (self.drop_path.draw(b, device),
                self.drop_path.draw(b, device))

    def forward(self, x: torch.Tensor,
                keeps: Tuple = (None, None)) -> torch.Tensor:
        x = x + self.drop_path(self.attentions[0].attn(self.norms[0](x)),
                               keeps[0])
        return x + self.drop_path(self.ffns[0](self.norms[1](x)), keeps[1])


class TimeSformer(nn.Module):
    def __init__(self, cfg: TimeSformerConfig, device=None):
        super().__init__()
        device = resolve_device(device)   # None: the CUDA device
        if cfg.attention_type not in ("divided_space_time",
                                      "joint_space_time", "space_only"):
            raise ValueError(f"attention_type {cfg.attention_type!r}")
        self.cfg = cfg
        d, ps = cfg.embed_dims, cfg.patch_size
        self.patch_embed = nn.Module()
        if cfg.tubelet_size > 1:
            k = (cfg.tubelet_size, ps, ps)
            self.patch_embed.projection = nn.Conv3d(3, d, k, stride=k,
                                                    device=device)
        else:
            self.patch_embed.projection = nn.Conv2d(3, d, ps, stride=ps,
                                                    device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, d, device=device))
        if cfg.attention_type != "space_only":
            self.time_embed = nn.Parameter(
                torch.zeros(1, cfg.time_tokens, d, device=device))
        self.drop_after_pos = Dropout(cfg.dropout_ratio)
        self.drop_after_time = Dropout(cfg.dropout_ratio)
        block = (DividedSTBlock if cfg.attention_type == "divided_space_time"
                 else JointBlock)
        rates = torch.linspace(0, cfg.drop_path_max, cfg.num_layers).tolist()
        self.transformer_layers = nn.Module()
        self.transformer_layers.layers = nn.ModuleList(
            block(cfg, rate, device) for rate in rates)
        self.norm = LN(d, device)
        self.eval()   # the JAX default (train=False); .train() for dropout

    @property
    def blocks(self) -> nn.ModuleList:
        return self.transformer_layers.layers

    def _block(self, blk: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """One block, rematerialised in the backward pass under `remat`
        in train mode with grad on (its DropPath masks drawn first)."""
        if self.cfg.remat and self.training and torch.is_grad_enabled():
            return checkpoint(blk, x, blk.draw_keeps(x.shape[0], x.device),
                              use_reentrant=False)
        return blk(x)

    def _pool(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if cfg.attention_type == "space_only":
            # mean over time first, then the final norm (reference order)
            x = x.reshape(-1, cfg.time_tokens, cfg.num_patches + 1,
                          cfg.embed_dims).mean(1)
        x = self.norm(x)
        return x, x[:, 0].to(acc_dtype(x.dtype))

    def embed_tokens(self, videos: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> the layer-0 token sequence: patch embedding,
        CLS, spatial and (unless space-only) temporal embeddings.  The
        videos and the three embeddings are rounded to `cfg.dtype`; the
        patch embedding and the sums promote, as flax's do."""
        cfg = self.cfg
        dt = cfg.torch_dtype()
        b, t_in = videos.shape[:2]
        if t_in != cfg.num_frames:
            raise ValueError(f"{t_in} frames for a model of "
                             f"{cfg.num_frames}")
        p, d, t = cfg.num_patches, cfg.embed_dims, cfg.time_tokens
        proj = self.patch_embed.projection
        videos = videos.to(dt)
        ct = result_dtype(videos, proj.weight, proj.bias)
        w, bias = proj.weight.to(ct), proj.bias.to(ct)
        if cfg.tubelet_size > 1:                 # (B, 3, T, H, W)
            x = F.conv3d(videos.to(ct).permute(0, 4, 1, 2, 3), w, bias,
                         stride=proj.stride)
            x = x.permute(0, 2, 3, 4, 1).reshape(b * t, p, d)
        else:                                    # (B*T, 3, H, W)
            x = F.conv2d(videos.to(ct).flatten(0, 1).permute(0, 3, 1, 2),
                         w, bias, stride=proj.stride)
            x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(dt)
        ct = result_dtype(cls, x)
        x = self.drop_after_pos(
            torch.cat([cls.expand(b * t, 1, d).to(ct), x.to(ct)], 1)
            + self.pos_embed.to(dt))
        if cfg.attention_type != "space_only":
            cls_tokens = x.reshape(b, t, p + 1, d)[:, 0, :1]  # frame 0's
            patches = self.drop_after_time(
                x[:, 1:].reshape(b, t, p, d).transpose(1, 2)
                + self.time_embed.to(dt))
            x = torch.cat([cls_tokens, patches.reshape(b, p * t, d)], 1)
        return x

    def forward(self, videos: torch.Tensor, *, return_tokens: bool = False,
                capture_layers: Tuple[int, ...] = ()):
        """videos: (B, T, H, W, 3) -> cls feature (B, D) in fp32; with
        `return_tokens` also the final token sequence (fp32), and with
        `capture_layers` a dict {layer: tokens after that block (fp32)},
        returned last."""
        x = self.embed_tokens(videos)
        captured: Dict[int, torch.Tensor] = {}
        for i, blk in enumerate(self.blocks):
            x = self._block(blk, x)
            if i in capture_layers:
                captured[i] = x.float()
        x, cls_feat = self._pool(x)
        out = (cls_feat, x.float()) if return_tokens else (cls_feat,)
        if capture_layers:
            out = out + (captured,)
        return out if len(out) > 1 else cls_feat

    def forward_from(self, tokens: torch.Tensor, layer: int) -> torch.Tensor:
        """Continue from the tokens after block `layer` to the cls feature
        (the explain stack's gradient target)."""
        x = tokens.to(self.cfg.torch_dtype())   # as the JAX module does
        for blk in list(self.blocks)[layer + 1:]:
            x = self._block(blk, x)
        return self._pool(x)[1]

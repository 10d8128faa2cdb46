"""Composed-retrieval fusion head ("Combiner") in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/combiner.py (the
rebuild of MultiFusion/src/combiner.py:81-180), with the same dataflow:

  * text & frame-mean video high-features projected, concatenated, fused by
    `combiner_layer`;
  * a sigmoid `dynamic_scalar` convexly mixes raw text vs video features;
  * a cross-attention block (query = projected text, key/value = projected
    middle tokens over frames x grid) whose output adds `mean(values) +
    attn` then an MLP residual (combiner.py:38-43);
  * output = output_layer(fused) + a*text + (1-a)*video + attn_branch,
    L2-normalized (combiner.py:174-180);
  * logits = 100 * pred @ target.T with targets frame-meaned + normalized
    (`time_process`, combiner.py:121-143).

Everything is f32.  Parameter names follow the reference Combiner's state
dict (`dynamic_scalar.{0,3}`, `self_attn_1.attn` as nn.MultiheadAttention,
`self_attn_1.mlp.c_fc`), the layout the JAX package's
`convert_combiner` (convert/torch_import.py) reads.
`m_remained` is that layout's 1x1 Conv2d with middle_mix='conv4x4' and a
Linear with 'dense'.  The seven dropouts act in train mode and draw from
their `generator` (models/layers.Dropout), which a trainer sets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.similarity import l2norm
from ..utils.device import resolve_device
from .clip import MLP, MHA, LayerNormF32
from .layers import Dropout


@dataclasses.dataclass(frozen=True)
class CombinerConfig:
    """The JAX package's CombinerConfig, field for field."""
    clip_feature_dim: int = 640
    projection_dim: int = 2560
    hidden_dim: int = 5120
    n_heads: int = 8
    logit_scale: float = 100.0
    dropout: float = 0.5
    # how `m_remained` mixes the middle tokens:
    #   'dense'   — per-token Linear over channels (what the trainer trains);
    #   'conv4x4' — the reference checkpoint's contract (combiner.py:111,
    #               165): torch views the (L, D) block row-major as
    #               (L*D/16, 4, 4) and runs a 1x1 Conv2d, a product over
    #               groups of 16 consecutive (token, channel) elements.
    #               Its weight is (D, D, 1, 1), so L*D/16 must equal D
    #               (L == 16).
    middle_mix: str = "dense"


class CrossAttentionBlock(nn.Module):
    """q: (B, 1, D); kv: (B, S, D) -> (B, D).  Mirrors combiner.py:19-43:
    out = mean(kv) + attn(ln_1(q), ln_1(kv)); out = out + mlp(ln_2(out))."""

    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.ln_1 = LayerNormF32(width, device)
        self.attn = MHA(width, heads, torch.float32, device)
        self.ln_2 = LayerNormF32(width, device)
        self.mlp = MLP(width, torch.float32, device)

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        attn = self.attn(self.ln_1(q), kv=self.ln_1(kv))
        x = kv.mean(dim=1) + attn[:, 0, :]
        return x + self.mlp(self.ln_2(x))


class Combiner(nn.Module):
    """Built in eval mode on `device` (None: the CUDA device)."""

    def __init__(self, cfg: CombinerConfig, device=None):
        super().__init__()
        if cfg.middle_mix not in ("dense", "conv4x4"):
            raise ValueError(f"unknown middle_mix {cfg.middle_mix!r}")
        device = resolve_device(device)
        self.cfg = cfg
        d, proj, hid = cfg.clip_feature_dim, cfg.projection_dim, cfg.hidden_dim
        p = cfg.dropout
        self.text_projection_layer = nn.Linear(d, proj, device=device)
        self.image_projection_layer = nn.Linear(d, proj, device=device)
        self.combiner_layer = nn.Linear(2 * proj, hid, device=device)
        self.output_layer = nn.Linear(hid, d, device=device)
        self.dynamic_scalar = nn.Sequential(
            nn.Linear(2 * proj, hid, device=device), nn.ReLU(), Dropout(p),
            nn.Linear(hid, 1, device=device), nn.Sigmoid())
        if cfg.middle_mix == "conv4x4":
            self.m_remained = nn.Conv2d(d, d, 1, device=device)
        else:
            self.m_remained = nn.Linear(d, d, device=device)
        self.m_residual = nn.Linear(d, d, device=device)
        self.self_attn_1 = CrossAttentionBlock(d, cfg.n_heads, device)
        for i in (1, 2, 3, 4, 6, 7):
            setattr(self, f"dropout{i}", Dropout(p))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.output_layer.weight.device

    def _mix_middle(self, middle: torch.Tensor) -> torch.Tensor:
        b, f, l, d = middle.shape
        if self.cfg.middle_mix == "dense":
            return self.m_remained(middle)
        c = l * d // 16
        if c != d:
            raise ValueError(f"conv4x4 needs L*D/16 == D (L == 16), got "
                             f"L={l}, D={d}")
        # the (B*F, C, 16) view of the row-major (L, D) block, mixed over C
        xc = middle.reshape(b * f, c, 16).float()
        w = self.m_remained.weight[:, :, 0, 0].float()      # (C_out, C_in)
        mixed = torch.einsum("bcs,oc->bos", xc, w) \
            + self.m_remained.bias.float()[None, :, None]
        return mixed.reshape(b, f, l, d).to(middle.dtype)

    def combine_features(self, image_features: Tuple[torch.Tensor,
                                                     torch.Tensor],
                         text_features: torch.Tensor) -> torch.Tensor:
        """image_features: (high (B, F, D), middle (B, F, L, D));
        text_features: (B, D).  Returns L2-normalized predicted features
        (B, D)."""
        high, middle = image_features
        b, f, l, d = middle.shape
        p_s_m = self.dropout7(F.relu(self._mix_middle(middle)))
        p_r_m = self.dropout6(F.relu(self.m_residual(text_features)))
        based = self.self_attn_1(p_r_m[:, None, :],
                                 p_s_m.reshape(b, f * l, d))
        based = self.dropout4(F.relu(based))

        video_high = self.time_process(high)
        text_proj = self.dropout1(F.relu(
            self.text_projection_layer(text_features)))
        image_proj = self.dropout2(F.relu(
            self.image_projection_layer(video_high)))
        raw = torch.cat([image_proj, text_proj], dim=-1)
        combined = self.dropout3(F.relu(self.combiner_layer(raw)))
        dynamic_scalar = self.dynamic_scalar(raw)
        output = (self.output_layer(combined)
                  + dynamic_scalar * text_features
                  + (1.0 - dynamic_scalar) * video_high
                  + based)
        return l2norm(output)

    @staticmethod
    def time_process(fea: torch.Tensor) -> torch.Tensor:
        return fea.mean(dim=1)

    def forward(self, image_features, text_features, target_features
                ) -> torch.Tensor:
        """target_features: (high (B, F, D), ...) of the target videos.
        Returns (B, B) scaled logits (combiner.py:121-138)."""
        pred = self.combine_features(image_features, text_features)
        target = l2norm(self.time_process(target_features[0]))
        return self.cfg.logit_scale * (pred.float() @ target.float().t())


def random_state_dict(cfg: CombinerConfig, seed: int
                      ) -> Dict[str, torch.Tensor]:
    """A Combiner state dict of random f32 weights from a numpy seed:
    matrices and the 1x1 conv at fan-in scale, biases small, LayerNorms
    near unit.  Both packages load it (the JAX one through
    combiner_variables_to_jax)."""
    rng = np.random.default_rng(seed)
    shapes = Combiner(cfg, device="meta").state_dict()
    out = {}
    for name, t in shapes.items():
        shape = tuple(t.shape)
        z = rng.standard_normal(shape, dtype=np.float32)
        if ".ln_" in name:
            a = (1.0 if name.endswith("weight") else 0.0) + 0.1 * z
        elif name.endswith("bias"):
            a = 0.02 * z
        else:
            a = int(np.prod(shape[1:])) ** -0.5 * z
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out

"""Word-level transformer caption decoder with KV-cache greedy and beam
decode, in PyTorch.

Counterpart of cross_modal_video_engine_tpu/models/caption_transformer.py:
an autoregressive token decoder over a video backbone's tokens with

  * causal self-attention and cross-attention to the encoder tokens;
  * a KV cache laid out (layers, 2, N, max_len, D) (each step projects
    only the current token), the cross-attention K and V computed once
    before the loop;
  * greedy decode and width-W beam search: beams fold into the batch
    axis and the cache rows are gathered by beam origin every step.

Parameters carry the JAX module's names and layouts (`token_embedding`
(V, D), `l{l}_self_q` (D, D) applied as x @ W, ...), so a state dict is
the JAX `params` tree read leaf for leaf.  Everything computes in f32: the
JAX module's parameters are f32 and its einsums ask for f32 results.
Details the JAX module fixes: LayerNorm eps 1e-5, GELU in its tanh form
(jax.nn.gelu's default), no biases, the finite mask value NEG = -1e9, and
top-k ties broken by the lower index (jax.lax.top_k), which a stable
descending sort gives here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class CaptionConfig:
    vocab_size: int = 10000
    d_model: int = 512
    heads: int = 8
    layers: int = 4
    max_len: int = 24
    enc_dim: int = 768
    bos_id: int = 1
    eos_id: int = 2


def param_shapes(cfg: CaptionConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's JAX name and shape, in the JAX module's order."""
    D, V = cfg.d_model, cfg.vocab_size
    shapes = {"token_embedding": (V, D), "pos_embedding": (cfg.max_len, D),
              "enc_proj": (cfg.enc_dim, D)}
    for l in range(cfg.layers):
        for blk in ("self", "cross"):
            for w in ("q", "k", "v", "o"):
                shapes[f"l{l}_{blk}_{w}"] = (D, D)
        shapes[f"l{l}_mlp1"] = (D, 4 * D)
        shapes[f"l{l}_mlp2"] = (4 * D, D)
        for ln in ("ln1", "ln2", "ln3"):
            shapes[f"l{l}_{ln}_s"] = (D,)
            shapes[f"l{l}_{ln}_b"] = (D,)
    shapes["lnf_s"] = (D,)
    shapes["lnf_b"] = (D,)
    shapes["out"] = (D, V)
    return shapes


def _ln(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * s + b


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: descending, ties to the lower
    index (torch.topk on CUDA promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class CaptionTransformer(nn.Module):
    """forward(enc_tokens (B, Le, enc_dim), token_ids, mode):
    'train' -> logits (B, T, V) of teacher forcing on token_ids (B, T);
    'greedy' -> (ids (B, max_len), logprob (B,)); 'beam' -> the best
    beam's (ids, logprob) of a width-`beam_width` search.  The parameters
    start at zero (LayerNorm scales at one): load a state dict."""

    def __init__(self, cfg: CaptionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        for name, shape in param_shapes(cfg).items():
            fill = torch.ones if name.endswith("_s") else torch.zeros
            self.register_parameter(name, nn.Parameter(
                fill(shape, dtype=torch.float32, device=device)))

    def p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def _mha(self, pre: str, q, k, v, mask=None) -> torch.Tensor:
        H, D = self.cfg.heads, self.cfg.d_model
        hd = D // H
        qq = (q @ self.p(f"{pre}_q")).unflatten(-1, (H, hd))
        kk = (k @ self.p(f"{pre}_k")).unflatten(-1, (H, hd))
        vv = (v @ self.p(f"{pre}_v")).unflatten(-1, (H, hd))
        logits = torch.einsum("...qhd,...khd->...hqk", qq, kk) / np.sqrt(hd)
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, -1)
        o = torch.einsum("...hqk,...khd->...qhd", w, vv)
        return o.flatten(-2) @ self.p(f"{pre}_o")

    def _mlp(self, l: int, h: torch.Tensor) -> torch.Tensor:
        return (F.gelu(h @ self.p(f"l{l}_mlp1"), approximate="tanh")
                @ self.p(f"l{l}_mlp2"))

    def _norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return _ln(x, self.p(f"{name}_s"), self.p(f"{name}_b"))

    def forward(self, enc_tokens: torch.Tensor, token_ids=None,
                mode: str = "train", beam_width: int = 4):
        enc = enc_tokens.float() @ self.p("enc_proj")          # (B, Le, D)
        if mode == "train":
            return self._train_forward(enc, token_ids)
        if mode == "greedy":
            return self._decode(enc, 1)
        return self._decode(enc, beam_width)

    # -- teacher forcing -------------------------------------------------------
    def _train_forward(self, enc: torch.Tensor,
                       token_ids: torch.Tensor) -> torch.Tensor:
        T = token_ids.shape[1]
        x = self.p("token_embedding")[token_ids] + self.p("pos_embedding")[:T]
        causal = torch.triu(torch.full((T, T), NEG, device=enc.device), 1)
        for l in range(self.cfg.layers):
            h = self._norm(f"l{l}_ln1", x)
            x = x + self._mha(f"l{l}_self", h, h, h, causal)
            h = self._norm(f"l{l}_ln2", x)
            x = x + self._mha(f"l{l}_cross", h, enc, enc)
            x = x + self._mlp(l, self._norm(f"l{l}_ln3", x))
        return self._norm("lnf", x) @ self.p("out")

    # -- one cached step -------------------------------------------------------
    def _attend(self, pre: str, q_vec, keys, vals, mask=None):
        """q_vec (N, D) against post-projection keys/values (N, L, D)."""
        H, D = self.cfg.heads, self.cfg.d_model
        hd = D // H
        q = (q_vec @ self.p(f"{pre}_q")).reshape(-1, H, hd)
        k = keys.unflatten(-1, (H, hd))
        v = vals.unflatten(-1, (H, hd))
        logits = torch.einsum("nhd,nkhd->nhk", q, k) / np.sqrt(hd)
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, -1)
        o = torch.einsum("nhk,nkhd->nhd", w, v)
        return o.reshape(-1, D) @ self.p(f"{pre}_o")

    def _step(self, cross_kv, ids_t, pos: int, cache: torch.Tensor):
        """ids_t (N,) at position `pos`; cache (layers, 2, N, max_len, D),
        written in place at `pos`.  Returns the logits (N, V)."""
        x = self.p("token_embedding")[ids_t] + self.p("pos_embedding")[pos]
        keys_at = torch.arange(self.cfg.max_len, device=x.device)
        mask = torch.where(keys_at <= pos, 0.0, NEG)[None, None, :]
        for l in range(self.cfg.layers):
            h = self._norm(f"l{l}_ln1", x)
            cache[l, 0, :, pos] = h @ self.p(f"l{l}_self_k")
            cache[l, 1, :, pos] = h @ self.p(f"l{l}_self_v")
            x = x + self._attend(f"l{l}_self", h, cache[l, 0], cache[l, 1],
                                 mask)
            h = self._norm(f"l{l}_ln2", x)
            x = x + self._attend(f"l{l}_cross", h, *cross_kv[l])
            x = x + self._mlp(l, self._norm(f"l{l}_ln3", x))
        return self._norm("lnf", x) @ self.p("out")

    # -- greedy / beam ---------------------------------------------------------
    @torch.no_grad()
    def _decode(self, enc: torch.Tensor, W: int):
        cfg = self.cfg
        B, dev = enc.shape[0], enc.device
        N, V, T = B * W, cfg.vocab_size, cfg.max_len
        enc_rep = enc.repeat_interleave(W, 0)                  # (N, Le, D)
        cross_kv = [(enc_rep @ self.p(f"l{l}_cross_k"),
                     enc_rep @ self.p(f"l{l}_cross_v"))
                    for l in range(cfg.layers)]
        cache = torch.zeros((cfg.layers, 2, N, T, cfg.d_model),
                            dtype=torch.float32, device=dev)
        ids = torch.full((N, T), cfg.eos_id, dtype=torch.int64, device=dev)
        # beam 0 live, the others at NEG so the first expansion seeds
        scores = torch.tensor([0.0] + [NEG] * (W - 1),
                              device=dev).repeat(B)
        finished = torch.zeros(N, dtype=torch.bool, device=dev)
        cur = torch.full((N,), cfg.bos_id, dtype=torch.int64, device=dev)
        eos_only = torch.full((V,), NEG, device=dev)
        eos_only[cfg.eos_id] = 0.0
        base = (torch.arange(B, device=dev) * W)[:, None]
        for t in range(T):
            logp = torch.log_softmax(self._step(cross_kv, cur, t, cache), -1)
            # a finished beam extends only with EOS, at no cost
            logp = torch.where(finished[:, None], eos_only[None], logp)
            total = (scores[:, None] + logp).reshape(B, W * V)
            top_scores, top_idx = _top_k(total, W)             # (B, W)
            origin = (top_idx // V + base).reshape(N)
            ids = ids[origin]
            cache = cache[:, :, origin]
            finished = finished[origin]
            cur = (top_idx % V).reshape(N)
            ids[:, t] = cur
            finished = finished | (cur == cfg.eos_id)
            scores = top_scores.reshape(N)
        ids = ids.reshape(B, W, T)
        scores = scores.reshape(B, W)
        best = scores.argmax(1)
        rows = torch.arange(B, device=dev)
        return ids[rows, best], scores[rows, best]


def random_state_dict(cfg: CaptionConfig, seed: int
                      ) -> Dict[str, torch.Tensor]:
    """f32 weights from a numpy seed with the JAX init's scales: token
    embedding and output at 0.02, positions at 0.01, matrices at
    fan-in**-0.5, LayerNorms near one and zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        z = rng.standard_normal(shape)
        if name in ("token_embedding", "out"):
            a = 0.02 * z
        elif name == "pos_embedding":
            a = 0.01 * z
        elif name.endswith("_s"):
            a = 1.0 + 0.1 * z
        elif name.endswith("_b"):
            a = 0.02 * z
        else:
            a = z / math.sqrt(shape[0])
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out

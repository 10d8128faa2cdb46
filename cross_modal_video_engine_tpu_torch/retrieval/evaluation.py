"""Batched encoding helpers (LINAS evaluation.py:88-171 equivalent).

A copy of cross_modal_video_engine_tpu/retrieval/evaluation.py.
`encode_batched` runs an embed function over a host iterator of batches
with a fixed batch size (padding the tail), so every call sees one shape.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np


def norm_score(t2v_all_errors: np.ndarray) -> np.ndarray:
    """Min-max normalize an error matrix (LINAS validate.py:7-11)."""
    t2v_all_score = -t2v_all_errors
    t2v_all_score = t2v_all_score - np.min(t2v_all_score)
    t2v_all_score = t2v_all_score / np.max(t2v_all_score)
    return -t2v_all_score


def encode_batched(embed_fn: Callable, batches: Iterable, n_total: int,
                   out_dim: int) -> np.ndarray:
    """Apply `embed_fn` (fixed batch shape; returns an array or a tensor)
    over batches; returns the stacked (n_total, out_dim) embedding
    matrix."""
    out = np.zeros((n_total, out_dim), np.float32)
    pos = 0
    for batch in batches:
        emb = embed_fn(batch)
        if hasattr(emb, "detach"):
            emb = emb.detach().cpu()
        emb = np.asarray(emb)
        take = min(len(emb), n_total - pos)
        out[pos:pos + take] = emb[:take]
        pos += take
    assert pos == n_total, f"iterator produced {pos} rows, expected {n_total}"
    return out

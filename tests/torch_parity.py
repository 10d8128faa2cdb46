"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
JAX package's Pallas kernels run in interpret mode on the CPU, random
weights are drawn with numpy for both packages, and outputs are compared
by cosine where bf16 rounding moves single elements."""

import jax
import numpy as np
import torch


def interpret_pallas(monkeypatch) -> None:
    """Run every pallas_call of the JAX package in interpret mode (CPU)
    for the rest of the test, as its own tests do."""
    import jax.experimental.pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def random_variables(variables, seed: int):
    """A flax variables tree with every leaf redrawn from a numpy seed:
    LayerNorm scales near 1, biases small, embeddings at 0.02, the caption
    head's start embedding at 1, kernels at lecun-normal scale (fan-in is
    every axis but the last).  Returns numpy arrays."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("cls_token", "pos_embed", "time_embed"):
            a = 0.02 * rng.standard_normal(shape)
        elif name == "start_emb":
            a = rng.standard_normal(shape)
        elif "bias" in name or name in ("rnn_bi", "rnn_bh"):
            a = 0.02 * rng.standard_normal(shape)
        else:
            a = int(np.prod(shape[:-1])) ** -0.5 * rng.standard_normal(shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def min_cosine(a, b) -> float:
    """Smallest cosine between matching rows (last axis) of a and b."""
    a = np.asarray(a, np.float64).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b, np.float64).reshape(-1, np.shape(b)[-1])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    return float(cos.min())


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()

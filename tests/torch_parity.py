"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
JAX package's Pallas kernels run in interpret mode on the CPU, random
weights are drawn with numpy for both packages, and outputs are compared
by cosine where bf16 rounding moves single elements."""

import jax
import numpy as np
import torch
from flax import serialization

from cross_modal_video_engine_tpu_torch.convert import (
    rec_train_state_from_jax, recognizer_state_dict_from_jax)


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


def capturing(tx):
    """An optax transformation `tx` that also keeps the raw gradients it
    was given in its state, (grads, tx's state): a JAX train step built on
    it hands its gradients out with the new state."""
    import jax.numpy as jnp
    import optax

    def init(params):
        return (jax.tree.map(jnp.zeros_like, params), tx.init(params))

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def max_rel(a, b) -> float:
    """max |a - b| over the largest |b| (0 where both are all zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max()
    err = np.abs(a - b).max()
    if scale:
        return float(err / scale)
    return 0.0 if err == 0 else float("inf")


# -- train steps against JAX's (tests/test_torch_{caption,recognition}_train.py)

TRAIN_STEP_TOL = 1e-5
ADAM_NOISE = 1e-6            # 100 x Adam's eps


def key_bias_mask(model) -> dict:
    """{parameter name: bool mask} of the attention key biases, whose
    gradient softmax makes rounding noise."""
    out = {}
    for name, p in model.named_parameters():
        if name.endswith("attn.in_proj_bias"):
            d = p.shape[0] // 3
            m = torch.zeros(p.shape, dtype=torch.bool)
            m[d:2 * d] = True
            out[name] = m
    return out


def jax_state_tree(jstate) -> dict:
    """A JAX RecTrainState built on `capturing`'s optimizer as the tree
    its own optimizer's state serializes to."""
    return serialization.to_state_dict(jax.tree.map(np.asarray, {
        "params": jstate.params, "opt_state": jstate.opt_state[1],
        "step": jstate.step}))


def load_jax_state(tstate, jstate, kind: str, clip: bool):
    """JAX's state into the port's, through rec_train_state_from_jax."""
    model, opt = tstate.model, tstate.optimizer
    sd, named, step = rec_train_state_from_jax(
        jax_state_tree(jstate), model.backbone.cfg, kind, clip)
    model.load_state_dict(sd)
    opt.load_named_state(named)
    return tstate._replace(step=step)


def check_step(tm, cfg, jstate, tlogs, jlogs, lr, kind):
    """The port's step against JAX's from the same state: the loss within
    TRAIN_STEP_TOL relative; each gradient (JAX's captured by `capturing`)
    and each parameter after the step within TRAIN_STEP_TOL of its
    tensor's largest magnitude, except under AdamW the elements whose
    gradient is below ADAM_NOISE and the attention key biases (their
    gradient is rounding noise, which AdamW turns into a step of +-lr):
    held to 2 lr."""
    jloss_ = float(jlogs["loss"])
    assert abs(float(tlogs["loss"]) - jloss_) <= TRAIN_STEP_TOL * abs(jloss_)
    jgrads = recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.opt_state[0])}, cfg)
    jparams = recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.params)}, cfg)
    noise = key_bias_mask(tm) if kind == "adamw" else {}
    for name, p in tm.named_parameters():
        assert max_rel(to_np(p.grad), jgrads[name]) <= TRAIN_STEP_TOL, name
        got, want = p.detach(), jparams[name]
        if kind == "adamw":
            m = jgrads[name].abs() < ADAM_NOISE
            if name in noise:
                m |= noise[name]
            if m.any():
                assert float((got[m] - want[m]).abs().max()) <= 2 * lr, name
            got, want = got[~m], want[~m]
        if got.numel():
            assert max_rel(to_np(got), want.numpy()) <= TRAIN_STEP_TOL, name

"""Shared pieces of the transformer and CLIP recognizers' parity tests
(tests/test_torch_{swin3d,mvit,videomae,videoclip,clip_recognizer}.py):
seeded state dicts for a port model, the JAX variables through the port's
converter, and one `make_cls_train_step` of both packages from the same
weights, compared in f32 and under bf16=True.

* f32: the loss within LOSS_REL relative; each gradient within GRAD_TOL
  of its tensor's largest and at cosine >= GRAD_COS (a gradient that is
  rounding noise in both packages, below NOISE of the model's largest,
  within NOISE of it instead); each parameter after the step within
  PARAM_TOL of its tensor's largest.
* bf16 (f32 masters, the forward and backward on a bf16 copy): the loss
  within BF16_LOSS_REL of JAX's bf16 loss; by group (attention, MLP and
  norms, embeddings and head) the port's bf16 gradients at cosine >=
  BF16_COS to JAX's bf16 gradients, and their cosine to the f32 step's
  no more than BF16_MARGIN below JAX's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from torch_parity import capturing, max_rel, min_cosine, to_np

LOSS_REL, GRAD_COS, GRAD_TOL, NOISE, PARAM_TOL = 1e-5, 0.9999, 1e-4, 1e-5, 1e-5
BF16_LOSS_REL, BF16_COS, BF16_MARGIN = 2e-2, 0.995, 0.02
CHAIN = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
             weight_decay=1e-2, grad_clip=0.5)


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Every entry of the port model's state dict from a numpy seed:
    LayerNorm scales (`*norm*.weight`, `ln_*.weight`) near 1, biases and
    vectors at 0.05, tables and matrices at lecun-normal scale (fan-in:
    every axis but the first)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        owner = name.rsplit(".", 1)[0] if "." in name else ""
        norm = "norm" in owner.rsplit(".", 1)[-1] or "ln_" in owner
        if norm and leaf == "weight":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) <= 1:
            a = 0.05 * rng.standard_normal(shape)
        elif leaf == "relative_position_bias_table":
            a = 0.5 * rng.standard_normal(shape)
        else:
            a = int(np.prod(shape[1:])) ** -0.5 * rng.standard_normal(shape)
        out[name] = torch.tensor(np.asarray(a, np.float32))
    return out


def jax_variables(tm: torch.nn.Module) -> dict:
    return tconv.conv_recognizer_variables_to_jax(tm.state_dict(), tm)


def _jax_state(variables, tx):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jrt.RecTrainState(params, tx.init(params),
                             jnp.zeros((), jnp.int32))


def _optimizers():
    jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(
        **CHAIN), total_steps=5))
    ttx = trt.make_rec_optimizer(trt.RecognitionTrainConfig(**CHAIN),
                                 total_steps=5)
    return jtx, ttx


def steps(tm, jm, x: np.ndarray, labels: np.ndarray, bf16: bool):
    """One make_cls_train_step of each package from tm's weights:
    (port loss, JAX loss, port grads, JAX grads, port params after, JAX
    params after), the grads and params as {port name: tensor}.  tm's
    weights are restored afterwards."""
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    variables = jax_variables(tm)
    jtx, ttx = _optimizers()
    jstate, jlogs = jrt.make_cls_train_step(jm, jtx, bf16=bf16)(
        _jax_state(variables, jtx), jnp.asarray(x),
        jnp.asarray(labels, jnp.int32), jax.random.key(0))
    tstate, tlogs = trt.make_cls_train_step(tm, bf16=bf16, device="cpu")(
        trt.init_rec_state(tm, ttx), torch.from_numpy(x),
        torch.from_numpy(labels.astype(np.int64)))
    assert tstate.step == int(jstate.step) == 1
    assert all(p.dtype == torch.float32 for p in tm.parameters())

    def back(tree):
        return tconv.conv_recognizer_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, tree)}, tm)

    out = (float(tlogs["loss"]), float(jlogs["loss"]),
           {n: (torch.zeros_like(p) if p.grad is None
                else p.grad.detach().clone())
            for n, p in tm.named_parameters()},
           back(jstate.opt_state[0]),
           {n: p.detach().clone() for n, p in tm.named_parameters()},
           back(jstate.params))
    tm.load_state_dict(sd)
    return out


def seq_steps(tm, jm, x: np.ndarray, targets: np.ndarray, mask: np.ndarray):
    """One make_seq_train_step (SeqMLL, teacher forcing) of each package
    from a RecognizerRelseq's weights; returns what `steps` returns."""
    variables = jax_variables(tm)
    jtx, ttx = _optimizers()
    jstate, jlogs = jrt.make_seq_train_step(jm, jtx)(
        _jax_state(variables, jtx), jnp.asarray(x), jnp.asarray(targets),
        jnp.asarray(mask), jax.random.key(0))
    tstate, tlogs = trt.make_seq_train_step(tm, device="cpu")(
        trt.init_rec_state(tm, ttx), torch.from_numpy(x),
        torch.from_numpy(targets), torch.from_numpy(mask))

    def back(tree):
        return tconv.conv_recognizer_state_dict_from_jax(
            {"params": jax.tree.map(np.asarray, tree)}, tm)

    return (float(tlogs["loss"]), float(jlogs["loss"]),
            {n: p.grad.detach().clone() for n, p in tm.named_parameters()},
            back(jstate.opt_state[0]),
            {n: p.detach().clone() for n, p in tm.named_parameters()},
            back(jstate.params))


def check_f32_step(run):
    """run: `steps(..., bf16=False)`."""
    tloss, jloss, tg, jg, tp, jp = run
    assert abs(tloss - jloss) <= LOSS_REL * abs(jloss)
    largest = max(float(g.abs().max()) for g in jg.values())
    for name in tg:
        g, w = to_np(tg[name]), jg[name].numpy()
        if np.abs(w).max() < NOISE * largest:
            assert np.abs(g - w).max() <= NOISE * largest, name
        else:
            assert min_cosine(g.reshape(1, -1), w.reshape(1, -1)) \
                >= GRAD_COS, name
            assert max_rel(g, w) <= GRAD_TOL, name
        assert max_rel(to_np(tp[name]), jp[name].numpy()) <= PARAM_TOL, name


def group(name: str) -> str:
    if any(k in name for k in ("attn", "pool_", "q_bias", "v_bias")):
        return "attention"
    if any(k in name for k in ("mlp", "fc1", "fc2", "norm", "ln_",
                               "gamma")):
        return "mlp_norm"
    return "embed_head"


def _cos(a: dict, b: dict, names) -> float:
    va = np.concatenate([to_np(a[n]).ravel() for n in names])
    vb = np.concatenate([to_np(b[n]).ravel() for n in names])
    return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))


def check_bf16_step(run, f32_run=None):
    """run: `steps(..., bf16=True)` (or the f32 step of a model configured
    in bfloat16); f32_run: the same model's f32 step, when there is one.
    Holds the port to JAX as the module docstring says; returns the group
    cosines (port to JAX, port to f32, JAX to f32)."""
    tloss, jloss, tg, jg, _, _ = run
    assert abs(tloss - jloss) <= BF16_LOSS_REL * abs(jloss)
    groups = {}
    for n in tg:
        groups.setdefault(group(n), []).append(n)
    readings = {}
    for grp, names in groups.items():
        to_jax = _cos(tg, jg, names)
        assert to_jax >= BF16_COS, (grp, to_jax)
        if f32_run is not None:
            port_f32 = _cos(tg, f32_run[3], names)
            jax_f32 = _cos(jg, f32_run[3], names)
            assert port_f32 >= jax_f32 - BF16_MARGIN, (grp, port_f32,
                                                       jax_f32)
            readings[grp] = (to_jax, port_f32, jax_f32)
    return readings

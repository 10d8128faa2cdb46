"""The port's `ops/mixed_precision.einsum_f32acc` and the MHA that uses it,
against the JAX package's, on the CPU.

* bf16 operands of the two attention products (self-attention (2, 4, 50,
  64) and cross-attention with L != S): the forward equals JAX's within
  1e-6 of its largest; each gradient equals JAX's (its autocast backward:
  the cotangent cast to the operand dtype before each gradient product)
  in at least 99.9% of the entries and within one bf16 rounding (2^-8) of
  the largest everywhere.
* The old form, plain autograd through `a.float() @ b.float()`, differs
  from JAX's gradients in more than 20% of the entries (the fault this
  module repairs, shown).
* In f32 the gradients are plain autograd's within 1e-6.
* The pattern assertions of `_grad_patterns`.
* The port's MHA in bf16 (unmasked and causal) against the JAX MHA on the
  same bf16 weights with zero biases (flax's Dense rounds its product
  before adding the bias, F.linear after, which would hide the backward
  behind a forward difference): the output and the gradients of the
  input and of every kernel equal JAX's in at least 99% of the entries
  and within one bf16 rounding of the largest; the bias gradients (bf16
  sums over the rows) within 2^-6 and at cosine >= 0.9999; the key
  bias's, zero but for rounding, aside.  With the old form the input's,
  q's and k's gradients differ in more than 20% of the entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.models import clip as jclip
from cross_modal_video_engine_tpu.ops.mixed_precision import (
    einsum_f32acc as jax_einsum)
from cross_modal_video_engine_tpu_torch.convert.from_jax import _mha_to_jax
from cross_modal_video_engine_tpu_torch.models import clip as tclip
from cross_modal_video_engine_tpu_torch.ops.mixed_precision import (
    einsum_f32acc)
from torch_parity import max_rel, min_cosine

BF16_ULP = 2.0 ** -8
PATTERNS = {
    "scores": ("bhld,bhsd->bhls", (2, 4, 50, 64), (2, 4, 50, 64)),
    "values": ("bhls,bhsd->bhld", (2, 4, 50, 50), (2, 4, 50, 64)),
    "cross_scores": ("bhld,bhsd->bhls", (2, 3, 7, 16), (2, 3, 11, 16)),
    "cross_values": ("bhls,bhsd->bhld", (2, 3, 7, 11), (2, 3, 11, 16)),
}


@pytest.fixture(autouse=True, scope="module")
def _own_rng():
    with torch.random.fork_rng(devices=[]):
        yield


def _bf16(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _case(name: str, seed: int = 0):
    pattern, sa, sb = PATTERNS[name]
    rng = np.random.default_rng(seed)
    a, b = _bf16(rng.standard_normal(sa)), _bf16(rng.standard_normal(sb))
    out_shape = np.einsum(pattern, a, b).shape
    g = rng.standard_normal(out_shape).astype(np.float32)
    return pattern, a, b, g


def _jax_grads(pattern, a, b, g):
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    out, vjp = jax.vjp(lambda x, y: jax_einsum(pattern, x, y), ja, jb)
    return np.asarray(out), [np.asarray(t.astype(jnp.float32))
                             for t in vjp(jnp.asarray(g))]


def _torch_grads(fn, a, b, g, dtype=torch.bfloat16):
    ta = torch.tensor(a).to(dtype).requires_grad_()
    tb = torch.tensor(b).to(dtype).requires_grad_()
    out = fn(ta, tb)
    out.backward(torch.tensor(g, dtype=out.dtype))
    return out.detach().double().numpy(), [t.grad.double().numpy()
                                           for t in (ta, tb)]


@pytest.mark.parametrize("name", list(PATTERNS))
def test_bf16_gradients_equal_jax(name):
    pattern, a, b, g = _case(name)
    jout, jgrads = _jax_grads(pattern, a, b, g)
    out, grads = _torch_grads(
        lambda x, y: einsum_f32acc(pattern, x, y), a, b, g)
    assert out.dtype == np.float64 and max_rel(out, jout) <= 1e-6
    for got, want in zip(grads, jgrads):
        assert (got == want).mean() >= 0.999
        assert np.abs(got - want).max() <= BF16_ULP * np.abs(want).max()


@pytest.mark.parametrize("name", ["scores", "values"])
def test_the_old_float_form_differs(name):
    pattern, a, b, g = _case(name)
    _, jgrads = _jax_grads(pattern, a, b, g)
    _, old = _torch_grads(
        lambda x, y: torch.einsum(pattern, x.float(), y.float()), a, b, g)
    for got, want in zip(old, jgrads):
        assert (got != want).mean() > 0.2
        assert np.abs(got - want).max() > 1e-3 * np.abs(want).max()


def test_f32_gradients_are_plain_autograd():
    pattern, a, b, g = _case("scores", seed=3)
    out, grads = _torch_grads(lambda x, y: einsum_f32acc(pattern, x, y),
                              a, b, g, torch.float32)
    pout, pgrads = _torch_grads(lambda x, y: torch.einsum(pattern, x, y),
                                a, b, g, torch.float32)
    assert max_rel(out, pout) <= 1e-6
    for got, want in zip(grads, pgrads):
        assert max_rel(got, want) <= 1e-6


def test_patterns_are_checked():
    x = torch.ones(2, 3)
    with pytest.raises(AssertionError):
        einsum_f32acc("ij,jk->i", x, x.t())      # k is in no other place
    with pytest.raises(AssertionError):
        einsum_f32acc("ij,kj->i", x, x)          # k: a sum-only index


def _mha_pair(width=32, heads=4, seed=5):
    tm = tclip.MHA(width, heads, torch.bfloat16, device="cpu")
    rng = np.random.default_rng(seed)
    # zero biases: flax's Dense rounds the product before adding its bias,
    # F.linear adds it first, which would hide the backward under that
    # forward difference
    sd = {k: torch.tensor(_bf16(rng.standard_normal(tuple(v.shape))
                                * (0.0 if v.dim() == 1 else width ** -0.5)))
          for k, v in tm.state_dict().items()}
    tm.load_state_dict(sd)
    params = _mha_to_jax({f"attn.{k}": v for k, v in sd.items()}, "attn")
    params = jax.tree.map(lambda t: jnp.asarray(t, jnp.bfloat16), params)
    return tm, jclip.MHA(width, heads, jnp.bfloat16), params


def _mha_grads(causal: bool):
    """(port, JAX): {name: float64 array} of the output and the gradients
    of x and of each projection's kernel and bias (JAX's tree names)."""
    tm, jm, params = _mha_pair()
    rng = np.random.default_rng(11)
    x = _bf16(rng.standard_normal((2, 10, 32)))
    g = rng.standard_normal((2, 10, 32)).astype(np.float32)
    mask = (np.triu(np.full((10, 10), -np.inf, np.float32), 1)
            if causal else None)

    def jfn(p, xx):
        return jm.apply({"params": p}, xx,
                        None if mask is None else jnp.asarray(mask))

    jout, vjp = jax.vjp(jfn, params, jnp.asarray(x, jnp.bfloat16))
    jgp, jgx = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.tensor(x).bfloat16().requires_grad_()
    out = tm(tx, None if mask is None else torch.tensor(mask))
    out.backward(torch.tensor(g).bfloat16())
    tgp = _mha_to_jax({"attn." + n: p.grad for n, p in tm.named_parameters()},
                      "attn")

    def f64(t):
        return np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)

    port = {"out": out.detach().double().numpy(),
            "x": tx.grad.double().numpy()}
    want = {"out": f64(jout), "x": f64(jgx)}
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        for leaf in ("kernel", "bias"):
            port[f"{n}.{leaf}"] = np.asarray(tgp[n][leaf], np.float64)
            want[f"{n}.{leaf}"] = f64(jgp[n][leaf])
    return port, want


@pytest.mark.parametrize("causal", [False, True])
def test_mha_bf16_gradients_match_jax(causal):
    port, want = _mha_grads(causal)
    for name in port:
        got, ref = port[name], want[name]
        if name == "k_proj.bias":               # zero but for rounding
            continue
        if name.endswith("bias"):                # bf16 sums over the rows
            assert max_rel(got, ref) <= 2.0 ** -6, name
            assert min_cosine(got.reshape(1, -1), ref.reshape(1, -1)) \
                >= 0.9999, name
        else:
            assert (got == ref).mean() >= 0.99, name
            assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max(), \
                name


def test_mha_with_the_old_form_differs(monkeypatch):
    monkeypatch.setattr(tclip, "einsum_f32acc", lambda p, a, b: torch.einsum(
        p, a.float(), b.float()))
    port, want = _mha_grads(causal=False)
    assert (port["out"] == want["out"]).mean() >= 0.99
    for name in ("x", "q_proj.kernel", "k_proj.kernel"):
        assert (port[name] != want[name]).mean() > 0.2, name

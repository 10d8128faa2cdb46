"""The port's flash attention (ops/flash_attention.py) against the JAX
package's: on CPU tensors the port runs its plain version, the JAX side
its Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances: f32 rtol 2e-4 / atol 2e-5, those of the JAX package's own
flash test.  bf16 2e-2 absolute: the Pallas kernel rounds P to bf16
before normalising and the plain version after, so the two differ by
about one bf16 step of outputs under 2 in magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_modal_video_engine_tpu.ops.flash_attention as jfa
from cross_modal_video_engine_tpu_torch.ops import flash_attention as tfa
from torch_parity import interpret_pallas, to_np


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _inputs(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d))]


def _close(got, want, dtype):
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


CASES = {
    "ragged S, non-causal": (2, 2, 200, 200, 64, False),
    "causal, head dim 16": (1, 2, 150, 150, 16, True),
    "Sq < Skv, causal top-left": (1, 2, 40, 150, 64, True),
    "Sq < Skv, non-causal": (1, 2, 40, 150, 16, False),
    "Sq > Skv, causal": (1, 1, 150, 40, 64, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_matches_jax(case, dtype):
    b, h, sq, skv, d, causal = CASES[case]
    q, k, v = _inputs(len(case), b, h, sq, skv, d)
    scale = 1.0 / np.sqrt(d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jfa.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                               scale, causal)
    got = tfa.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)), scale, causal)
    assert got.dtype == tdt
    _close(to_np(got), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_flash_matches_jax(causal, dtype):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 70, 64)).astype(np.float32)
               for _ in range(3))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jfa.mha_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)), 4,
                         causal=causal)
    got = tfa.mha_flash(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                        4, causal=causal)
    _close(to_np(got), np.asarray(want, np.float32), dtype)


def test_plain_version_against_float64():
    """The plain version alone against a float64 softmax, with a masked
    diagonal band (causal top-left, Sq > Skv)."""
    q, k, v = _inputs(3, 1, 2, 33, 20, 16)
    got = to_np(tfa._reference_attention(*map(torch.from_numpy, (q, k, v)),
                                         0.25, True))
    s = np.einsum("bhqd,bhkd->bhqk", q, k).astype(np.float64) * 0.25
    s = np.where(np.tril(np.ones((33, 20), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_kernel_operands_take_attention_views_without_copy():
    """MHA's q/k/v are (B, H, S, D) transposes of (B, S, H·D) rows: the
    kernel reads them in place, and writes a (B, H, S, D) view of
    (B, S, H, D) memory, so the head merge is a view."""
    x = torch.zeros(2, 37, 3 * 4 * 16)
    q, k, v = (t.reshape(2, 37, 4, 16).transpose(1, 2)
               for t in x.split(64, -1))
    q2, k2, v2, out, strides = tfa._kernel_operands(q, k, v)
    assert (q2.data_ptr(), k2.data_ptr(), v2.data_ptr()) == (
        q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert strides[:9] == [37 * 192, 16, 192] * 3
    assert out.shape == (2, 4, 37, 16) and strides[9:] == [37 * 64, 16, 64]
    assert out.transpose(1, 2).reshape(2, 37, 64).data_ptr() \
        == out.data_ptr()


def test_kernel_operands_copy_what_the_kernel_cannot_read():
    base = torch.zeros(1, 2, 9, 33)
    odd = base[..., 1:17]                   # row starts off 16 bytes
    tdim = torch.zeros(1, 2, 16, 9).transpose(2, 3)   # strided head dim
    q2, k2, v2, _, strides = tfa._kernel_operands(odd, tdim, tdim)
    for t in (q2, k2, v2):
        assert t.is_contiguous()
    assert strides[2] == 16 and strides[5] == 16


def test_dispatch_contract():
    q = torch.zeros(1, 2, 8, 16)
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, q, q, block_q=128, block_k=256)
    assert out.shape == q.shape
    assert tfa.flash_attention.launches == before     # plain version
    with pytest.raises(ValueError, match="device"):
        tfa.flash_attention(*(q.to("meta"),) * 3)
    with pytest.raises(ValueError, match="differ"):
        tfa.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q[..., :8], q)

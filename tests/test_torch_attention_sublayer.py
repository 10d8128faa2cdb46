"""The port's fused sublayers (cross_modal_video_engine_tpu_torch
ops/attention_sublayer.py) against the JAX package's Pallas kernels on
the same numpy inputs.  On the CPU the port runs its plain versions and
the JAX functions select the Pallas interpreter, so this pins the plain
versions to the kernels' rounding points.

Tolerances: f32 1e-4 absolute (the two sides sum in different orders;
at these widths that moves the fourth decimal at most).  bf16 3e-2
absolute (outputs stay below 4 in magnitude, where one bf16 step is at
most 1.6e-2; a one-step flip of an intermediate rounding may reach the
output)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cross_modal_video_engine_tpu.ops.attention_sublayer as jasl
import cross_modal_video_engine_tpu_torch.ops.attention_sublayer as tasl

@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found for the other test files
    this worker runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _attn_weights(rng, d):
    """JAX-layout (in, out) weights in f32."""
    w = {"lns": 1 + 0.1 * rng.standard_normal(d),
         "lnb": 0.1 * rng.standard_normal(d)}
    for n in ("q", "k", "v", "o"):
        w[f"w{n}"] = rng.standard_normal((d, d)) * d ** -0.5
        w[f"b{n}"] = 0.02 * rng.standard_normal(d)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _mlp_weights(rng, d):
    w = {"lns": 1 + 0.1 * rng.standard_normal(d),
         "lnb": 0.1 * rng.standard_normal(d),
         "w1": rng.standard_normal((d, 4 * d)) * d ** -0.5,
         "b1": 0.02 * rng.standard_normal(4 * d),
         "w2": rng.standard_normal((4 * d, d)) * (4 * d) ** -0.5,
         "b2": 0.02 * rng.standard_normal(d)}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _jax_args(w, names):
    return [jnp.asarray(w[n]) for n in names]


def _torch_args(w, names):
    """Matrices go to torch Linear layout (out, in)."""
    return [torch.from_numpy(np.ascontiguousarray(w[n].T if w[n].ndim == 2
                                                  else w[n]))
            for n in names]


ATTN = ("lns", "lnb", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
MLP = ("lns", "lnb", "w1", "b1", "w2", "b2")


def _inputs(rng, shape, dtype):
    x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_compact_matches_jax(causal, dtype):
    rng = np.random.default_rng(1)
    b, l, d, h = 8, 10, 48, 4
    w = _attn_weights(rng, d)
    jx, tx = _inputs(rng, (b * l, d), dtype)
    want = jasl.fused_attention_sublayer_compact(
        jx, *_jax_args(w, ATTN), heads=h, seq_len=l,
        g=jasl._compact_chunk(b, l), causal=causal)
    got = tasl.fused_attention_sublayer_compact(
        tx, *_torch_args(w, ATTN), heads=h, seq_len=l, causal=causal)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_rank3_padded_matches_jax(causal, dtype):
    """valid_len < LP: rows below valid_len agree, pad rows (queries over
    the valid keys) stay finite."""
    rng = np.random.default_rng(2)
    b, lp, valid, d, h = 3, 16, 11, 40, 4
    w = _attn_weights(rng, d)
    jx, tx = _inputs(rng, (b, lp, d), dtype)
    want = jasl.fused_attention_sublayer(
        jx, *_jax_args(w, ATTN), heads=h, valid_len=valid, causal=causal)
    got = tasl.fused_attention_sublayer(
        tx, *_torch_args(w, ATTN), heads=h, valid_len=valid, causal=causal)
    np.testing.assert_allclose(_np(got)[:, :valid], _np(want)[:, :valid],
                               rtol=0, atol=TOL[dtype])
    assert np.isfinite(_np(got)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(40, 48), (3, 17, 48)])
def test_mlp_matches_jax(shape, dtype):
    rng = np.random.default_rng(3)
    w = _mlp_weights(rng, shape[-1])
    jx, tx = _inputs(rng, shape, dtype)
    want = jasl.fused_mlp_sublayer(jx, *_jax_args(w, MLP))
    got = tasl.fused_mlp_sublayer(tx, *_torch_args(w, MLP))
    assert got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])


def test_compact_rejects_nondividing_seq_len():
    x = torch.zeros(25, 16)
    w, b = torch.zeros(16, 16), torch.zeros(16)
    with pytest.raises(ValueError, match="divide"):
        tasl.fused_attention_sublayer_compact(
            x, torch.ones(16), b, w, b, w, b, w, b, w, b, heads=2,
            seq_len=10)


def test_cpu_runs_plain_versions_and_counts_no_launch():
    """A CPU tensor goes to the plain version: no kernel, no count; a
    device with no kernel raises instead of falling back."""
    rng = np.random.default_rng(4)
    w = _mlp_weights(rng, 16)
    x = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    before = tasl.fused_mlp_sublayer.launches
    got = tasl.fused_mlp_sublayer(x, *_torch_args(w, MLP))
    want = tasl._mlp_ref(x, *_torch_args(w, MLP))
    assert torch.equal(got, want)
    assert tasl.fused_mlp_sublayer.launches == before
    with pytest.raises(ValueError, match="no sublayer kernel"):
        tasl.fused_mlp_sublayer(x.to("meta"), *[t.to("meta") for t in
                                                _torch_args(w, MLP)])

"""The port's whole-block sublayer (ops/attention_sublayer.py::
fused_block_sublayer_compact) against the JAX package's Pallas kernel on
the same numpy inputs.  On the CPU the port runs its plain version
(`_block_ref_flat`) and the JAX function runs the Pallas interpreter, so
this pins the plain version, which the CUDA kernel is held against on the
card, to the TPU kernel's rounding points.

Tolerances are the JAX test's own (tests/test_attention_sublayer.py::
test_block_parity): f32 2e-5, bf16 0.08, absolute and relative (inputs
drawn N(0, 1), so bf16 outputs reach a few units, where one bf16 step is
up to 3.1e-2)."""

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


B, L, D, H = 16, 10, 64, 4
NAMES = ("ln1s", "ln1b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
         "ln2s", "ln2b", "w1", "b1", "w2", "b2")
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.08)}


def _weights(rng, d=D, dh=None):
    """JAX-layout (in, out) weights in f32, at the JAX test's scales."""
    dh = dh or 4 * d
    w = {"ln1s": 1 + 0.1 * rng.standard_normal(d),
         "ln1b": 0.1 * rng.standard_normal(d),
         "ln2s": 1 + 0.1 * rng.standard_normal(d),
         "ln2b": 0.1 * rng.standard_normal(d),
         "w1": 0.05 * rng.standard_normal((d, dh)),
         "b1": 0.01 * rng.standard_normal(dh),
         "w2": 0.05 * rng.standard_normal((dh, d)),
         "b2": 0.01 * rng.standard_normal(d)}
    for n in "qkvo":
        w[f"w{n}"] = 0.05 * rng.standard_normal((d, d))
        w[f"b{n}"] = 0.01 * rng.standard_normal(d)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _jax_args(w):
    return [jnp.asarray(w[n]) for n in NAMES]


def _torch_args(w):
    """Matrices go to torch Linear layout (out, in)."""
    return [torch.from_numpy(np.ascontiguousarray(
        w[n].T if w[n].ndim == 2 else w[n])) for n in NAMES]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_block_matches_jax(causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B * L, D)).astype(np.float32)
    w = _weights(rng)
    want = jasl.fused_block_sublayer_compact(
        jnp.asarray(x, jdt), *_jax_args(w), heads=H, seq_len=L,
        g=jasl._compact_chunk(B, L, max_rows=80), causal=causal,
        interpret=True)
    got = tasl.fused_block_sublayer_compact(
        torch.from_numpy(x).to(tdt), *_torch_args(w), heads=H, seq_len=L,
        causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (B * L, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
def test_block_equals_the_ports_two_sublayer_chain(causal, dtype):
    """Its contract: the compact attention sublayer, then the MLP
    sublayer, with y1 in x.dtype between them.  On the CPU both are the
    plain versions, so the two are equal bit for bit."""
    tdt = DTYPES[dtype][1]
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((B * L, D)).astype(np.float32)
                         ).to(tdt)
    p = _torch_args(_weights(rng))
    y1 = tasl.fused_attention_sublayer_compact(x, *p[:10], heads=H,
                                               seq_len=L, causal=causal)
    assert y1.dtype == tdt
    want = tasl.fused_mlp_sublayer(y1, *p[10:])
    before = tasl.fused_block_sublayer_compact.launches
    got = tasl.fused_block_sublayer_compact(x, *p, heads=H, seq_len=L,
                                            causal=causal)
    assert torch.equal(got, want)
    assert tasl.fused_block_sublayer_compact.launches == before   # CPU


def test_block_hidden_width_need_not_be_four_times_the_width():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((4 * L, D)).astype(np.float32)
    w = _weights(rng, dh=320)
    want = jasl.fused_block_sublayer_compact(
        jnp.asarray(x), *_jax_args(w), heads=H, seq_len=L, g=4,
        interpret=True)
    got = tasl.fused_block_sublayer_compact(
        torch.from_numpy(x), *_torch_args(w), heads=H, seq_len=L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("kwargs,match", [
    (dict(heads=H, seq_len=7), "seq_len"),        # does not divide 160 rows
    (dict(heads=H, seq_len=80), "seq_len"),       # above 64
    (dict(heads=8, seq_len=L), "head dims"),      # head dim 8
    (dict(heads=3, seq_len=L), "head dims"),      # heads do not divide D
])
def test_block_refuses_shapes_the_kernel_does_not_take(kwargs, match):
    rng = np.random.default_rng(24)
    x = torch.zeros(B * L, D)
    with pytest.raises(ValueError, match=match):
        tasl.fused_block_sublayer_compact(x, *_torch_args(_weights(rng)),
                                          **kwargs)


@pytest.mark.parametrize("d,dh,match", [(96, 384, "widths"),
                                        (832, 3328, "widths"),
                                        (64, 200, "hidden")])
def test_block_refuses_widths_the_kernel_does_not_take(d, dh, match):
    rng = np.random.default_rng(25)
    x = torch.zeros(2 * L, d)
    with pytest.raises(ValueError, match=match):
        tasl.fused_block_sublayer_compact(
            x, *_torch_args(_weights(rng, d, dh)), heads=d // 32, seq_len=L)


def test_block_raises_on_a_device_without_a_kernel():
    rng = np.random.default_rng(26)
    p = [t.to("meta") for t in _torch_args(_weights(rng))]
    with pytest.raises(ValueError, match="no sublayer kernel"):
        tasl.fused_block_sublayer_compact(torch.zeros(B * L, D).to("meta"),
                                          *p, heads=H, seq_len=L)


WGMMA_SHAPES = [(192, 64), (384, 64), (576, 64), (768, 64)]
MMA_SHAPES = [(64, 16), (64, 32), (64, 64), (128, 16), (256, 32), (256, 64),
              (512, 32), (512, 64), (768, 16), (768, 32), (768, 48)]


@pytest.mark.parametrize("width,head_dim", WGMMA_SHAPES + MMA_SHAPES)
@pytest.mark.parametrize("seq_len", [1, 50, 64])
def test_block_path_routing(width, head_dim, seq_len):
    """csrc/block_sublayer.cu's route by dtype and shape alone: wgmma where
    every 192-column output quarter is whole and a head's q|k|v fills one
    192-row slot, mma.sync for the other bf16 shapes, CUDA cores for f32;
    the hidden width plays no part."""
    want = "wgmma" if (width, head_dim) in WGMMA_SHAPES else "mma"
    for hidden in (64, 320, 4 * width):
        assert tasl.block_path(torch.bfloat16, width, head_dim, hidden,
                               seq_len) == want
        assert tasl.block_path(torch.float32, width, head_dim, hidden,
                               seq_len) == "fma"


@pytest.mark.parametrize("args,exc,match", [
    ((torch.float16, 768, 64, 3072, 50), TypeError, "float32 or bfloat16"),
    ((torch.bfloat16, 768, 64, 3072, 0), ValueError, "seq_len"),
    ((torch.bfloat16, 768, 64, 3072, 65), ValueError, "seq_len"),
    ((torch.bfloat16, 96, 32, 384, 10), ValueError, "widths"),
    ((torch.bfloat16, 832, 64, 3328, 10), ValueError, "widths"),
    ((torch.bfloat16, 768, 96, 3072, 10), ValueError, "head dims"),
    ((torch.bfloat16, 768, 24, 3072, 10), ValueError, "head dims"),
    ((torch.bfloat16, 320, 48, 1280, 10), ValueError, "head dims"),
    ((torch.bfloat16, 768, 64, 3000, 10), ValueError, "hidden"),
    ((torch.bfloat16, 768, 64, 0, 10), ValueError, "hidden")])
def test_block_path_refuses(args, exc, match):
    with pytest.raises(exc, match=match):
        tasl.block_path(*args)

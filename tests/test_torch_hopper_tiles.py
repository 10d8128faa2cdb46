"""The contracts of the two kernels redesigned for Hopper, pinned on the CPU
at the edges of their new tiles (128 queries x 128 keys in
csrc/flash_attention.cu's wgmma path, 128-row output tiles 128 or 256
columns wide in csrc/gemm.cu).

The kernels themselves run only on the card (tests/
test_torch_kernels_cuda.py, chip_smoke.py).  Here the port's plain
versions, which the card tests hold the kernels against, go against the
JAX package's Pallas kernels in interpret mode on the same numpy inputs;
and what surrounds the kernels in Python is tested directly: which path
serves which dtype and head dim, and the strides handed to the TMA
tensor maps.

Tolerances, as in test_torch_flash_attention.py and
test_torch_attention_sublayer.py: flash f32 rtol 2e-4 / atol 2e-5
(summation order), bf16 2e-2 absolute (P is rounded before normalising on
one side and after on the other: one bf16 step of outputs under 2); MLP
f32 1e-4, bf16 3e-2 absolute (one bf16 step of outputs under 4, which a
flipped intermediate rounding may reach)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_modal_video_engine_tpu.ops.attention_sublayer as jasl
import cross_modal_video_engine_tpu.ops.flash_attention as jfa
from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as tasl
from cross_modal_video_engine_tpu_torch.ops import flash_attention as tfa
from torch_parity import interpret_pallas, to_np

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


# -- flash attention at the 128-wide tile edges -------------------------------

# (Sq, Skv, head dim, causal): one below, at and one above a tile; two
# tiles and one row; Sq != Skv both ways under the top-left causal mask
FLASH_EDGES = [
    (127, 127, 64, False), (127, 127, 128, True),
    (128, 128, 64, True), (128, 128, 128, False),
    (129, 129, 64, False), (129, 129, 128, True),
    (257, 257, 64, True), (257, 257, 64, False),
    (129, 257, 64, True), (128, 129, 128, False),
    (257, 127, 128, True), (257, 128, 64, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,d,causal", FLASH_EDGES)
def test_flash_tile_edges_match_jax(sq, skv, d, causal, dtype):
    rng = np.random.default_rng(1000 * sq + skv + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 2, sq, d), (1, 2, skv, d), (1, 2, skv, d)))
    jdt, tdt = DTYPES[dtype]
    scale = 1.0 / np.sqrt(d)
    want = jfa.flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                               scale, causal)
    got = tfa.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)), scale, causal)
    got, want = to_np(got), np.asarray(want, np.float32)
    assert got.shape == (1, 2, sq, d) and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_negative_scale_is_a_negated_query():
    """The kernel takes sm_scale >= 0 and the wrapper moves a negative
    sign into q: the same scores exactly, since negation is exact."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 33, 16))
                                .astype(np.float32)) for _ in range(3))
    assert torch.equal(tfa._reference_attention(q, k, v, -0.3, True),
                       tfa._reference_attention(-q, k, v, 0.3, True))


# -- which path serves what ---------------------------------------------------

@pytest.mark.parametrize("d", [16, 32, 48, 64, 80, 96, 112, 128])
def test_kernel_path_routing(d):
    assert tfa.kernel_path(torch.float32, d) == "fma"
    want = "wgmma" if d in (64, 128) else "mma.sync"
    assert tfa.kernel_path(torch.bfloat16, d) == want


@pytest.mark.parametrize("d", [0, 8, 24, 72, 136, 144, 256])
def test_kernel_path_refuses_head_dims(d):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dims"):
            tfa.kernel_path(dtype, d)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_kernel_path_refuses_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.kernel_path(dtype, 64)


# -- the strides a 4-D tensor map takes ---------------------------------------

def _map_ok(t):
    """What cuTensorMapEncodeTiled asks of a (B, H, S, D) view read as the
    map (D, H, S, B): a contiguous head dim, a 16-byte aligned base, and
    positive strides that are multiples of 16 bytes."""
    size = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and (s * size) % 16 == 0 for s in t.stride()[:3]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,hd", [(12, 64), (8, 128), (4, 16)])
def test_mha_views_are_tensor_map_operands(heads, hd, dtype):
    """What mha_flash hands the kernel, from one (B, S, 3·H·D) projection
    and from three separate ones: read in place, no copy."""
    b, s, dm = 2, 37, heads * hd
    fused = torch.zeros(b, s, 3 * dm, dtype=dtype)
    separate = [torch.zeros(b, s, dm, dtype=dtype) for _ in range(3)]
    for parts in (fused.split(dm, -1), separate):
        views = [t.reshape(b, s, heads, hd).transpose(1, 2) for t in parts]
        q, k, v, out, strides = tfa._kernel_operands(*views)
        for got, given in zip((q, k, v), views):
            assert got.data_ptr() == given.data_ptr() and _map_ok(got)
        assert _map_ok(out) and out.shape == (b, heads, s, hd)
        assert strides == [t.stride(i) for t in (q, k, v, out)
                           for i in range(3)]


def test_operands_a_tensor_map_cannot_take_are_copied():
    base = torch.zeros(1, 2, 9, 36, dtype=torch.bfloat16)
    odd_rows = base[..., :32]                  # rows of 72 bytes
    off_base = base.flatten()[4:4 + 2 * 9 * 32].reshape(1, 2, 9, 32)
    spread = torch.zeros(1, 1, 9, 32, dtype=torch.bfloat16).expand(1, 2, 9, 32)
    for t in (odd_rows, off_base, spread):
        assert not _map_ok(t)
        q, k, v, _, _ = tfa._kernel_operands(t, t, t)
        assert _map_ok(q) and _map_ok(k) and _map_ok(v)
        assert torch.equal(q, t)


# -- the MLP sublayer and its GEMM at the 128-row tile edges ------------------

def _mlp_weights(rng, d, hidden):
    w = {"lns": 1 + 0.1 * rng.standard_normal(d),
         "lnb": 0.1 * rng.standard_normal(d),
         "w1": rng.standard_normal((d, hidden)) * d ** -0.5,
         "b1": 0.02 * rng.standard_normal(hidden),
         "w2": rng.standard_normal((hidden, d)) * hidden ** -0.5,
         "b2": 0.02 * rng.standard_normal(d)}
    return {k: v.astype(np.float32) for k, v in w.items()}


MLP = ("lns", "lnb", "w1", "b1", "w2", "b2")


def _torch_args(w):
    """Matrices go to torch Linear layout (out, in)."""
    return [torch.from_numpy(np.ascontiguousarray(
        w[n].T if w[n].ndim == 2 else w[n])) for n in MLP]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [127, 129, 300])
def test_mlp_tile_edges_match_jax(rows, dtype):
    """Rows around one and two 128-row tiles; a hidden width (160) that is
    no multiple of the 128- or 256-column tile."""
    rng = np.random.default_rng(rows)
    d, hidden = 40, 160
    w = _mlp_weights(rng, d, hidden)
    x = (0.5 * rng.standard_normal((rows, d))).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    want = jasl.fused_mlp_sublayer(jnp.asarray(x, jdt),
                                   *[jnp.asarray(w[n]) for n in MLP])
    got = tasl.fused_mlp_sublayer(torch.from_numpy(x).to(tdt),
                                  *_torch_args(w))
    assert got.shape == (rows, d) and got.dtype == tdt
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=0,
                               atol={"float32": 1e-4, "bfloat16": 3e-2}[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_plain_version_is_the_sublayers_arithmetic(dtype):
    """`_gemm_ref`, which the card tests hold csrc/gemm.cu against, chained
    as `fused_mlp_sublayer` chains its launches, is `_mlp_ref` bit for bit;
    with the bias epilogue and three products it is `_dense` three times."""
    rng = np.random.default_rng(9)
    d, hidden = 24, 72
    lns, lnb, w1, b1, w2, b2 = _torch_args(_mlp_weights(rng, d, hidden))
    x = torch.from_numpy((0.5 * rng.standard_normal((37, d)))
                         .astype(np.float32)).to(dtype)
    ln = tasl._ln_f32(x, lns.to(dtype), lnb.to(dtype), 1e-5)
    h = tasl._gemm_ref(ln, tasl._EPI_GELU, ((w1, b1),))[0]
    y = tasl._gemm_ref(h, tasl._EPI_RESID, ((w2, b2),), resid=x)[0]
    assert h.dtype == dtype and h.shape == (37, hidden)
    assert torch.equal(y, tasl._mlp_ref(x, lns, lnb, w1, b1, w2, b2))
    mats = [(w1, b1), (w1.flip(0), b1.flip(0)), (w1 * 0.5, b1)]
    outs = tasl._gemm_ref(ln, tasl._EPI_BIAS, mats)
    assert len(outs) == 3
    for (w, b), out in zip(mats, outs):
        assert torch.equal(out, tasl._dense(ln, w, b))

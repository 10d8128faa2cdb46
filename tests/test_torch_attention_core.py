"""The attention sublayers' contracts around csrc/attention_core.cu, pinned
on the CPU at the edges of the wgmma core's tiles (16-key steps, 64 query
rows a warpgroup, one warpgroup an item up to 64 rows and two above).

The kernels run only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).  Here: the plain version of one core launch
(`_attention_core_ref`) chained with `_gemm_ref` as the C entry chains the
kernels is the sublayers' plain version bit for bit; both public entries
go against the JAX package's Pallas kernels in interpret mode on the same
numpy inputs at every tile edge; and what surrounds the kernels in Python
is tested directly: which core kernel serves which call, what each
refuses, what `_prepare` copies, and that a sequence's output depends on
no other sequence's rows.

Tolerances: f32 1e-5 absolute (width 32: the two sides sum in different
orders, which moves the sixth decimal), bf16 3e-2 absolute (outputs stay
below 4 in magnitude, where one bf16 step is at most 1.6e-2; a one-step
flip of an intermediate rounding may reach the output)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_modal_video_engine_tpu.ops.attention_sublayer as jasl
from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as tasl
from torch_parity import interpret_pallas, to_np

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# one key, half a 16-key step and one past it, the vision tower's 50, the
# ends of the 64-row tile, the text tower's 77, its padded 80, the limit
LENGTHS = [1, 8, 9, 50, 56, 57, 64, 65, 77, 80, 128]
ATTN = ("lns", "lnb", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _weights(rng, d):
    """JAX-layout (in, out) weights in f32."""
    w = {"lns": 1 + 0.1 * rng.standard_normal(d),
         "lnb": 0.1 * rng.standard_normal(d)}
    for n in "qkvo":
        w[f"w{n}"] = rng.standard_normal((d, d)) * d ** -0.5
        w[f"b{n}"] = 0.02 * rng.standard_normal(d)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _torch_args(w):
    """Matrices go to torch Linear layout (out, in)."""
    return [torch.from_numpy(np.ascontiguousarray(
        w[n].T if w[n].ndim == 2 else w[n])) for n in ATTN]


def _x(rng, shape):
    return (0.5 * rng.standard_normal(shape)).astype(np.float32)


# -- (a) the chain of plain versions is the sublayer's plain version ----------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lp,valid", [(50, 50), (16, 11), (80, 77)])
def test_core_plain_version_is_the_sublayers_arithmetic(lp, valid, causal,
                                                        dtype):
    """LayerNorm -> `_gemm_ref` (q|k|v) -> `_attention_core_ref` ->
    `_gemm_ref` (residual), chained as `cmve_attention_sublayer` chains the
    kernels, equals `_attn_ref` (and `_attn_ref_flat` where there are no
    pad rows) bit for bit."""
    rng = np.random.default_rng(100 + lp)
    b, d, h = 3, 32, 4
    p = _torch_args(_weights(rng, d))
    lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo = p
    x = torch.from_numpy(_x(rng, (b, lp, d))).to(dtype)
    x2 = x.reshape(b * lp, d)
    ln = tasl._ln_f32(x2, lns.to(dtype), lnb.to(dtype), 1e-5)
    q, k, v = tasl._gemm_ref(ln, tasl._EPI_BIAS,
                             ((wq, bq), (wk, bk), (wv, bv)))
    att = tasl._attention_core_ref(q, k, v, heads=h, seq_stride=lp, rows=lp,
                                   valid_len=valid, causal=causal)
    y = tasl._gemm_ref(att, tasl._EPI_RESID, ((wo, bo),), resid=x2)[0]
    assert att.dtype == dtype and att.shape == (b * lp, d)
    want = tasl._attn_ref(x, *p, heads=h, valid_len=valid, causal=causal)
    assert torch.equal(y.reshape(b, lp, d), want)
    if valid == lp:
        assert torch.equal(y, tasl._attn_ref_flat(x2, *p, heads=h,
                                                  seq_len=lp, causal=causal))


def test_core_plain_version_leaves_rows_past_its_rows_zero():
    """seq_stride > rows: the rows between belong to nobody and come back
    as zeros, whatever they held."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_x(rng, (3 * 20, 16))) for _ in range(3))
    for t in (q, k, v):
        t.reshape(3, 20, 16)[:, 13:] = float("nan")
    kw = dict(heads=2, rows=13, valid_len=10, causal=False)
    out = tasl._attention_core_ref(q, k, v, seq_stride=20, **kw)
    out3 = out.reshape(3, 20, 16)
    assert (out3[:, 13:] == 0).all() and torch.isfinite(out).all()
    dense = tasl._attention_core_ref(
        *(t.reshape(3, 20, 16)[:, :13].reshape(39, 16) for t in (q, k, v)),
        seq_stride=13, **kw)
    assert torch.equal(out3[:, :13].reshape(39, 16), dense)


# -- (b) both public entries against the JAX kernels at the tile edges --------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
def test_compact_tile_edges_match_jax(length, causal, dtype):
    rng = np.random.default_rng(1000 + length)
    b, d, h = 2, 32, 2
    w = _weights(rng, d)
    x = _x(rng, (b * length, d))
    jdt, tdt = DTYPES[dtype]
    want = jasl.fused_attention_sublayer_compact(
        jnp.asarray(x, jdt), *[jnp.asarray(w[n]) for n in ATTN], heads=h,
        seq_len=length, g=jasl._compact_chunk(b, length) or b, causal=causal)
    got = tasl.fused_attention_sublayer_compact(
        torch.from_numpy(x).to(tdt), *_torch_args(w), heads=h,
        seq_len=length, causal=causal)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", LENGTHS)
def test_rank3_tile_edges_match_jax(length, causal, dtype):
    """valid_len = length inside LP = length rounded up to 8, plus 8 where
    that adds no pad row, so every case has pad rows: rows below valid_len
    agree, pad rows (queries over the valid keys) stay finite."""
    rng = np.random.default_rng(2000 + length)
    b, d, h = 2, 32, 2
    lp = -(-length // 8) * 8
    lp += 8 if lp == length else 0
    w = _weights(rng, d)
    x = _x(rng, (b, lp, d))
    jdt, tdt = DTYPES[dtype]
    want = jasl.fused_attention_sublayer(
        jnp.asarray(x, jdt), *[jnp.asarray(w[n]) for n in ATTN], heads=h,
        valid_len=length, causal=causal)
    got = tasl.fused_attention_sublayer(
        torch.from_numpy(x).to(tdt), *_torch_args(w), heads=h,
        valid_len=length, causal=causal)
    got, want = to_np(got), np.asarray(want, np.float32)
    assert got.shape == (b, lp, d) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :length], want[:, :length], rtol=0,
                               atol=TOL[dtype])


# -- (c) which core kernel serves what, and what each refuses -----------------

@pytest.mark.parametrize("keys", [1, 16, 50, 77, 128, 129, 200, 256])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_core_path_routing(head_dim, keys):
    if (head_dim, keys) == (128, 256):   # K and V as fp32 do not fit an SM
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(ValueError, match="shared memory"):
                tasl.core_path(dtype, head_dim, keys)
        return
    assert tasl.core_path(torch.float32, head_dim, keys) == "fma"
    want = "wgmma" if head_dim == 64 and keys <= 128 else "fma"
    assert tasl.core_path(torch.bfloat16, head_dim, keys) == want


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_core_path_refuses_dtypes(dtype):
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tasl.core_path(dtype, 64, 50)


@pytest.mark.parametrize("head_dim,keys", [(64, 0), (64, 257), (0, 50),
                                           (64, 1000)])
def test_core_path_refuses_key_counts_and_head_dims(head_dim, keys):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="valid_len"):
            tasl.core_path(dtype, head_dim, keys)


def test_core_path_refuses_what_shared_memory_cannot_hold():
    """The CUDA-core kernel keeps K and V of one head as fp32: 256 keys at
    head dim 128 are past an SM's shared memory; the wgmma path's shapes
    never come here."""
    with pytest.raises(ValueError, match="shared memory"):
        tasl.core_path(torch.float32, 128, 256)
    assert tasl.core_path(torch.float32, 64, 256) == "fma"
    assert tasl.core_path(torch.bfloat16, 64, 128) == "wgmma"


@pytest.mark.parametrize("heads,stride,rows,valid,match", [
    (3, 10, 10, 10, "heads"),          # 3 does not divide the width 32
    (2, 10, 11, 10, "rows"),           # rows past the stride
    (2, 7, 7, 7, "rows"),              # the stride does not divide 40 rows
    (2, 10, 8, 9, "valid_len"),        # keys that are no rows
    (2, 10, 0, 0, "rows"),
])
def test_core_launch_refuses_shapes(heads, stride, rows, valid, match):
    q = torch.zeros(40, 32)
    with pytest.raises(ValueError, match=match):
        tasl._check_core(q, heads, stride, rows, valid)


def test_core_launch_takes_the_main_path_shapes():
    for rows, d, heads, l in ((6400, 768, 12, 50), (616, 512, 8, 77)):
        q = torch.zeros(rows, d, dtype=torch.bfloat16, device="meta")
        assert tasl._check_core(q, heads, l, l, l) == 64
    q = torch.zeros(640, 512, dtype=torch.bfloat16, device="meta")
    assert tasl._check_core(q, 8, 80, 80, 77) == 64


# -- (d) what `_prepare` copies -----------------------------------------------

def test_prepare_returns_right_parameters_as_the_same_objects():
    """fp32 LayerNorm scale and bias (as the models keep them) and weights
    in x.dtype go through untouched; only what is wrong is made right."""
    rng = np.random.default_rng(11)
    p = _torch_args(_weights(rng, 32))
    p = p[:2] + [t.bfloat16() for t in p[2:]]
    x = torch.from_numpy(_x(rng, (20, 32))).bfloat16()
    xc, out = tasl._prepare(x, *p)
    assert xc is x and len(out) == len(p)
    assert all(a is b for a, b in zip(out, p))
    assert out[0].dtype == torch.float32 and out[2].dtype == torch.bfloat16
    # a float32 weight, a transposed weight and a strided x are made right
    wrong = list(p)
    wrong[2] = p[2].float()
    wrong[4] = p[4].t()
    xc, out = tasl._prepare(x.t().contiguous().t(), *wrong)
    assert xc.is_contiguous() and torch.equal(xc, x)
    assert out[2].dtype == torch.bfloat16 and torch.equal(out[2], p[2])
    assert out[4].is_contiguous() and torch.equal(out[4], p[4].t())
    assert all(a is b for i, (a, b) in enumerate(zip(out, wrong))
               if i not in (2, 4))
    # the whole-block kernel reads every parameter in x.dtype
    _, out = tasl._prepare(x, *p, ln=())
    assert out[0].dtype == torch.bfloat16 and out[2] is p[2]


def test_prepare_refuses_other_dtypes_and_devices():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tasl._prepare(x.half())
    with pytest.raises(ValueError, match="parameter on"):
        tasl._prepare(x, torch.zeros(8, device="meta"))


@pytest.mark.parametrize("rank3", [False, True])
def test_fp32_layernorm_parameters_equal_cast_ones(rank3):
    """The kernel reads fp32 scale and bias and rounds them to x.dtype;
    the plain versions round them the same way, so handing them in already
    cast changes nothing."""
    rng = np.random.default_rng(12)
    p = _torch_args(_weights(rng, 32))
    cast = [t.bfloat16() for t in p[:2]] + p[2:]
    x = torch.from_numpy(_x(rng, (4, 16, 32))).bfloat16()
    if rank3:
        kw = dict(heads=2, valid_len=11, causal=True)
        a = tasl.fused_attention_sublayer(x, *p, **kw)
        b = tasl.fused_attention_sublayer(x, *cast, **kw)
    else:
        kw = dict(heads=2, seq_len=16)
        a = tasl.fused_attention_sublayer_compact(x.reshape(64, 32), *p, **kw)
        b = tasl.fused_attention_sublayer_compact(x.reshape(64, 32), *cast,
                                                  **kw)
    assert torch.equal(a, b)
    mlp = [p[0], p[1], torch.from_numpy(_x(rng, (64, 32))), torch.zeros(64),
           torch.from_numpy(_x(rng, (32, 64))), torch.zeros(32)]
    assert torch.equal(tasl.fused_mlp_sublayer(x, *mlp),
                       tasl.fused_mlp_sublayer(x, *cast[:2], *mlp[2:]))


# -- (e) a sequence's output depends on no other sequence ---------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fill", [None, float("inf"), float("nan")])
def test_core_output_depends_on_its_own_sequence_only(fill, dtype):
    """Changing every row of sequence j (to other numbers, to inf, to NaN)
    leaves sequence i's output exactly equal; so does whatever lies in the
    pad rows of k and v past valid_len.  0 x inf would be NaN: no read may
    leave the sequence's valid keys."""
    rng = np.random.default_rng(13)
    nseq, stride, rows, valid, d = 3, 20, 16, 13, 32
    q, k, v = (torch.from_numpy(_x(rng, (nseq * stride, d))).to(dtype)
               for _ in range(3))
    kw = dict(heads=2, seq_stride=stride, rows=rows, valid_len=valid,
              causal=False)
    clean = tasl._attention_core_ref(q, k, v, **kw).reshape(nseq, stride, d)
    for t in (q, k, v):
        t3 = t.reshape(nseq, stride, d)
        for j in (0, 2):
            if fill is None:
                t3[j] = torch.from_numpy(_x(rng, (stride, d))).to(dtype)
            else:
                t3[j] = fill
    for t in (k, v):                  # pad keys and the rows nobody owns
        t.reshape(nseq, stride, d)[1, valid:] = 1.0 if fill is None else fill
    got = tasl._attention_core_ref(q, k, v, **kw).reshape(nseq, stride, d)
    assert torch.isfinite(got[1].float()).all()
    assert torch.equal(got[1], clean[1])

"""The CUDA kernels (the GEMM, sublayers, whole block, flash attention)
against their plain versions, on the card, and their gradients (kernel
forward, plain-version backward) against the plain versions' autograd;
first of all one tile through the TMA and wgmma helpers every Hopper path
is built from.

Skips without CUDA.  The repository's conftest imports jax, which the
machine with the card does not have, so run this file there with:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(chip_smoke.py makes the same checks at the main-path shapes.)  This file
imports neither jax nor the JAX package.

Tolerances: f32 1e-4 absolute (summation order only).  bf16 3e-2
absolute: outputs stay under 4 in magnitude, where one bf16 step is
1.6e-2, and a one-step flip of an intermediate rounding may reach them.
Flash attention takes q, k, v drawn N(0, 1) at the same tolerances,
except where a bf16 output reaches |x| >= 4 (causal first rows, which
average one or two rows of v): there one bf16 step is 3.1e-2, and the
bound is that one step.
"""

import pytest
import torch

from cross_modal_video_engine_tpu_torch.ops import _build
from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl
from cross_modal_video_engine_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA for sm_90a")
    return torch.device("cuda", 0)


def _randn(gen, dev, *shape, std=1.0):
    return torch.randn(*shape, generator=gen, device=dev) * std


def _attn_params(gen, dev, d):
    p = [1.0 + _randn(gen, dev, d, std=0.1), _randn(gen, dev, d, std=0.1)]
    for scale in (1.0, 1.0, 1.0, 0.5):
        p += [_randn(gen, dev, d, d, std=scale * d ** -0.5),
              _randn(gen, dev, d, std=0.02)]
    return p


def _mlp_params(gen, dev, d):
    return [1.0 + _randn(gen, dev, d, std=0.1), _randn(gen, dev, d, std=0.1),
            _randn(gen, dev, 4 * d, d, std=d ** -0.5),
            _randn(gen, dev, 4 * d, std=0.02),
            _randn(gen, dev, d, 4 * d, std=0.5 * (4 * d) ** -0.5),
            _randn(gen, dev, d, std=0.02)]


def _close(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_wgmma_tma_selfcheck(dev):
    """csrc/wgmma_selfcheck.cu: a 64 x 64 x 64 tile loaded by TMA (128-byte
    swizzle) on an mbarrier; a b^T by wgmma with both operands K-major from
    shared memory, then bf16(a b^T) v with the accumulators as the register
    operand and v as the transposed (MN-major) one.  fp32 sums of exact
    bf16 products: only the order of summation differs from torch."""
    gen = torch.Generator(device=dev).manual_seed(20)
    a, b, v = (_randn(gen, dev, 64, 64).to(torch.bfloat16) for _ in range(3))
    d1, d2 = torch.empty(64, 64, device=dev), torch.empty(64, 64, device=dev)
    err = _build.load_kernels().lib.cmve_wgmma_selfcheck(
        a.data_ptr(), b.data_ptr(), v.data_ptr(), d1.data_ptr(),
        d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want1 = a.float() @ b.float().t()
    want2 = want1.to(torch.bfloat16).float() @ v.float()
    assert (d1 - want1).abs().max().item() <= 1e-4
    assert ((d2 - want2).abs().max() / want2.abs().max()).item() <= 1e-5


def test_wgmma_tma_selfcheck_key_tile(dev):
    """The forms csrc/attention_core.cu adds: a 3-D tensor map (channels,
    rows of one sequence bounded at 77, sequences) with a box of 80 rows,
    a 64 x 80 product, five 16-key steps of the register-operand product.
    Everything behind the bound (rows 77-79 of the sequence read, all of
    the other sequence) is inf: the hardware's zero fill must keep it out."""
    gen = torch.Generator(device=dev).manual_seed(22)
    a = _randn(gen, dev, 64, 64).to(torch.bfloat16)
    k, v = (torch.full((2, 80, 64), float("inf"), device=dev,
                       dtype=torch.bfloat16) for _ in range(2))
    k[1, :77] = _randn(gen, dev, 77, 64).to(torch.bfloat16)
    v[1, :77] = _randn(gen, dev, 77, 64).to(torch.bfloat16)
    d1, d2 = torch.empty(64, 80, device=dev), torch.empty(64, 64, device=dev)
    err = _build.load_kernels().lib.cmve_wgmma_selfcheck_keys(
        a.data_ptr(), k.data_ptr(), v.data_ptr(), d1.data_ptr(),
        d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want1 = torch.zeros(64, 80, device=dev)
    want1[:, :77] = a.float() @ k[1, :77].float().t()
    want2 = want1[:, :77].to(torch.bfloat16).float() @ v[1, :77].float()
    assert torch.isfinite(d1).all() and torch.isfinite(d2).all()
    assert (d1 - want1).abs().max().item() <= 1e-4
    assert ((d2 - want2).abs().max() / want2.abs().max()).item() <= 1e-5


# csrc/gemm.cu by itself: (M, K, N); ragged against the 128-row tiles, the
# 128- and 256-column tiles and the 64-deep k-tiles, and the sublayers' own
GEMM_SHAPES = [(6400, 768, 3072), (6400, 3072, 768), (616, 512, 512),
               (300, 2048, 512), (300, 768, 40), (129, 40, 264), (5, 8, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nmat", [1, 3])
@pytest.mark.parametrize("epi", ["bias", "gelu", "residual"])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_kernel(dev, m, k, n, epi, nmat, dtype):
    gen = torch.Generator(device=dev).manual_seed(21)
    code = {"bias": asl._EPI_BIAS, "gelu": asl._EPI_GELU,
            "residual": asl._EPI_RESID}[epi]
    a = _randn(gen, dev, m, k, std=0.5).to(dtype)
    mats = [(_randn(gen, dev, n, k, std=k ** -0.5).to(dtype),
             _randn(gen, dev, n, std=0.02).to(dtype)) for _ in range(nmat)]
    resid = _randn(gen, dev, m, n, std=0.5).to(dtype) \
        if epi == "residual" else None
    got = asl._gemm(a, code, mats, resid)
    want = asl._gemm_ref(a, code, mats, resid)
    torch.cuda.synchronize()
    assert len(got) == nmat
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq_len,d,heads", [(50, 768, 12), (10, 128, 2),
                                             (10, 64, 4)])
def test_compact_kernel(dev, dtype, causal, seq_len, d, heads):
    gen = torch.Generator(device=dev).manual_seed(0)
    p = _attn_params(gen, dev, d)
    x = (_randn(gen, dev, 7 * seq_len, d, std=0.5)).to(dtype)
    before = asl.fused_attention_sublayer_compact.launches
    with torch.no_grad():
        got = asl.fused_attention_sublayer_compact(
            x, *p, heads=heads, seq_len=seq_len, causal=causal)
        want = asl._attn_ref_flat(x, *p, heads=heads, seq_len=seq_len,
                                  causal=causal)
    torch.cuda.synchronize()
    assert asl.fused_attention_sublayer_compact.launches == before + 1
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lp,valid,causal", [(77, 77, True), (80, 77, True),
                                             (80, 77, False)])
def test_rank3_kernel(dev, dtype, lp, valid, causal):
    gen = torch.Generator(device=dev).manual_seed(1)
    p = _attn_params(gen, dev, 512)
    x = (_randn(gen, dev, 3, lp, 512, std=0.5)).to(dtype)
    with torch.no_grad():
        got = asl.fused_attention_sublayer(x, *p, heads=8, valid_len=valid,
                                           causal=causal)
        want = asl._attn_ref(x, *p, heads=8, valid_len=valid, causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()        # pad rows included
    _close(got[:, :valid], want[:, :valid], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(300, 768), (2, 77, 512), (5, 40)])
def test_mlp_kernel(dev, dtype, shape):
    gen = torch.Generator(device=dev).manual_seed(2)
    p = _mlp_params(gen, dev, shape[-1])
    x = (_randn(gen, dev, *shape, std=0.5)).to(dtype)
    with torch.no_grad():
        got = asl.fused_mlp_sublayer(x, *p)
        want = asl._mlp_ref(x, *p)
    torch.cuda.synchronize()
    _close(got, want, dtype)


# -- the attention core by itself ---------------------------------------------

# the wgmma core's tiles: 16-key steps, 64 query rows a warpgroup, one
# warpgroup an item up to 64 rows and two above
CORE_LENGTHS = [1, 8, 9, 50, 56, 57, 64, 65, 77, 80, 128]


def _core_inputs(gen, dev, dtype, nseq, seq_stride, d):
    return [_randn(gen, dev, nseq * seq_stride, d).to(dtype)
            for _ in range(3)]


def _core_close(got, want, dtype, nseq, seq_stride, rows):
    d = got.shape[-1]
    got = got.reshape(nseq, seq_stride, d)[:, :rows]
    want = want.reshape(nseq, seq_stride, d)[:, :rows]
    _flash_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", CORE_LENGTHS)
def test_attention_core_compact_layout(dev, dtype, causal, length):
    """Flat rows, no pad rows: rows == valid_len == seq_stride; more items
    than one wave of blocks at the short lengths."""
    gen = torch.Generator(device=dev).manual_seed(30 + length)
    nseq, heads = (40, 12) if length <= 64 else (9, 8)
    q, k, v = _core_inputs(gen, dev, dtype, nseq, length, heads * 64)
    kw = dict(heads=heads, seq_stride=length, rows=length, valid_len=length,
              causal=causal)
    got = asl._attention_core(q, k, v, torch.empty_like(q), **kw)
    want = asl._attention_core_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _core_close(got, want, dtype, nseq, length, length)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("length", CORE_LENGTHS)
def test_attention_core_padded_strided_layout(dev, dtype, causal, length):
    """Rank-3 rows with pad rows (rows = valid_len rounded up to 16, pad
    rows pass as queries) inside a seq_stride larger than rows."""
    gen = torch.Generator(device=dev).manual_seed(60 + length)
    rows = -(-length // 16) * 16
    stride, nseq, heads = rows + 5, 7, 3
    q, k, v = _core_inputs(gen, dev, dtype, nseq, stride, heads * 64)
    kw = dict(heads=heads, seq_stride=stride, rows=rows, valid_len=length,
              causal=causal)
    got = asl._attention_core(q, k, v, torch.zeros_like(q), **kw)
    want = asl._attention_core_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _core_close(got, want, dtype, nseq, stride, rows)
    # rows past `rows` in a sequence are not the kernel's to write
    assert (got.reshape(nseq, stride, -1)[:, rows:] == 0).all()


@pytest.mark.parametrize("rows,valid", [(50, 50), (80, 77), (128, 100),
                                        (80, 50), (128, 16), (200, 100),
                                        (300, 7)])
def test_attention_core_reads_no_key_past_its_bound(dev, rows, valid):
    """inf in every row of the neighbour sequences, in the pad rows of k
    and v past valid_len and in the rows between `rows` and seq_stride
    reaches no valid output (0 x inf would be NaN): the wgmma core reads
    K and V through tensor maps bounded at valid_len."""
    gen = torch.Generator(device=dev).manual_seed(90 + rows)
    stride, heads = rows + 3, 4
    q, k, v = _core_inputs(gen, dev, torch.bfloat16, 3, stride, heads * 64)
    kw = dict(heads=heads, seq_stride=stride, rows=rows, valid_len=valid,
              causal=False)
    clean = asl._attention_core(q, k, v, torch.zeros_like(q), **kw)
    torch.cuda.synchronize()
    for t in (k, v):
        t3 = t.reshape(3, stride, -1)
        t3[0] = float("inf")
        t3[2] = float("inf")
        t3[1, valid:] = float("inf")
    got = asl._attention_core(q, k, v, torch.zeros_like(q), **kw)
    torch.cuda.synchronize()
    got1 = got.reshape(3, stride, -1)[1, :rows]
    assert torch.isfinite(got1.float()).all()
    assert torch.equal(got1, clean.reshape(3, stride, -1)[1, :rows])
    # and what it computed is right: two warpgroups on few keys too
    q3, k3, v3 = (t.reshape(3, stride, -1)[1].contiguous() for t in (q, k, v))
    want = asl._attention_core_ref(q3, k3, v3, **kw)
    _core_close(got1, want[:rows], torch.bfloat16, 1, rows, rows)


def test_attention_core_other_shapes_keep_the_cuda_core_kernel(dev):
    """bf16 at another head dim, and more than 128 keys."""
    gen = torch.Generator(device=dev).manual_seed(95)
    for heads, d, length in ((4, 128, 50), (2, 128, 200)):
        assert asl.core_path(torch.bfloat16, d // heads, length) == "fma"
        q, k, v = _core_inputs(gen, dev, torch.bfloat16, 5, length, d)
        kw = dict(heads=heads, seq_stride=length, rows=length,
                  valid_len=length, causal=True)
        got = asl._attention_core(q, k, v, torch.empty_like(q), **kw)
        want = asl._attention_core_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        _core_close(got, want, torch.bfloat16, 5, length, length)


# -- one host call per sublayer -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_call_sublayers_equal_the_step_by_step_path(dev, dtype):
    """cmve_attention_sublayer and cmve_mlp_sublayer enqueue the same
    kernels on the same inputs as the one-crossing-per-kernel path: equal
    bit for bit, with fp32 LayerNorm parameters and with cast ones."""
    gen = torch.Generator(device=dev).manual_seed(96)
    d, heads, length = 256, 4, 50
    x = _randn(gen, dev, 6 * length, d, std=0.5).to(dtype)
    for cast_ln in (False, True):
        xa, pa = asl._prepare(x, *_attn_params(gen, dev, d))
        xm, pm = asl._prepare(x, *_mlp_params(gen, dev, d))
        if cast_ln:
            pa[:2] = [t.to(dtype) for t in pa[:2]]
            pm[:2] = [t.to(dtype) for t in pm[:2]]
        kw = dict(heads=heads, seq_stride=length, rows=length,
                  valid_len=length, causal=True, eps=1e-5)
        one = asl._attn_cuda(xa, pa, **kw)
        steps = asl._attn_cuda_steps(xa, pa, **kw)
        torch.cuda.synchronize()
        assert torch.equal(one, steps)
        assert torch.equal(asl._mlp_cuda(xm, pm, eps=1e-5),
                           asl._mlp_cuda_steps(xm, pm, eps=1e-5))


def test_layernorm_kernel_rounds_fp32_parameters_itself(dev):
    """fp32 scale and bias read by the kernel give what casting them
    first gives: the same rounding point."""
    gen = torch.Generator(device=dev).manual_seed(97)
    x = _randn(gen, dev, 300, 512, std=0.5).to(torch.bfloat16)
    lns, lnb = 1.0 + _randn(gen, dev, 512, std=0.1), _randn(gen, dev, 512)
    got = asl._layernorm(x, lns, lnb, 1e-5)
    cast = asl._layernorm(x, lns.bfloat16(), lnb.bfloat16(), 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got, cast)
    _close(got, asl._ln_f32(x, lns.bfloat16(), lnb.bfloat16(), 1e-5),
           torch.bfloat16)


def test_weight_updated_in_place_changes_the_result(dev):
    """The weights' tensor maps are kept on the C side by address and
    shape; a map encodes no contents, so an in-place update is seen."""
    gen = torch.Generator(device=dev).manual_seed(98)
    d = 256
    p = _attn_params(gen, dev, d)
    p = p[:2] + [t.to(torch.bfloat16) for t in p[2:]]
    x = _randn(gen, dev, 100, d, std=0.5).to(torch.bfloat16)
    kw = dict(heads=4, seq_len=50)
    with torch.no_grad():
        first = asl.fused_attention_sublayer_compact(x, *p, **kw)
        p[8].mul_(-1.0)                       # the output projection
        p[2].copy_(_randn(gen, dev, d, d, std=d ** -0.5))
        second = asl.fused_attention_sublayer_compact(x, *p, **kw)
        want = asl._attn_ref_flat(x, *p, causal=False, **kw)
    torch.cuda.synchronize()
    assert not torch.equal(first, second)
    _close(second, want, torch.bfloat16)


def test_prepared_parameters_are_not_copied(dev):
    gen = torch.Generator(device=dev).manual_seed(99)
    p = _attn_params(gen, dev, 64)
    p = p[:2] + [t.to(torch.bfloat16) for t in p[2:]]
    x = _randn(gen, dev, 20, 64).to(torch.bfloat16)
    xc, out = asl._prepare(x, *p)
    assert xc is x and all(a is b for a, b in zip(out, p))
    assert out[0].dtype == torch.float32        # read as stored


def test_kernels_refuse_what_they_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    p = _mlp_params(gen, dev, 64)
    x = _randn(gen, dev, 4, 64)
    with pytest.raises(TypeError):
        asl.fused_mlp_sublayer(x.half(), *p)
    with pytest.raises(ValueError):
        asl.fused_mlp_sublayer(x, *[t.cpu() for t in p])
    with pytest.raises(ValueError, match="LayerNorm"):
        asl.fused_mlp_sublayer(x, p[0][:32], *p[1:])


def _flash_close(got, want, dtype):
    """_close, with one bf16 step of the plain output as the bound where
    that step exceeds the tolerance (|want| >= 4)."""
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    tol = torch.full_like(err, TOL[dtype])
    if dtype == torch.bfloat16:
        step = torch.ldexp(torch.ones_like(err), torch.frexp(want.float())[1] - 8)
        tol = torch.maximum(tol, step)
    assert (err <= tol).all(), err.max().item()


# chip_smoke.py's flash cases: (B, H, Sq, Skv, D, causal)
FLASH_CASES = {
    "joint 1569": (4, 12, 1569, 1569, 64, False),
    "space-only 197": (16 * 8, 12, 197, 197, 64, False),
    "causal 1000 hd128": (2, 8, 1000, 1000, 128, True),
    "causal 197 vs 1569": (4, 12, 197, 1569, 64, True),
    # the /caption route's waves of one and of eight videos
    "caption wave of 1 (1569)": (1, 12, 1569, 1569, 64, False),
    "caption wave of 8 (1569)": (8, 12, 1569, 1569, 64, False),
}


def _qkv(gen, dev, dtype, b, h, sq, skv, d):
    return [_randn(gen, dev, *s).to(dtype)
            for s in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel(dev, dtype, case):
    b, h, sq, skv, d, causal = FLASH_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = _qkv(gen, dev, dtype, b, h, sq, skv, d)
    before = fa.flash_attention.launches
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, d ** -0.5, causal)
        want = fa._reference_attention(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _flash_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 48, 80, 96, 112])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_head_dims(dev, dtype, d, causal):
    gen = torch.Generator(device=dev).manual_seed(d)
    q, k, v = _qkv(gen, dev, dtype, 2, 3, 77, 131, d)
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, 0.3, causal)
        want = fa._reference_attention(q, k, v, 0.3, causal)
    torch.cuda.synchronize()
    _flash_close(got, want, dtype)


# the wgmma path's tiles are 128 queries x 128 keys: one below, at and one
# above a tile, two tiles and one row, Sq != Skv both ways (under the causal
# mask, rows past Skv see every key)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,skv", [(127, 127), (128, 128), (129, 129),
                                    (257, 257), (129, 257), (257, 127),
                                    (1, 1), (300, 1)])
def test_flash_kernel_tile_edges(dev, dtype, d, causal, sq, skv):
    gen = torch.Generator(device=dev).manual_seed(sq + skv)
    q, k, v = _qkv(gen, dev, dtype, 2, 3, sq, skv, d)
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, d ** -0.5, causal)
        want = fa._reference_attention(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    _flash_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [48, 64])
def test_flash_kernel_negative_and_zero_scale(dev, dtype, d):
    """A negative sm_scale moves into q; sm_scale = 0 averages v."""
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = _qkv(gen, dev, dtype, 1, 2, 150, 150, d)
    for scale in (-0.2, 0.0):
        with torch.no_grad():
            got = fa.flash_attention(q, k, v, scale, True)
            want = fa._reference_attention(q, k, v, scale, True)
        torch.cuda.synchronize()
        _flash_close(got, want, dtype)


def test_flash_kernel_many_items_a_block(dev):
    """More (batch, head, query tile) items than the card has SMs: each
    persistent block walks several through one K/V ring."""
    gen = torch.Generator(device=dev).manual_seed(14)
    for causal in (False, True):
        q, k, v = _qkv(gen, dev, torch.bfloat16, 7, 12, 700, 700, 64)
        with torch.no_grad():
            got = fa.flash_attention(q, k, v, 0.125, causal)
            want = fa._reference_attention(q, k, v, 0.125, causal)
        torch.cuda.synchronize()
        _flash_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(dev, dtype):
    """MHA's layout: q/k/v are head-transposed views of (B, S, 3·H·D)
    rows, read in place; the output's head merge is a view."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = _randn(gen, dev, 3, 300, 3 * 4 * 64).to(dtype)
    q, k, v = (t.reshape(3, 300, 4, 64).transpose(1, 2)
               for t in x.split(256, -1))
    with torch.no_grad():
        got = fa.mha_flash(*x.split(256, -1), heads=4)
        want = fa._reference_attention(q, k, v, 64 ** -0.5, False)
    torch.cuda.synchronize()
    _flash_close(got, want.transpose(1, 2).reshape(3, 300, 256), dtype)


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = _qkv(gen, dev, torch.float32, 1, 2, 16, 16, 64)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(TypeError, match="one dtype"):
        fa.flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)


# -- the whole-block kernel ---------------------------------------------------

def _block(x, p, **kw):
    return asl.fused_block_sublayer_compact(x, *p, **kw)


def _chain(x, p, **kw):
    y1 = asl.fused_attention_sublayer_compact(x, *p[:10], **kw)
    return asl.fused_mlp_sublayer(y1, *p[10:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("nseq,seq_len,d,heads", [
    (16, 10, 64, 4),        # the CPU tests' shape: six sequences a tile
    (7, 50, 768, 12),       # the vision tower's: one sequence a tile
    (3, 64, 128, 8),        # a full tile, head dim 16
    (5, 33, 256, 4),        # head dim 64, a ragged last tile
    (9, 1, 64, 1)])         # one-row sequences
def test_block_kernel(dev, dtype, causal, nseq, seq_len, d, heads):
    gen = torch.Generator(device=dev).manual_seed(7)
    p = _attn_params(gen, dev, d) + _mlp_params(gen, dev, d)
    x = (_randn(gen, dev, nseq * seq_len, d, std=0.5)).to(dtype)
    kw = dict(heads=heads, seq_len=seq_len, causal=causal)
    before = asl.fused_block_sublayer_compact.launches
    with torch.no_grad():
        got = _block(x, p, **kw)
        want = asl._block_ref_flat(x, *p, **kw)
        chain = _chain(x, p, **kw)
    torch.cuda.synchronize()
    assert asl.fused_block_sublayer_compact.launches == before + 1
    _close(got, want, dtype)
    _close(got, chain, dtype)       # the two-kernel chain, same inputs


def test_block_kernel_hidden_not_a_multiple_of_its_chunk(dev):
    """hidden = 320: one chunk of 192 columns and one of 128."""
    gen = torch.Generator(device=dev).manual_seed(8)
    d, hid = 64, 320
    p = _attn_params(gen, dev, d) + [
        1.0 + _randn(gen, dev, d, std=0.1), _randn(gen, dev, d, std=0.1),
        _randn(gen, dev, hid, d, std=d ** -0.5),
        _randn(gen, dev, hid, std=0.02),
        _randn(gen, dev, d, hid, std=0.5 * hid ** -0.5),
        _randn(gen, dev, d, std=0.02)]
    for dtype in (torch.float32, torch.bfloat16):
        x = (_randn(gen, dev, 40, d, std=0.5)).to(dtype)
        with torch.no_grad():
            got = _block(x, p, heads=4, seq_len=10)
            want = asl._block_ref_flat(x, *p, heads=4, seq_len=10,
                                       causal=False)
        torch.cuda.synchronize()
        _close(got, want, dtype)


def test_block_kernel_refuses_what_it_does_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    p = _attn_params(gen, dev, 64) + _mlp_params(gen, dev, 64)
    x = _randn(gen, dev, 130, 64)
    with pytest.raises(ValueError, match="seq_len"):
        _block(x, p, heads=4, seq_len=65)
    with pytest.raises(ValueError, match="seq_len"):
        _block(x, p, heads=4, seq_len=7)
    with pytest.raises(ValueError, match="head dims"):
        _block(x, p, heads=8, seq_len=10)
    with pytest.raises(ValueError, match="widths"):
        _block(x[:, :32], p, heads=2, seq_len=10)
    with pytest.raises(TypeError):
        _block(x.half(), p, heads=4, seq_len=10)


# -- the whole-block kernel's routes (block_path) -----------------------------

def _bf16_step(t):
    return torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 8)


def _within_layer_bound(got, x, p, **kw):
    """The block against the two-kernel chain as chip_smoke.py bounds a
    layer: 3e-2, or one bf16 step of each of the layer's four roundings
    (both sublayers' projections and both residual sums)."""
    y1 = asl.fused_attention_sublayer_compact(x, *p[:10], **kw)
    y = asl.fused_mlp_sublayer(y1, *p[10:])
    xf, y1f, yf = x.float(), y1.float(), y.float()
    tol = (_bf16_step(y1f - xf) + _bf16_step(y1f) + _bf16_step(yf - y1f)
           + _bf16_step(yf)).clamp(min=TOL[torch.bfloat16])
    return bool(((got.float() - yf).abs() <= tol).all())


def _block_case(dev, d, hd, seq_len, nseq, seed=11, hidden=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = _attn_params(gen, dev, d) + _mlp_params(gen, dev, d)
    if hidden is not None:
        p[12] = _randn(gen, dev, hidden, d, std=d ** -0.5)
        p[13] = _randn(gen, dev, hidden, std=0.02)
        p[14] = _randn(gen, dev, d, hidden, std=0.5 * hidden ** -0.5)
    x = _randn(gen, dev, nseq * seq_len, d, std=0.5).to(torch.bfloat16)
    return x, p, dict(heads=d // hd, seq_len=seq_len)


@pytest.mark.parametrize("d,hd", [(d, hd) for d in (64, 256, 512, 768)
                                  for hd in (16, 32, 64)])
@pytest.mark.parametrize("seq_len", [1, 10, 50, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_block_routes_against_plain_and_chain(dev, d, hd, seq_len, causal):
    """bf16 over widths, head dims and sequence lengths: the routed kernel
    (wgmma at 768 / 64, mma.sync elsewhere) against the plain version at
    3e-2 and against the two-kernel chain within a layer's bound."""
    nseq = max(3, 130 // seq_len)      # a few tiles, the last one short
    x, p, kw = _block_case(dev, d, hd, seq_len, nseq)
    kw["causal"] = causal
    route = asl.block_path(torch.bfloat16, d, hd, 4 * d, seq_len)
    assert route == ("wgmma" if (d, hd) == (768, 64) else "mma")
    with torch.no_grad():
        got = _block(x, p, **kw)
        want = asl._block_ref_flat(x, *p, **kw)
        torch.cuda.synchronize()
        _close(got, want, torch.bfloat16)
        assert _within_layer_bound(got, x, p, **kw)


@pytest.mark.parametrize("dtype,d,hd,route", [
    (torch.bfloat16, 768, 64, "wgmma"), (torch.bfloat16, 384, 64, "wgmma"),
    (torch.bfloat16, 192, 64, "wgmma"), (torch.bfloat16, 576, 64, "wgmma"),
    (torch.bfloat16, 768, 32, "mma"), (torch.bfloat16, 512, 64, "mma"),
    (torch.float32, 768, 64, "fma"), (torch.float32, 128, 16, "fma")])
def test_block_every_route(dev, dtype, d, hd, route):
    """Each route of block_path launches (the counter moves) and matches
    the plain version; hidden 320 gives a short last chunk."""
    x, p, kw = _block_case(dev, d, hd, 10, 13, seed=12, hidden=320)
    x = x.to(dtype)
    assert asl.block_path(dtype, d, hd, 320, 10) == route
    before = asl.fused_block_sublayer_compact.launches
    with torch.no_grad():
        got = _block(x, p, **kw)
        want = asl._block_ref_flat(x, *p, causal=False, **kw)
    torch.cuda.synchronize()
    assert asl.fused_block_sublayer_compact.launches == before + 1
    _close(got, want, dtype)


@pytest.mark.parametrize("d,hd", [(768, 64), (256, 32)])
@pytest.mark.parametrize("seq_len", [10, 50])
def test_block_neighbour_inf_stays_out(dev, d, hd, seq_len):
    """inf in the rows of one sequence: every other sequence's output, in
    the same tile (L = 10: six a tile) or the next, is bit-equal to the
    kernel's output with those rows at zero; a tail tile too (13
    sequences)."""
    x, p, kw = _block_case(dev, d, hd, seq_len, 13, seed=13)
    bad = slice(2 * seq_len, 3 * seq_len)
    clean = x.clone()
    clean[bad] = 0
    dirty = x.clone()
    dirty[bad] = float("inf")
    with torch.no_grad():
        want = _block(clean, p, **kw)
        got = _block(dirty, p, **kw)
    torch.cuda.synchronize()
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    keep[bad] = False
    assert torch.isfinite(got[keep].float()).all()
    assert torch.equal(got[keep], want[keep])


@pytest.mark.parametrize("d,hd", [(768, 64), (256, 32)])
def test_block_launches_repeat_bit_for_bit(dev, d, hd):
    x, p, kw = _block_case(dev, d, hd, 50, 7, seed=14)
    with torch.no_grad():
        a = _block(x, p, **kw)
        b = _block(x, p, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("d,hd", [(768, 64), (256, 32)])
def test_block_sees_weights_updated_in_place(dev, d, hd):
    """The weights' tensor maps are kept by address on the C side; a map
    holds the address, not the contents, so a weight changed in place
    between two calls changes the result."""
    x, p, kw = _block_case(dev, d, hd, 50, 5, seed=15)
    with torch.no_grad():
        first = _block(x, p, **kw)
        for i in (2, 8, 12, 14):            # wq, wo, w1, w2
            p[i].neg_()                     # same magnitudes, new values
        second = _block(x, p, **kw)
        want = asl._block_ref_flat(x, *p, causal=False, **kw)
    torch.cuda.synchronize()
    assert not torch.equal(first, second)
    _close(second, want, torch.bfloat16)


@pytest.mark.parametrize("d,hd", [(768, 64), (256, 32)])
def test_block_kernel_with_barrier_timeout_build(dev, d, hd):
    """csrc/common.cuh's mbarrier waits built with -DCMVE_MBAR_TIMEOUT (a
    wait that spins too long traps instead of hanging): the block kernel
    runs to the end and gives the package build's output bit for bit."""
    lib = _build.load_kernels(defines=("-DCMVE_MBAR_TIMEOUT",)).lib
    x, p, kw = _block_case(dev, d, hd, 50, 9, seed=16)
    p = [t.to(torch.bfloat16) for t in p]
    with torch.no_grad():
        want = _block(x, p, **kw)
    got = torch.empty_like(x)
    err = lib.cmve_block_sublayer(
        1, x.data_ptr(), *[t.data_ptr() for t in p], got.data_ptr(), None,
        x.shape[0], d, kw["heads"], p[12].shape[0], 50, 0, 1e-5,
        asl._sm_scale(hd), torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(got, want)


def test_wgmma_block_forms_selfcheck(dev):
    """csrc/wgmma_selfcheck.cu, the block kernel's two product forms: A
    written by the threads at swizzled addresses, a 192-row TMA box read
    whole (m64n192k16) and 32 rows into it (m64n32k16)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    a = _randn(gen, dev, 64, 64).to(torch.bfloat16)
    b = _randn(gen, dev, 192, 128).to(torch.bfloat16)
    d1 = torch.empty(64, 192, device=dev)
    d2 = torch.empty(64, 32, device=dev)
    err = _build.load_kernels().lib.cmve_wgmma_selfcheck_block(
        a.data_ptr(), b.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    torch.testing.assert_close(d1, a.float() @ b[:, 64:].float().T,
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(d2, a.float() @ b[32:64, 64:].float().T,
                               rtol=0, atol=1e-4)


# -- gradients: kernel forward, plain-version backward ------------------------

def _leaves(tensors):
    return [t.detach().clone().requires_grad_() for t in tensors]


def _same_grads(kernel, plain, args, wrapper, mask=None):
    before = wrapper.launches
    out = kernel(*args)
    assert wrapper.launches == before + 1          # the forward launched
    want = plain(*args)
    g = torch.randn_like(out)
    if mask is not None:
        g = g * mask
    got_g = torch.autograd.grad(out, args, g)
    want_g = torch.autograd.grad(want, args, g)
    torch.cuda.synchronize()
    for a, b in zip(got_g, want_g):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-4


def test_sublayer_gradients(dev):
    gen = torch.Generator(device=dev).manual_seed(10)
    d, h, l = 64, 4, 10
    a = _attn_params(gen, dev, d)
    m = _mlp_params(gen, dev, d)
    x2 = _randn(gen, dev, 4 * l, d, std=0.5)
    _same_grads(lambda *t: asl.fused_attention_sublayer_compact(
                    *t, heads=h, seq_len=l, causal=True),
                lambda *t: asl._attn_ref_flat(*t, heads=h, seq_len=l,
                                              causal=True),
                _leaves([x2] + a), asl.fused_attention_sublayer_compact)
    _same_grads(asl.fused_mlp_sublayer, asl._mlp_ref, _leaves([x2] + m),
                asl.fused_mlp_sublayer)
    _same_grads(lambda *t: asl.fused_block_sublayer_compact(
                    *t, heads=h, seq_len=l),
                lambda *t: asl._block_ref_flat(*t, heads=h, seq_len=l,
                                               causal=False),
                _leaves([x2] + a + m), asl.fused_block_sublayer_compact)
    x3 = _randn(gen, dev, 3, 16, d, std=0.5)
    mask = torch.zeros(3, 16, 1, device=dev)
    mask[:, :13] = 1                  # pad rows carry no gradient contract
    _same_grads(lambda *t: asl.fused_attention_sublayer(
                    *t, heads=h, valid_len=13, causal=True),
                lambda *t: asl._attn_ref(*t, heads=h, valid_len=13,
                                         causal=True),
                _leaves([x3] + a), asl.fused_attention_sublayer, mask)


def test_flash_gradients(dev):
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = _leaves(_qkv(gen, dev, torch.float32, 2, 3, 70, 90, 32))
    _same_grads(lambda *t: fa.flash_attention(*t, 0.2, True),
                lambda *t: fa._reference_attention(*t, 0.2, True),
                [q, k, v], fa.flash_attention)


def test_gradient_only_for_inputs_that_ask(dev):
    """Frozen weights get no gradient; under no_grad nothing is saved."""
    gen = torch.Generator(device=dev).manual_seed(12)
    m = _mlp_params(gen, dev, 64)
    x = _randn(gen, dev, 8, 64).requires_grad_()
    out = asl.fused_mlp_sublayer(x, *m)
    out.sum().backward()
    assert x.grad is not None and all(t.grad is None for t in m)
    with torch.no_grad():
        assert not asl.fused_mlp_sublayer(x, *m).requires_grad

"""The CUDA sublayer kernels against their plain versions, on the card.

Skips without CUDA.  The repository's conftest imports jax, which the
machine with the card does not have, so run this file there with:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(chip_smoke.py makes the same checks at the main-path shapes.)  This file
imports neither jax nor the JAX package.

Tolerances: f32 1e-4 absolute (summation order only).  bf16 3e-2
absolute: outputs stay under 4 in magnitude, where one bf16 step is
1.6e-2, and a one-step flip of an intermediate rounding may reach them.
"""

import pytest
import torch

from cross_modal_video_engine_tpu_torch.ops import attention_sublayer as asl

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


def test_kernels_refuse_what_they_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    p = _mlp_params(gen, dev, 64)
    x = _randn(gen, dev, 4, 64)
    with pytest.raises(TypeError):
        asl.fused_mlp_sublayer(x.half(), *p)
    w = p[2].clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        asl.fused_mlp_sublayer(x, p[0], p[1], w, *p[3:])
    with pytest.raises(ValueError):
        asl.fused_mlp_sublayer(x, *[t.cpu() for t in p])
    with pytest.raises(ValueError, match="LayerNorm"):
        asl.fused_mlp_sublayer(x, p[0][:32], *p[1:])

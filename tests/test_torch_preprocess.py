"""The port's ingest ops (patchify, channel_affine, u8_to_patches) and
l2norm against the JAX package on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cross_modal_video_engine_tpu.ops import pallas_preprocess as jpp
from cross_modal_video_engine_tpu.ops import preprocess as jpre
from cross_modal_video_engine_tpu.ops.similarity import l2norm as jl2norm
from cross_modal_video_engine_tpu_torch.models.clip import PatchEmbed
from cross_modal_video_engine_tpu_torch.ops import pallas_preprocess as tpp
from cross_modal_video_engine_tpu_torch.ops import preprocess as tpre
from cross_modal_video_engine_tpu_torch.ops.similarity import l2norm

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


def test_constants_match():
    assert tpre.CLIP_MEAN == jpre.CLIP_MEAN
    assert tpre.CLIP_STD == jpre.CLIP_STD


@pytest.mark.parametrize("shape,patch", [((2, 64, 64, 3), 32),
                                         ((2, 3, 32, 48, 3), 16)])
def test_patchify_matches_jax(shape, patch):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jpre.patchify(jnp.asarray(x), patch))
    got = tpre.patchify(torch.from_numpy(x), patch).numpy()
    np.testing.assert_array_equal(got, want)


def test_channel_affine_matches_jax():
    for a, b in zip(tpp.channel_affine(patch=4), jpp.channel_affine(patch=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-6),
    # bf16 affine: both sides round after the multiply and after the add;
    # normalized values lie within [-2.2, 2.7], where one step is 1.6e-2
    ("bfloat16", 1.6e-2)])
def test_u8_to_patches_matches_jax(dtype, tol):
    f = np.random.default_rng(1).integers(0, 256, (3, 64, 64, 3), np.uint8)
    want = jpp.u8_to_patches(jnp.asarray(f), 32, out_dtype=getattr(jnp, dtype))
    got = tpp.u8_to_patches(torch.from_numpy(f), 32,
                            out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 4, 3072)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


def test_token_path_equals_conv_path():
    """tokens @ the conv weight (as (p*p*3, W)) == the strided conv."""
    pe = PatchEmbed(24, 16, torch.float32)
    torch.nn.init.normal_(pe.weight, std=0.05,
                          generator=torch.Generator().manual_seed(0))
    f = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 32, 48, 3), np.uint8))
    mean = torch.tensor(tpre.CLIP_MEAN)
    std = torch.tensor(tpre.CLIP_STD)
    images = (f.float() / 255.0 - mean) / std
    toks = tpp.u8_to_patches(f, 16, out_dtype=torch.float32)
    with torch.no_grad():
        a = pe(images=images)
        b = pe(tokens=toks)
    assert a.shape == b.shape == (2, 6, 24)
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5)


def test_l2norm_matches_jax_with_zero_row():
    x = np.random.default_rng(3).standard_normal((4, 8)).astype(np.float32)
    x[2] = 0.0
    got = l2norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl2norm(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    assert np.all(got[2] == 0.0)

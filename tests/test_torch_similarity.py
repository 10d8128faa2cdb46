"""The port's similarity measures and `cal_error` (ops/similarity.py)
against the JAX package's on the same numpy inputs, within 1e-5 (f32 on
both sides; the distance measures subtract nearly equal squares, so the
inputs are kept at unit scale)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cross_modal_video_engine_tpu.ops.similarity as jsim
import cross_modal_video_engine_tpu_torch.ops.similarity as tsim

MEASURES = ["cosine", "order", "euclidean", "l2", "l2_norm", "l1", "l1_norm",
            "jaccard"]
TOL = 1e-5


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


def _inputs(measure, seed=0, n_im=7, n_s=5, d=12):
    rng = np.random.default_rng(seed)
    im = rng.standard_normal((n_im, d)).astype(np.float32)
    s = rng.standard_normal((n_s, d)).astype(np.float32)
    if measure == "jaccard":             # tag probabilities: non-negative
        im, s = np.abs(im), np.abs(s)
    return im, s


@pytest.mark.parametrize("measure", MEASURES)
def test_measure_matches_jax(measure):
    im, s = _inputs(measure)
    want = np.asarray(jsim.get_sim(measure)(jnp.asarray(im), jnp.asarray(s)))
    got = tsim.get_sim(measure)(torch.from_numpy(im), torch.from_numpy(s))
    assert tuple(got.shape) == (7, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("measure", MEASURES + ["order"])
@pytest.mark.parametrize("block", [0, 3])
def test_cal_error_matches_jax(measure, block):
    """(n_captions, n_videos), lower = better, the evaluation side's
    branches; `block` chunks the captions."""
    vid, cap = _inputs(measure, seed=1, n_im=6, n_s=8)
    want = np.asarray(jsim.cal_error(vid, cap, measure=measure, block=block))
    got = tsim.cal_error(vid, cap, measure=measure, block=block,
                         device="cpu")
    assert tuple(got.shape) == (8, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_cal_error_keeps_tensors_where_they_are():
    vid, cap = _inputs("cosine", seed=2)
    got = tsim.cal_error(torch.from_numpy(vid), torch.from_numpy(cap))
    assert got.device.type == "cpu" and tuple(got.shape) == (5, 7)


@pytest.mark.parametrize("tensor_arg", ["videos", "captions"])
def test_cal_error_places_mixed_inputs_on_the_tensors_device(tensor_arg):
    """A CPU tensor beside a numpy array: both go to the tensor's device
    (no `device` given, which would otherwise mean the card), and the
    matrix is the one the two numpy arrays give."""
    vid, cap = _inputs("cosine", seed=3)
    want = tsim.cal_error(vid, cap, device="cpu")
    args = ((torch.from_numpy(vid), cap) if tensor_arg == "videos"
            else (vid, torch.from_numpy(cap)))
    got = tsim.cal_error(*args)
    assert got.device.type == "cpu" and tuple(got.shape) == (5, 7)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsim.cal_error(vid, cap)), rtol=TOL, atol=TOL)


def test_cal_error_two_arrays_go_to_the_device_asked():
    vid, cap = _inputs("l2", seed=4)
    got = tsim.cal_error(vid, cap, measure="l2", device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsim.cal_error(vid, cap, measure="l2")),
        rtol=TOL, atol=TOL)


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="unknown similarity"):
        tsim.get_sim("manhattan")
    with pytest.raises(ValueError, match="unknown measure"):
        tsim.cal_error(np.zeros((2, 3)), np.zeros((2, 3)), "manhattan",
                       device="cpu")


def test_l2norm_keeps_zero_rows_at_zero():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    want = np.asarray(jsim.l2norm(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(tsim.l2norm(x).numpy(), want, atol=1e-7)

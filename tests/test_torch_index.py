"""The port's RetrievalIndex against the JAX RetrievalIndex (on the
8-device CPU mesh) over the cases of test_retrieval_index.py: the same
rows and queries give the same ids, and scores within 1e-5 (both score
in fp32 over the same stored rows, summing in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cross_modal_video_engine_tpu.parallel import make_mesh
from cross_modal_video_engine_tpu.retrieval import RetrievalIndex as JIndex
from cross_modal_video_engine_tpu_torch.retrieval import RetrievalIndex

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

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(emb, dtype="float32", **kw):
    jdt, tdt = DTYPES[dtype]
    return (JIndex(emb, mesh=make_mesh(), dtype=jdt, **kw),
            RetrievalIndex(emb, dtype=tdt, **kw))


def _same_search(j, t, q, k):
    jv, ji = j.search(q, k)
    tv, ti = t.search(q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    return ti


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(103, 5), (9, 9), (10, 50), (8192, 7)])
def test_search_matches_jax(n, k, dtype):
    """Includes k past the live rows (capped, no padding returned) and
    an index large enough for the JAX partial-reduce top-k."""
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((7, 32)).astype(np.float32)
    j, t = _pair(emb, dtype)
    ids = _same_search(j, t, q, k)
    assert ids.shape == (7, min(k, n)) and ids.max() < n


def test_search_ids_and_full_errors_match_jax():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((24, 8)).astype(np.float32)
    names = [f"v{i}" for i in range(24)]
    j, t = _pair(emb, ids=names)
    q = emb[:2] + 0.01 * rng.standard_normal((2, 8)).astype(np.float32)
    assert t.search_ids(q, k=3)[1] == j.search_ids(q, k=3)[1]
    assert t.search_ids(q, k=1)[1] == [["v0"], ["v1"]]
    np.testing.assert_allclose(t.full_errors(q), j.full_errors(q), rtol=0,
                               atol=1e-5)


def test_add_remove_compact_match_jax():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((20, 8)).astype(np.float32)
    names = [f"v{i}" for i in range(20)]
    j, t = _pair(emb, ids=names)
    cap0 = t.capacity
    new = rng.standard_normal((3, 8)).astype(np.float32)
    for idx in (j, t):
        idx.add(new, ids=["n0", "n1", "n2"])
    assert t.capacity == cap0 and (t.n, t.n_active) == (23, 23)
    q = np.concatenate([new[1:2], emb[3:4]]) \
        + 0.001 * rng.standard_normal((2, 8)).astype(np.float32)
    _same_search(j, t, q, 4)
    for idx in (j, t):
        idx.remove([21, 3])
    assert (t.n, t.n_active) == (23, 21) and t.ids[21] is None
    _same_search(j, t, q, 4)
    assert t.search_ids(q, k=1)[1] == j.search_ids(q, k=1)[1]
    errs = t.full_errors(q)
    assert np.isinf(errs[0, 21]) and np.isinf(errs[1, 3])
    np.testing.assert_allclose(errs, j.full_errors(q), rtol=0, atol=1e-5)
    for idx in (j, t):
        idx.compact()
    assert (t.n, t.n_active) == (21, 21) and t.ids == j.ids
    _same_search(j, t, q, 4)


def test_growth_past_capacity_keeps_tombstones():
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((6, 8)).astype(np.float32)
    j, t = _pair(emb, ids=[f"v{i}" for i in range(6)], capacity=8)
    new = rng.standard_normal((10, 8)).astype(np.float32)
    for idx in (j, t):
        idx.remove([2])
        idx.add(new, ids=[f"n{i}" for i in range(10)])
    assert t.capacity > 8 and (t.n, t.n_active) == (16, 15)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    ids = _same_search(j, t, q, t.n_active)
    assert 2 not in ids


def test_many_small_adds_stay_in_place():
    rng = np.random.default_rng(4)
    j, t = _pair(rng.standard_normal((4, 8)).astype(np.float32),
                 capacity=64)
    for _ in range(10):
        new = rng.standard_normal((2, 8)).astype(np.float32)
        j.add(new)
        t.add(new)
    assert t.capacity == 64 and t.n == 24
    _same_search(j, t, rng.standard_normal((3, 8)).astype(np.float32), 5)


def test_searcher_on_device_tensors():
    """searcher() scores L2-normalized query tensors without a host trip."""
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    t = RetrievalIndex(emb, dtype=torch.bfloat16)
    q = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32)))
    vals, idx = t.searcher()(t.emb, t.valid, q, 6)
    want_v, want_i = t.search(q.numpy(), 6)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_allclose(vals.numpy(), want_v, rtol=0, atol=1e-6)
    with pytest.raises(IndexError):
        t.remove([50])

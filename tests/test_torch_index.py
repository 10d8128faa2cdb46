"""The port's RetrievalIndex against the JAX RetrievalIndex (on the
8-device CPU mesh) over the cases of test_retrieval_index.py: the same
rows and queries give the same ids, and scores within 1e-5 (both score
in fp32 over the same stored rows, summing in different orders; int8
rows and queries quantize to the same integers on both sides, and the
int32 products are exact)."""

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
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _pair(emb, dtype="float32", **kw):
    jdt, tdt = DTYPES[dtype]
    return (JIndex(emb, mesh=make_mesh(), dtype=jdt, **kw),
            RetrievalIndex(emb, dtype=tdt, device="cpu", **kw))


def _same_search(j, t, q, k):
    jv, ji = j.search(q, k)
    tv, ti = t.search(q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    return ti


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
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
    t = RetrievalIndex(emb, dtype=torch.bfloat16, device="cpu")
    q = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32)))
    vals, idx = t.searcher()(t.emb, t.scales, t.valid, q, 6)
    want_v, want_i = t.search(q.numpy(), 6)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_allclose(vals.numpy(), want_v, rtol=0, atol=1e-6)
    with pytest.raises(IndexError):
        t.remove([50])


def test_int8_rows_match_jax_encoding():
    """Per-row amax/127 scales and the same int8 rows as the JAX index."""
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((40, 24)).astype(np.float32)
    j, t = _pair(emb, "int8")
    assert t.emb.dtype == torch.int8 and t.capacity % 8 == 0
    np.testing.assert_array_equal(t.emb[:40].numpy(), np.asarray(j.emb)[:40])
    np.testing.assert_allclose(t.scales[:40].numpy(),
                               np.asarray(j.scales)[:40], rtol=0, atol=0)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    np.testing.assert_allclose(t.full_errors(q), j.full_errors(q), rtol=0,
                               atol=1e-5)


def test_int8_add_remove_compact_match_jax():
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((30, 16)).astype(np.float32)
    names = [f"v{i}" for i in range(30)]
    j, t = _pair(emb, "int8", ids=names, capacity=32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    _same_search(j, t, q, 6)
    new = rng.standard_normal((2, 16)).astype(np.float32)
    for idx in (j, t):
        idx.add(new, ids=["n0", "n1"])           # in place
        idx.remove([5, 30])
    assert (t.n, t.n_active, t.capacity) == (32, 30, 32)
    ids = _same_search(j, t, q, 30)
    assert 5 not in ids and 30 not in ids
    more = rng.standard_normal((9, 16)).astype(np.float32)
    for idx in (j, t):
        idx.add(more, ids=[f"m{i}" for i in range(9)])   # grows, re-encodes
    assert t.capacity > 32 and (t.n, t.n_active) == (41, 39)
    _same_search(j, t, q, 8)
    for idx in (j, t):
        idx.compact()
    assert (t.n, t.n_active) == (39, 39) and t.ids == j.ids
    _same_search(j, t, q, 8)
    assert t.search_ids(q, k=2)[1] == j.search_ids(q, k=2)[1]


def test_int8_recall_against_exact_rows():
    """Quantization may reorder near-ties only: recall@10 against the f32
    index over the same rows stays high."""
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((4096, 64)).astype(np.float32)
    q = rng.standard_normal((16, 64)).astype(np.float32)
    exact = RetrievalIndex(emb, device="cpu").search(q, 10)[1]
    got = RetrievalIndex(emb, device="cpu", dtype=torch.int8).search(q, 10)[1]
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(exact, got)])
    assert recall >= 0.9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_rows_given_as_tensors_and_scored_in_chunks(dtype, monkeypatch):
    """A tensor builds the same index as the numpy array, and chunked
    scoring (more rows than one chunk) gives the same answer as one
    chunk."""
    import cross_modal_video_engine_tpu_torch.retrieval.index as tindex
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    a = RetrievalIndex(emb, device="cpu", dtype=dtype)
    want_v, want_i = a.search(q, 7)
    monkeypatch.setattr(tindex, "_CHUNK_ROWS", 64)
    b = RetrievalIndex(torch.from_numpy(emb), device="cpu", dtype=dtype)
    got_v, got_i = b.search(q, 7)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.full_errors(q), a.full_errors(q), rtol=0,
                               atol=1e-6)


def test_search_makes_no_fp32_copy_of_the_rows(monkeypatch):
    """Scoring reads the rows in their stored dtype: nothing widens the
    whole matrix."""
    rng = np.random.default_rng(10)
    emb = rng.standard_normal((5000, 16)).astype(np.float32)
    t = RetrievalIndex(emb, device="cpu", dtype=torch.bfloat16)
    import cross_modal_video_engine_tpu_torch.retrieval.index as tindex
    monkeypatch.setattr(tindex, "_CHUNK_ROWS", 512)
    widened = []
    orig = torch.Tensor.float

    def spy(self, *a, **kw):
        if self.dim() == 2 and self.dtype == torch.bfloat16:
            widened.append(self.shape[0])
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "float", spy)
    t.search(rng.standard_normal((2, 16)).astype(np.float32), 5)
    assert widened and max(widened) <= 512


def test_refuses_other_dtypes():
    with pytest.raises(TypeError, match="int8"):
        RetrievalIndex(np.zeros((2, 4), np.float32), device="cpu",
                       dtype=torch.float16)

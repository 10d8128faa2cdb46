"""PrefetchIterator on the card: each batch's leaves copied from pinned
memory on a side stream, the consumer's stream made to wait for them.

Skips without CUDA.  The repository's conftest imports jax, which the
machine with the card does not have, so run this file there with:

    python -m pytest --noconftest -q tests/test_torch_prefetch_cuda.py

This file imports neither jax nor the JAX package.  Every tensor must
equal its host array exactly (a copy).
"""

import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu_torch.data.prefetch import (
    PrefetchIterator, prefetch)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _host_batches(n, rows=1 << 20, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((rows,)).astype(np.float32),
             "y": (rng.integers(0, 9, (7,)).astype(np.int64), np.uint8(i)),
             "frames": [rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)]}
            for i in range(n)]


def test_batches_land_on_the_card_exactly(dev):
    host = _host_batches(6)
    it = PrefetchIterator(iter(host), depth=2)          # device=None: cuda
    got = list(it)
    assert len(got) == 6
    for g, h in zip(got, host):
        assert g["x"].device.type == "cuda" and g["x"].dtype == torch.float32
        np.testing.assert_array_equal(g["x"].cpu().numpy(), h["x"])
        np.testing.assert_array_equal(g["y"][0].cpu().numpy(), h["y"][0])
        assert int(g["y"][1]) == int(h["y"][1])
        np.testing.assert_array_equal(g["frames"][0].cpu().numpy(),
                                      h["frames"][0])


def test_consumer_stream_waits_for_the_copy(dev):
    """A kernel queued on the consumer's stream right after `next` reads
    the whole batch: the copies of 64 MB batches (slow on the side
    stream) have landed before it runs."""
    host = _host_batches(4, rows=1 << 24, seed=1)
    sums = []
    for batch in prefetch(iter(host), depth=2, device=dev):
        sums.append(batch["x"].double().sum())
    torch.cuda.synchronize()
    for s, h in zip(sums, host):
        assert abs(float(s) - float(h["x"].astype(np.float64).sum())) < 1e-3


def test_copies_run_on_a_side_stream(dev):
    """The worker thread's copies are queued on the iterator's own
    stream, not on the consumer's."""
    it = PrefetchIterator(iter(_host_batches(1, rows=16)), depth=1,
                          device=dev)
    assert it._stream is not None
    assert it._stream != torch.cuda.current_stream(dev)
    batch = next(it)
    assert batch["x"].is_cuda


def test_worker_error_reaches_the_consumer(dev):
    def source():
        yield {"x": np.zeros(4, np.float32)}
        raise RuntimeError("worker boom")

    it = prefetch(source(), device=dev)
    next(it)
    with pytest.raises(RuntimeError, match="worker boom"):
        next(it)

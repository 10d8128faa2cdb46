"""Serving micro-batcher: coalesce concurrent requests into one device call.

A copy of cross_modal_video_engine_tpu/service/batching.py.  The HTTP layer
(service/app.py) is a ThreadingHTTPServer, but one worker owns the card,
and every wave pays the host's launches and one fetch whatever its size.
The reference has no serving story at all (its web demo is static); here
requests enqueue, a single worker drains the queue up to `max_batch`
(waiting at most `max_wait_ms` for stragglers), runs ONE batched call, and
fans the results back out to per-request futures.

Rows are opaque: `fn` receives the list of pending rows and returns one
result per row, so handlers can batch dict-shaped model inputs.  For the
common array case, `make_padded_array_fn` stacks rows and pads the batch
to the next power of two (so the worker sees at most log2(max_batch)+1
batch shapes, ever).

Usage:
    fn = make_padded_array_fn(embed, max_batch=64)
    batcher = MicroBatcher(fn, max_batch=64, max_wait_ms=5)
    result_row = batcher.submit(one_query)       # thread-safe, blocking
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np


def _pad_pow2(n: int, cap: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


def make_padded_array_fn(array_fn: Callable[[np.ndarray], np.ndarray],
                         max_batch: int):
    """rows (list of (..,) arrays) -> stack, pow2-pad, call, unpad."""

    def fn(rows: Sequence[np.ndarray]) -> List[np.ndarray]:
        batch = np.stack([np.asarray(r) for r in rows])
        n = batch.shape[0]
        padded_n = _pad_pow2(n, max_batch)
        if padded_n > n:
            batch = np.concatenate(
                [batch, np.repeat(batch[:1], padded_n - n, axis=0)], axis=0)
        out = np.asarray(array_fn(batch))[:n]
        return [out[i] for i in range(n)]

    return fn


class MicroBatcher:
    """Batch `fn` over rows submitted from many threads.

    fn: list of rows -> sequence of per-row results (index-aligned).
    `submit` blocks until the row's result is ready; `submit_async`
    returns a Future.
    """

    def __init__(self, fn: Callable[[Sequence], Sequence],
                 max_batch: int = 64, max_wait_ms: float = 5.0,
                 name: str = "batcher"):
        assert max_batch >= 1
        self.fn = fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self.batches_run = 0
        self.rows_run = 0
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._worker.start()

    # -- client side --------------------------------------------------------
    def submit_async(self, row) -> Future:
        # the lock orders this against close(): a row can't slip into
        # the queue after the poison pill (its Future would never
        # resolve and submit() would block its HTTP thread forever)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            fut: Future = Future()
            self._q.put((row, fut))
            return fut

    def submit(self, row, timeout: Optional[float] = None):
        return self.submit_async(row).result(timeout)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=5)

    # -- worker -------------------------------------------------------------
    def _drain(self) -> Optional[List]:
        """Block for the first request, then gather stragglers up to
        max_batch, waiting at most max_wait TOTAL from the first
        request (a per-straggler timeout would let a trickle of
        arrivals stretch collection to max_batch * max_wait)."""
        first = self._q.get()
        if first is None:
            return None
        items = [first]
        deadline = time.monotonic() + self.max_wait
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)    # re-post the poison pill
                break
            items.append(nxt)
        return items

    def _loop(self) -> None:
        while True:
            items = self._drain()
            if items is None:
                return
            rows = [r for r, _ in items]
            futs = [f for _, f in items]
            try:
                outs = list(self.fn(rows))
                # A short result list would otherwise leave unmatched
                # futures pending forever (submit blocks the HTTP
                # worker thread); raising resolves them all below.
                if len(outs) != len(rows):
                    raise RuntimeError(
                        f"batch fn returned {len(outs)} results for "
                        f"{len(rows)} rows")
                self.batches_run += 1
                self.rows_run += len(rows)
                for fut, out in zip(futs, outs):
                    fut.set_result(out)
            except Exception as exc:
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(exc)

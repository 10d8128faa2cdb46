"""Host-feed pipeline: overlap video decode with device compute.

Counterpart of cross_modal_video_engine_tpu/io/pipeline.py.  The
reference's ingest is decord/PyAV inside torch DataLoader workers
(MultiFusion/src/utils.py:22-29, MCT loading.py:1027-1144).  Here, as in
the JAX package, it has two halves:

  * `decode_videos_batch` (io/native.py): one ctypes call decodes a
    whole batch through a C++ libav thread pool, resizing in swscale;
  * `DecodePrefetcher` (here): a small bounded pipeline that keeps
    `depth` decoded batches in flight on background threads so the
    device step consumes batch i while the host decodes batch i+1..i+d
    (the DataLoader(num_workers, prefetch_factor) role without
    processes).

Typical use (see bench/extra.bench_host_feed):

    pf = DecodePrefetcher(paths, indices, out_hw=(224, 224),
                          batch_size=32, n_workers=2, depth=2)
    for u8_batch, batch_paths in pf:
        emb = model.encode_video_u8(torch.from_numpy(u8_batch).to(dev))
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .native import decode_videos_batch


class DecodePrefetcher:
    """Iterate decoded (B, T, H, W, 3) uint8 batches with lookahead.

    paths:     video files, one per clip.
    indices:   (N, T) frame indices aligned with paths.
    out_hw:    decode-time (height, width) (swscale resize).
    batch_size:clips per yielded batch (tail batch is smaller).
    n_workers: python-side decode threads; each issues one
               decode_videos_batch call (which itself fans out over
               `decode_threads` C++ threads).
    depth:     bounded lookahead per worker pipe — caps host RAM at
               roughly n_workers * depth * batch bytes.
    """

    def __init__(self, paths: Sequence[str], indices: np.ndarray,
                 out_hw: Tuple[int, int], batch_size: int,
                 n_workers: int = 2, depth: int = 2,
                 decode_threads: int = 4):
        assert len(paths) == len(indices)
        self.paths = list(paths)
        self.indices = np.asarray(indices, np.int64)
        self.out_hw = out_hw
        self.batch_size = batch_size
        self.n_workers = max(1, n_workers)
        self.depth = max(1, depth)
        self.decode_threads = decode_threads
        self._batches: List[Tuple[List[str], np.ndarray]] = [
            (self.paths[i: i + batch_size],
             self.indices[i: i + batch_size])
            for i in range(0, len(self.paths), batch_size)]

    def __len__(self) -> int:
        return len(self._batches)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, List[str]]]:
        """Yields (u8 frames (b, T, H, W, 3), batch paths) in order."""
        h, w = self.out_hw
        n = len(self._batches)
        if n == 0:
            return
        # One queue per batch slot keeps output ordered while workers
        # race.  The inflight bound must be PER WORKER: a shared token
        # pool lets a fast worker exhaust every token on later batches
        # while the worker owning the next in-order batch starves in
        # acquire() -> consumer waits on slots[bi] forever (deadlock).
        # Each slot receives at most one put (maxsize=1), so producers
        # never block on the slot itself.
        slots: List[queue.Queue] = [queue.Queue(maxsize=1)
                                    for _ in range(n)]
        sems = [threading.Semaphore(self.depth)
                for _ in range(self.n_workers)]
        stop = threading.Event()

        def worker(worker_id: int):
            sem = sems[worker_id]
            for bi in range(worker_id, n, self.n_workers):
                if stop.is_set():
                    return
                sem.acquire()
                if stop.is_set():
                    sem.release()
                    return
                bpaths, bidx = self._batches[bi]
                try:
                    frames = decode_videos_batch(
                        bpaths, bidx, out_w=w, out_h=h,
                        n_threads=self.decode_threads)
                    slots[bi].put(("ok", frames))
                except Exception as exc:   # surfaced at consume time
                    slots[bi].put(("err", exc))

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(self.n_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(n):
                kind, val = slots[bi].get()
                sems[bi % self.n_workers].release()
                if kind == "err":
                    raise val
                yield val, self._batches[bi][0]
        finally:
            stop.set()
            # unblock producers parked in sem.acquire() (they re-check
            # `stop` after waking; the extra tokens are then inert)
            for sem in sems:
                sem.release()
            for t in threads:
                t.join(timeout=5.0)


def uniform_indices(n_clips: int, total_frames: int, clip_len: int
                    ) -> np.ndarray:
    """(n_clips, clip_len) uniform sampling grid shared by every clip
    (SampleFrames test_mode spacing)."""
    base = np.linspace(0, max(total_frames - 1, 0), clip_len).astype(
        np.int64)
    return np.tile(base, (n_clips, 1))

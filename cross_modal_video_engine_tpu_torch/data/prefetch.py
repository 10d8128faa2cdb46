"""Host-side prefetching iterator.

Counterpart of cross_modal_video_engine_tpu/data/prefetch.py.  The
reference keeps GPUs fed with torch DataLoader worker processes; here a
background thread runs decode/collate ahead of the training step and the
host-to-device copy overlaps compute (double buffering).  cv2/libav
decode releases the GIL, so threads scale.

On a CUDA device each leaf of a batch (a dict, list or tuple of arrays,
nested) is copied from pinned memory with `non_blocking=True` on a side
stream, and an event marks the end of the batch's copies.  `__next__`
makes the consumer's current stream wait for that event and records the
batch's tensors on it (`record_stream`), so the consumer never reads a
tensor before its copy has landed and the caching allocator never hands
its memory out while the consumer's stream may still read it.  On the CPU
the leaves are placed plainly.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import torch

from ..utils.device import resolve_device

NO_SHARDING = ("the sharding= placement of PrefetchIterator (a batch "
               "spread over a device mesh) is not ported yet (ROADMAP "
               "queue 1 item 11)")


def map_leaves(fn, batch):
    """`fn` on every leaf of a dict, list or tuple batch, the structure
    kept and None left as it is (jax.tree.map's role)."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return type(batch)((k, map_leaves(fn, v)) for k, v in batch.items())
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(map_leaves(fn, v) for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(map_leaves(fn, v) for v in batch)
    return fn(batch)


class PrefetchIterator:
    """Wrap any batch iterator; `depth` batches are produced ahead by a
    background thread and placed on `device` (None: the CUDA device)."""

    _END = object()

    def __init__(self, iterable: Iterable, depth: int = 2,
                 device_put: bool = True, sharding=None, device=None):
        if sharding is not None:
            raise NotImplementedError(NO_SHARDING)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device_put = device_put
        self._device = resolve_device(device) if device_put else None
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            self._stream = torch.cuda.Stream(self._device)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _place(self, batch):
        """(the batch on the device, the event its copies end with)."""
        if not self._device_put:
            return batch, None
        if self._stream is None:
            return map_leaves(lambda x: torch.as_tensor(x).to(self._device),
                              batch), None

        def copy(x):
            host = torch.as_tensor(x)
            if not host.is_pinned():
                host = host.pin_memory()
            return host.to(self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            placed = map_leaves(copy, batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return placed, done

    def _worker(self, it: Iterator):
        try:
            for batch in it:
                self._q.put(self._place(batch))
        except BaseException as e:        # surface worker errors to consumer
            self._err = e
        finally:
            self._q.put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            map_leaves(lambda t: t.record_stream(stream), batch)
        return batch


def prefetch(iterable: Iterable, depth: int = 2, device_put: bool = True,
             sharding=None, device=None) -> PrefetchIterator:
    return PrefetchIterator(iterable, depth, device_put, sharding, device)

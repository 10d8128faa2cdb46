"""Random-access feature store.

On-disk format is the reference's BigFile layout (LINAS-engine/basic/
bigfile.py:4-61): a directory holding

  feature.bin  -- row-major float32 matrix, one row per id
  id.txt       -- space-separated ids, row order
  shape.txt    -- "nrows ndims"

A copy of cross_modal_video_engine_tpu/io/bigfile.py.  Unlike the
reference (per-call `open` + sorted seek loop), the matrix is memory-mapped
once and rows are gathered with numpy fancy indexing: one contiguous host
gather, ready for `torch.from_numpy` without further copies.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Sequence, Tuple

import numpy as np


class BigFile:
    def __init__(self, datadir: str):
        with open(os.path.join(datadir, "shape.txt")) as f:
            self.nr_of_images, self.ndims = map(int, f.readline().split())
        id_path = os.path.join(datadir, "id.txt")
        with open(id_path) as f:
            content = f.read().strip()
        self.names = content.split(" ") if content else []
        if len(self.names) != self.nr_of_images:
            # some dumps are newline separated
            self.names = content.split()
        assert len(self.names) == self.nr_of_images, (
            f"id.txt has {len(self.names)} ids, shape.txt says {self.nr_of_images}"
        )
        self.name2index = {n: i for i, n in enumerate(self.names)}
        self.binary_file = os.path.join(datadir, "feature.bin")
        self._mat = np.memmap(
            self.binary_file, dtype=np.float32, mode="r",
            shape=(self.nr_of_images, self.ndims),
        )

    def read(self, requested: Sequence[str]) -> Tuple[List[str], List[np.ndarray]]:
        """Return (found_names, vectors) for the requested ids, skipping
        unknown ids — same contract as reference BigFile.read."""
        idx = [(name, self.name2index[name]) for name in requested
               if name in self.name2index]
        if not idx:
            return [], []
        names = [n for n, _ in idx]
        rows = np.asarray(self._mat[[i for _, i in idx]], dtype=np.float32)
        return names, list(rows)

    def read_batch(self, requested: Sequence[str]) -> np.ndarray:
        """Strict batched read: (len(requested), ndims) float32 array."""
        rows = [self.name2index[name] for name in requested]
        return np.asarray(self._mat[rows], dtype=np.float32)

    def read_one(self, name: str) -> np.ndarray:
        return np.asarray(self._mat[self.name2index[name]], dtype=np.float32)

    def shape(self) -> Tuple[int, int]:
        return (self.nr_of_images, self.ndims)

    def __contains__(self, name: str) -> bool:
        return name in self.name2index


class StreamFile:
    """Sequential iterator over a BigFile directory (bigfile.py:67-103)."""

    def __init__(self, datadir: str):
        self._bigfile = BigFile(datadir)
        self._pos = 0
        self.ndims = self._bigfile.ndims
        self.nr_of_images = self._bigfile.nr_of_images

    def __iter__(self):
        for i, name in enumerate(self._bigfile.names):
            yield name, np.asarray(self._bigfile._mat[i], dtype=np.float32)

    def open(self):  # reference API compat
        self._pos = 0

    def close(self):
        pass

    def next(self):
        if self._pos >= self.nr_of_images:
            raise StopIteration
        name = self._bigfile.names[self._pos]
        vec = np.asarray(self._bigfile._mat[self._pos], dtype=np.float32)
        self._pos += 1
        return name, vec


def write_bigfile(datadir: str, names: Sequence[str], mat: np.ndarray) -> None:
    """Write a BigFile directory (the reference creates these with
    util/txt2bin.py:21-76)."""
    os.makedirs(datadir, exist_ok=True)
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    assert mat.ndim == 2 and mat.shape[0] == len(names)
    mat.tofile(os.path.join(datadir, "feature.bin"))
    with open(os.path.join(datadir, "id.txt"), "w") as f:
        f.write(" ".join(names))
    with open(os.path.join(datadir, "shape.txt"), "w") as f:
        f.write(f"{mat.shape[0]} {mat.shape[1]}")

"""Composed text+video retrieval dataset.

A copy of cross_modal_video_engine_tpu/data/composed_dataset.py (numpy on
the host; h5py is imported only where an h5 file is read or written), the
rebuild of MultiFusion/src/data_utils.py:104-263 (`ComposedVideoDataset`):

  * tsv triplets (reference video, target video, modification caption,
    source, class), ids remapped through `id2vdoname.json`;
  * per-video h5 or npz features: `high_feature` (F, D) and
    `middle_layer_feature` (F, L, D) (data_utils.py:184-197);
  * 'relative' mode yields (ref_feats, target_feats, caption);
    'classic' mode yields (index, features) for index building
    (data_utils.py:234-248);
  * dual feature roots selected per-row by source (action_genome vs 'an').
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def adaptive_avg_pool_axis(x: np.ndarray, out_size: int, axis: int
                           ) -> np.ndarray:
    """torch adaptive_avg_pool semantics along one axis."""
    n = x.shape[axis]
    if n == out_size:
        return x
    starts = (np.arange(out_size) * n) // out_size
    ends = ((np.arange(out_size) + 1) * n + out_size - 1) // out_size
    pieces = [np.take(x, range(s, e), axis=axis).mean(axis=axis, keepdims=True)
              for s, e in zip(starts, ends)]
    return np.concatenate(pieces, axis=axis)


def pool_middle_feature(middle: np.ndarray, frames: int = 8,
                        tokens: int = 16,
                        dim: Optional[int] = None) -> np.ndarray:
    """(F, L, D) -> (frames, tokens, dim or D), the adaptive_avg_pool2d
    the reference applies before the combiner (inference.py:58-59) —
    which pools over BOTH the token and channel axes (RN50x4: (324, 1280)
    -> (16, 640)).  Axis-wise pooling equals torch's 2-d adaptive pool
    because each output bin is a rectangle and a mean of within-bin means
    over one axis is the rectangle mean."""
    out = adaptive_avg_pool_axis(middle, frames, axis=0)
    out = adaptive_avg_pool_axis(out, tokens, axis=1)
    if dim is not None:
        out = adaptive_avg_pool_axis(out, dim, axis=2)
    return out


class FeatureStore:
    """Per-video h5 (or npz) feature files under one or more roots."""

    def __init__(self, roots: Dict[str, str], default_root: str = "main"):
        self.roots = roots
        self.default_root = default_root

    def path_for(self, name: str, source: str = "") -> str:
        root = self.roots.get(source, self.roots[self.default_root])
        for ext in (".h5", ".hdf5", ".npz"):
            p = os.path.join(root, name + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no feature file for {name} under {root}")

    def load(self, name: str, source: str = ""
             ) -> Tuple[np.ndarray, np.ndarray]:
        p = self.path_for(name, source)
        if p.endswith(".npz"):
            d = np.load(p)
            return (np.asarray(d["high_feature"], np.float32),
                    np.asarray(d["middle_layer_feature"], np.float32))
        import h5py
        with h5py.File(p, "r") as f:
            return (np.asarray(f["high_feature"], np.float32),
                    np.asarray(f["middle_layer_feature"], np.float32))


def save_video_features(path: str, high: np.ndarray, middle: np.ndarray
                        ) -> None:
    if path.endswith(".npz"):
        np.savez(path, high_feature=high, middle_layer_feature=middle)
        return
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset("high_feature", data=high)
        f.create_dataset("middle_layer_feature", data=middle)


class ComposedVideoDataset:
    def __init__(self, triplets_tsv: str, store: FeatureStore,
                 id2name_json: Optional[str] = None, mode: str = "relative",
                 frames: int = 8, tokens: int = 16):
        assert mode in ("relative", "classic")
        self.mode = mode
        self.store = store
        self.frames = frames
        self.tokens = tokens
        self.id2name = {}
        if id2name_json and os.path.exists(id2name_json):
            with open(id2name_json) as f:
                self.id2name = json.load(f)

        self.triplets: List[Dict] = []
        self.name2source: Dict[str, str] = {}
        names = set()
        with open(triplets_tsv) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                ref, target, caption = parts[:3]
                source = parts[3] if len(parts) > 3 else ""
                cls = parts[4] if len(parts) > 4 else ""
                ref = self.id2name.get(ref, ref)
                target = self.id2name.get(target, target)
                self.triplets.append(dict(ref=ref, target=target,
                                          caption=caption, source=source,
                                          cls=cls))
                names.update((ref, target))
                # remember which root each video came from so classic
                # mode / corpus indexing can find dual-root features
                self.name2source.setdefault(ref, source)
                self.name2source.setdefault(target, source)
        self.video_names = sorted(names)
        self.name2row = {n: i for i, n in enumerate(self.video_names)}

    def __len__(self) -> int:
        return (len(self.triplets) if self.mode == "relative"
                else len(self.video_names))

    def _features(self, name: str, source: Optional[str] = None):
        if source is None:
            source = self.name2source.get(name, "")
        high, middle = self.store.load(name, source)
        high = adaptive_avg_pool_axis(high, self.frames, axis=0)
        middle = pool_middle_feature(middle, self.frames, self.tokens)
        return high, middle

    def __getitem__(self, i: int):
        if self.mode == "classic":
            name = self.video_names[i]
            return i, self._features(name)
        t = self.triplets[i]
        return (self._features(t["ref"], t["source"]),
                self._features(t["target"], t["source"]), t["caption"],
                self.name2row[t["ref"]], self.name2row[t["target"]])

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0
                ) -> Iterator[Dict]:
        """'relative' batches as dense arrays (pads tail by repeating)."""
        assert self.mode == "relative"
        order = np.arange(len(self.triplets))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            sel = list(order[i:i + batch_size])
            n = len(sel)
            while len(sel) < batch_size:
                sel.append(sel[0])
            items = [self[j] for j in sel]
            yield dict(
                ref_high=np.stack([it[0][0] for it in items]),
                ref_middle=np.stack([it[0][1] for it in items]),
                target_high=np.stack([it[1][0] for it in items]),
                target_middle=np.stack([it[1][1] for it in items]),
                captions=[it[2] for it in items],
                ref_rows=np.array([it[3] for it in items]),
                target_rows=np.array([it[4] for it in items]),
                n_valid=n,
            )

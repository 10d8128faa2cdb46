"""Recognition datasets and the epoch sampler.

Counterpart of cross_modal_video_engine_tpu/data/datasets.py (mmaction
datasets family):

* `BaseVideoDataset` — annotation lines, decode and pipeline per sample,
  and `batches`: dense fixed-shape batches, the tail padded by repeating
  its first item, with the count of real items;
* `VideoDataset` — `filename label` lines (video_dataset.py);
* `RawframeDataset` — `frame_dir total_frames label` lines, frames read
  as `img_{idx:05d}.jpg`, start_index 1 (rawframe_dataset.py);
* `VideoDatasetRelseq` — `filename a,b->c->d` label-sequence annotations
  expanded to a (max_len, num_classes) multi-hot matrix and a per-step
  mask (video_dataset_relseq.py:17-79);
* `ShardedSampler` — the epoch's order: a permutation from
  `np.random.default_rng(seed + epoch)`, padded cyclically (`np.resize`)
  to a multiple of the world size, rank::world_size of it for each rank
  (samplers/distributed_sampler.py:11-53), the same indices as the JAX
  package's.

`ClassSpecificSampler` and the raw-video, image, repeat and concat
datasets come with ROADMAP.md queue 1 item 8d, the audio datasets with
item 8g.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .pipelines import Compose


class BaseVideoDataset:
    def __init__(self, ann_file: str, pipeline: Compose,
                 data_prefix: Optional[str] = None, start_index: int = 0):
        self.ann_file = ann_file
        self.pipeline = pipeline
        self.data_prefix = data_prefix
        self.start_index = start_index
        self.video_infos = self.load_annotations()

    def load_annotations(self) -> List[Dict]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, idx: int) -> Dict:
        results = dict(self.video_infos[idx])
        results.setdefault("start_index", self.start_index)
        return self.pipeline(results)

    def batches(self, batch_size: int, order: Optional[Sequence[int]] = None
                ) -> Iterator[Tuple[np.ndarray, List[Dict], int]]:
        """(imgs stacked over the batch, the items, the count of real
        items): the last batch is padded with its first item."""
        order = list(order if order is not None else range(len(self)))
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            n = len(sel)
            while len(sel) < batch_size:
                sel.append(sel[0])
            items = [self[j] for j in sel]
            imgs = np.stack([it["imgs"] for it in items])
            yield imgs, items, n


class VideoDataset(BaseVideoDataset):
    def load_annotations(self) -> List[Dict]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                filename, label = parts[0], int(parts[1])
                if self.data_prefix:
                    filename = os.path.join(self.data_prefix, filename)
                infos.append(dict(filename=filename, label=label))
        return infos


class RawframeDataset(BaseVideoDataset):
    filename_tmpl = "img_{:05d}.jpg"

    def __init__(self, *args, **kwargs):
        # frames are 1-based on disk: start_index defaults to 1, and
        # RawFrameDecode indexes the template directly
        kwargs.setdefault("start_index", 1)
        super().__init__(*args, **kwargs)

    def load_annotations(self) -> List[Dict]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                frame_dir, total, label = (parts[0], int(parts[1]),
                                           int(parts[2]))
                if self.data_prefix:
                    frame_dir = os.path.join(self.data_prefix, frame_dir)
                infos.append(dict(frame_dir=frame_dir, total_frames=total,
                                  label=label,
                                  filename_tmpl=self.filename_tmpl))
        return infos


class VideoDatasetRelseq(BaseVideoDataset):
    """Label-sequence dataset for the caption head."""

    def __init__(self, ann_file: str, pipeline: Compose, num_classes: int,
                 max_len: int = 5, **kwargs):
        self.num_classes = num_classes
        self.max_len = max_len
        super().__init__(ann_file, pipeline, **kwargs)

    def load_annotations(self) -> List[Dict]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                filename, label = parts[0], parts[1]
                steps = label.split("->")
                mat = np.zeros((self.max_len, self.num_classes), np.float32)
                mask = np.zeros((self.max_len,), np.float32)
                for t, step in enumerate(steps[: self.max_len]):
                    for rel in step.split(","):
                        if rel != "":
                            mat[t, int(rel)] = 1.0
                    mask[t] = 1.0
                if self.data_prefix:
                    filename = os.path.join(self.data_prefix, filename)
                infos.append(dict(filename=filename, label=mat, mask=mask))
        return infos


class ShardedSampler:
    """The deterministic shuffled shard of each (epoch, rank): every rank
    computes the same permutation, pads it cyclically to equal length and
    takes rank::world_size."""

    def __init__(self, n: int, world_size: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.n = n
        self.world_size = world_size
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed

    def indices(self, epoch: int) -> List[int]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        per = int(np.ceil(self.n / self.world_size))
        # np.resize tiles cyclically, so even n < world_size fills every
        # rank
        padded = np.resize(order, per * self.world_size)
        return [int(i) for i in padded[self.rank::self.world_size]]

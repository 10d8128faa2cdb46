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

* `ClassSpecificSampler` — per-class sampling weights: with
  `dynamic_length` each class copied prob//1 times plus a random subset
  of the remainder, else a weighted multinomial draw with replacement,
  from the same `default_rng(seed + epoch)` draws as the JAX package's
  (samplers/distributed_sampler.py:54-140);
* `RepeatDataset`, `ConcatDataset` (dataset_wrappers.py), `ImageDataset`
  (`image_path label[s]` lines, the OmniSource image branch) and
  `RawVideoDataset` (`video_dir label num_clips positive_clip_inds...`
  lines).

The audio datasets come with ROADMAP.md queue 1 item 8g.
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


class ClassSpecificSampler(ShardedSampler):
    """ShardedSampler with per-class sampling weights `class_prob`
    (label -> weight).  dynamic_length=True: each class's members prob//1
    times plus a random (prob % 1) share of them (the epoch's length
    changes), shuffled; False: the original length drawn with replacement,
    each item weighted by its class's weight over the class's size."""

    def __init__(self, labels: Sequence[int], class_prob: Dict[int, float],
                 world_size: int = 1, rank: int = 0, shuffle: bool = True,
                 seed: int = 0, dynamic_length: bool = True):
        super().__init__(len(labels), world_size, rank, shuffle, seed)
        self.labels = list(labels)
        self.class_prob = dict(class_prob)
        self.dynamic_length = dynamic_length

    def indices(self, epoch: int) -> List[int]:
        rng = np.random.default_rng(self.seed + epoch)
        class_indices: Dict[int, List[int]] = {}
        for i, lb in enumerate(self.labels):
            class_indices.setdefault(lb, []).append(i)
        if self.dynamic_length:
            chosen: List[int] = []
            for k, prob in self.class_prob.items():
                members = class_indices.get(k, [])
                if not members:
                    continue
                chosen.extend(members * int(prob // 1))
                rem = int((prob % 1) * len(members))
                if rem:
                    pick = rng.permutation(len(members))[:rem]
                    chosen.extend(members[j] for j in pick)
            order = np.asarray(chosen)
            if self.shuffle:
                rng.shuffle(order)
        else:
            probs = np.asarray([
                self.class_prob.get(lb, 0.0) / len(class_indices[lb])
                for lb in self.labels], np.float64)
            order = rng.choice(len(self.labels), size=len(self.labels),
                               replace=True, p=probs / probs.sum())
        per = int(np.ceil(len(order) / self.world_size))
        padded = np.resize(order, per * self.world_size)  # cyclic pad
        return [int(i) for i in padded[self.rank::self.world_size]]


class RepeatDataset:
    """A dataset repeated `times` times (dataset_wrappers.py:8-36)."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self) -> int:
        return self.times * len(self.dataset)

    def __getitem__(self, idx: int):
        return self.dataset[idx % len(self.dataset)]

    def batches(self, batch_size: int,
                order: Optional[Sequence[int]] = None):
        return BaseVideoDataset.batches(self, batch_size, order)


class ConcatDataset:
    """Datasets end to end (dataset_wrappers.py:39-71)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        k = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[k][idx - int(self._offsets[k])]

    def batches(self, batch_size: int,
                order: Optional[Sequence[int]] = None):
        return BaseVideoDataset.batches(self, batch_size, order)


class ImageDataset(VideoDataset):
    """`image_path label[s]` lines (image_dataset.py:7-45): one int label,
    or with `num_classes` a many-hot row for every line.  Its pipelines
    pair ImageDecode with BuildPseudoClip."""

    def __init__(self, ann_file: str, pipeline: Compose,
                 num_classes: Optional[int] = None, **kwargs):
        self.num_classes = num_classes
        super().__init__(ann_file, pipeline, **kwargs)

    def load_annotations(self) -> List[Dict]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                filename, labels = parts[0], [int(x) for x in parts[1:]]
                if self.data_prefix:
                    filename = os.path.join(self.data_prefix, filename)
                if self.num_classes:
                    onehot = np.zeros((self.num_classes,), np.float32)
                    onehot[labels] = 1.0
                    infos.append(dict(filename=filename, label=onehot))
                else:
                    if len(labels) != 1:
                        raise ValueError(f"{line.strip()!r}: multi-label "
                                         f"rows need num_classes")
                    infos.append(dict(filename=filename, label=labels[0]))
        return infos


class RawVideoDataset(BaseVideoDataset):
    """`video_dir label num_clips positive_clip_inds...` lines
    (rawvideo_dataset.py:77-99): untrimmed videos cut into clip files."""

    def load_annotations(self) -> List[Dict]:
        infos = []
        with open(self.ann_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                video_dir = parts[0]
                if self.data_prefix:
                    video_dir = os.path.join(self.data_prefix, video_dir)
                infos.append(dict(
                    video_dir=video_dir, label=int(parts[1]),
                    num_clips=int(parts[2]),
                    positive_clip_inds=[int(x) for x in parts[3:]]))
        return infos

"""Recognition datasets: the label-sequence (caption) split.

Counterpart of the part of cross_modal_video_engine_tpu/data/datasets.py
that caption evaluation reads (mmaction datasets family):

* `BaseVideoDataset` — annotation lines, decode and pipeline per sample,
  and `batches`: dense fixed-shape batches, the tail padded by repeating
  its first item, with the count of real items;
* `VideoDatasetRelseq` — `filename a,b->c->d` label-sequence annotations
  expanded to a (max_len, num_classes) multi-hot matrix and a per-step
  mask (video_dataset_relseq.py:17-79).

`VideoDataset`, `RawframeDataset` and `ShardedSampler` come with caption
training (ROADMAP.md queue 1 item 6b).
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

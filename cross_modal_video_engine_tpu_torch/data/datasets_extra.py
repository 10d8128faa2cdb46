"""The long-tail datasets.

Counterpart of cross_modal_video_engine_tpu/data/datasets_extra.py (the
rest of the mmaction dataset family).  Ported so far:

* `HVUDataset`: JSON annotations with per-category label lists
  (action, scene, object, ...); each category gets its own many-hot
  target (hvu_dataset.py), which losses/hvu.py consumes.

The pose dataset comes with ROADMAP.md queue 1 item 8h, the AVA dataset
with item 8f and the localization datasets with item 8e.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np


class HVUDataset:
    def __init__(self, ann_file: str, categories: Sequence[str],
                 category_nums: Dict[str, int],
                 data_prefix: Optional[str] = None, pipeline=None):
        self.categories = list(categories)
        self.category_nums = dict(category_nums)
        self.pipeline = pipeline
        with open(ann_file) as f:
            raw = json.load(f)
        self.video_infos = []
        for item in raw:
            filename = item["filename"]
            if data_prefix:
                filename = os.path.join(data_prefix, filename)
            targets = {}
            for cat in self.categories:
                onehot = np.zeros(self.category_nums[cat], np.float32)
                for lab in item.get("label", {}).get(cat, []):
                    onehot[int(lab)] = 1.0
                targets[cat] = onehot
            self.video_infos.append(dict(filename=filename, label=targets))

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, idx: int) -> Dict:
        results = dict(self.video_infos[idx], start_index=0)
        return self.pipeline(results) if self.pipeline else results

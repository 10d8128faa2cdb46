"""The multigrid training schedule (fixed-shape buckets).

Counterpart of cross_modal_video_engine_tpu/train/multigrid.py (after MCT
mmaction/utils/multigrid/longshortcyclehook.py): a small fixed set of
(batch, frames, resolution) buckets.  The long cycle moves through the
buckets coarse to fine, `long_cycle_epochs` epochs each; the short cycle
(`short_cycle_period` > 0) steps back to the next coarser bucket every
period-th step of an epoch; the last `final_epochs` epochs take the
finest bucket.  The learning rate scales with the bucket's batch over
`base_batch` (`lr_for`; the trainer scales the optimizer's update by
that ratio).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class GridBucket:
    batch_size: int
    num_frames: int
    resolution: int

    @property
    def cost(self) -> float:
        return self.batch_size * self.num_frames * self.resolution ** 2


@dataclasses.dataclass(frozen=True)
class MultigridSchedule:
    buckets: Tuple[GridBucket, ...] = (
        GridBucket(64, 4, 112),
        GridBucket(32, 8, 112),
        GridBucket(16, 8, 224),
        GridBucket(8, 8, 224),
    )
    long_cycle_epochs: int = 2       # epochs per long-cycle stage
    short_cycle_period: int = 0      # 0: long cycle only
    base_batch: int = 8
    base_lr: float = 0.1
    final_epochs: int = 2            # the last epochs take the last bucket

    def bucket_for(self, epoch: int, total_epochs: int,
                   step: int = 0) -> GridBucket:
        """The bucket of `step` (within the epoch) of `epoch`."""
        if epoch >= total_epochs - self.final_epochs:
            return self.buckets[-1]
        stage = (epoch // self.long_cycle_epochs) % len(self.buckets)
        if self.short_cycle_period:
            if step % self.short_cycle_period == 0 and stage > 0:
                stage -= 1
        return self.buckets[stage]

    def lr_for(self, bucket: GridBucket) -> float:
        return self.base_lr * bucket.batch_size / self.base_batch

    def compiled_shapes(self) -> List[Tuple[int, int, int]]:
        return [(b.batch_size, b.num_frames, b.resolution)
                for b in self.buckets]

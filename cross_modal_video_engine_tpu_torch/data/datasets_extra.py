"""The long-tail datasets.

Counterpart of cross_modal_video_engine_tpu/data/datasets_extra.py (the
rest of the mmaction dataset family).  Ported so far:

* `HVUDataset`: JSON annotations with per-category label lists
  (action, scene, object, ...); each category gets its own many-hot
  target (hvu_dataset.py), which losses/hvu.py consumes;
* `ActivityNetDataset`: ActivityNet-style JSON annotations and per-video
  snippet features, resampled to a fixed temporal length (BMN, BSN);
* `load_localize_proposal_file`, `SSNProposal` and `SSNDataset`: the SSN
  proposal-file format and the per-video sampled proposal layout, drawn
  from the dataset's seeded numpy generator (ssn_dataset.py);
* `AVADataset`: AVA csv rows grouped into keyframes, each with its
  entities' normalized boxes and many-hot action labels;
* `PoseDataset`: pickled skeleton annotations (keypoints (M, T, V, C) or
  (T, V, C) and a label), persons zero-padded or cut to M, clips
  sampled uniformly by `np.round(np.linspace(...))` or loop-padded to
  clip_len, `src_shape` (the annotation's img_shape) and `batches`
  (padded by repeating the first item).

Every dataset of the JAX module is ported.
"""

from __future__ import annotations

import csv
import json
import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


class PoseDataset:
    """Pickled list of dicts: {'keypoint': (M, T, V, C), 'label': int}.

    ``num_persons=1`` (default) yields (T, V, C) for the single-person
    GCN path; ``num_persons=M`` keeps up to M persons zero-padded to a
    static (M, T, V, C) — the NTU layout the reference's skeleton
    pipelines batch as (N, C, T, V, M) with num_person=2
    (heads/stgcn_head.py:46-57)."""

    def __init__(self, ann_file: str, clip_len: int = 48,
                 num_joints: int = 17, num_persons: int = 1):
        with open(ann_file, "rb") as f:
            self.annos = pickle.load(f)
        self.clip_len = clip_len
        self.num_joints = num_joints
        self.num_persons = num_persons

    def __len__(self) -> int:
        return len(self.annos)

    def src_shape(self, idx: int):
        """The annotation's (h, w) pixel frame for its keypoint coords
        (poseC3D pickles carry 'img_shape'); None if absent.  Heatmap
        consumers rescale keypoints from this frame to the heatmap
        size — raw 1080p coords dropped into a 56x56 canvas would fall
        entirely outside it."""
        return self.annos[idx].get("img_shape")

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        a = self.annos[idx]
        kp = np.asarray(a["keypoint"], np.float32)
        if kp.ndim == 3:                  # (T, V, C) -> one person
            kp = kp[None]
        M = self.num_persons
        if kp.shape[0] >= M:
            kp = kp[:M]
        else:
            pad = np.zeros((M - kp.shape[0],) + kp.shape[1:], np.float32)
            kp = np.concatenate([kp, pad])
        T = kp.shape[1]
        if T >= self.clip_len:            # uniform sample
            sel = np.round(np.linspace(0, T - 1, self.clip_len)).astype(int)
            kp = kp[:, sel]
        else:                             # loop pad
            reps = int(np.ceil(self.clip_len / T))
            kp = np.tile(kp, (1, reps, 1, 1))[:, : self.clip_len]
        if M == 1:
            return kp[0], int(a["label"])
        return kp, int(a["label"])

    def batches(self, batch_size: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        for i in range(0, len(self), batch_size):
            items = [self[j] for j in range(i, min(i + batch_size,
                                                   len(self)))]
            n = len(items)
            while len(items) < batch_size:
                items.append(items[0])
            kps = np.stack([it[0] for it in items])
            labels = np.asarray([it[1] for it in items], np.int64)
            yield kps, labels, n


class AVADataset:
    """CSV annotation rows: video_id,timestamp,x1,y1,x2,y2,action_id,entity.
    Boxes are normalized [0,1] coordinates like the AVA release; keyframes
    in (video, timestamp) order."""

    def __init__(self, ann_file: str, num_classes: int = 81,
                 data_prefix: Optional[str] = None):
        self.num_classes = num_classes
        self.data_prefix = data_prefix
        keyframes: Dict[Tuple[str, float], Dict] = {}
        with open(ann_file) as f:
            for row in csv.reader(f):
                if not row:
                    continue
                vid, ts = row[0], float(row[1])
                box = tuple(float(v) for v in row[2:6])
                action = int(row[6])
                # no entity-id column (7-col detector dumps): the box is
                # the identity, so each person keeps its own box
                entity = row[7] if len(row) > 7 else repr(box)
                kf = keyframes.setdefault(
                    (vid, ts), {"video": vid, "timestamp": ts,
                                "entities": {}})
                ent = kf["entities"].setdefault(
                    entity, {"box": box,
                             "labels": np.zeros(num_classes, np.float32)})
                if 0 <= action < num_classes:
                    ent["labels"][action] = 1.0
        self.keyframes = []
        for (vid, ts), kf in sorted(keyframes.items()):
            ents = kf["entities"].values()
            filename = os.path.join(data_prefix, vid) if data_prefix else vid
            self.keyframes.append(dict(
                filename=filename, video_id=vid, timestamp=ts,
                boxes=np.asarray([e["box"] for e in ents], np.float32),
                labels=np.stack([e["labels"] for e in ents])))

    def __len__(self) -> int:
        return len(self.keyframes)

    def __getitem__(self, idx: int) -> Dict:
        return dict(self.keyframes[idx])


class ActivityNetDataset:
    """Temporal-localization dataset: ActivityNet-style JSON annotations
    + per-video snippet-feature files (the format the reference's
    localization configs consume via mmaction ActivityNetDataset).

    ann json: {video_id: {"duration": seconds,
                          "annotations": [{"segment": [s, e],
                                           "label": name-or-int}, ...]}}
    features: <feature_prefix>/<video_id>.npy with shape (T, F); every
    video is resampled (linear) to `temporal_dim` snippets so one shape
    covers the corpus.
    """

    def __init__(self, ann_file: str, feature_prefix: str,
                 temporal_dim: int = 100):
        with open(ann_file) as f:
            ann = json.load(f)
        self.feature_prefix = feature_prefix
        self.temporal_dim = temporal_dim
        self.videos = []
        for vid, info in sorted(ann.items()):
            duration = float(info["duration"])
            segs, labels = [], []
            for a in info.get("annotations", []):
                s, e = a["segment"]
                segs.append([max(0.0, s / duration),
                             min(1.0, e / duration)])
                labels.append(a.get("label", 0))
            self.videos.append(dict(
                video=vid, duration=duration,
                segments=np.asarray(segs, np.float32).reshape(-1, 2),
                labels=labels))

    def __len__(self) -> int:
        return len(self.videos)

    def features(self, idx: int) -> np.ndarray:
        v = self.videos[idx]
        feats = np.load(os.path.join(self.feature_prefix,
                                     v["video"] + ".npy"))
        T = self.temporal_dim
        if feats.shape[0] != T:
            pos = np.linspace(0, feats.shape[0] - 1, T)
            lo = np.floor(pos).astype(int)
            hi = np.minimum(lo + 1, feats.shape[0] - 1)
            frac = (pos - lo)[:, None]
            feats = (1 - frac) * feats[lo] + frac * feats[hi]
        return feats.astype(np.float32)

    def __getitem__(self, idx: int) -> Dict:
        v = dict(self.videos[idx])
        v["features"] = self.features(idx)
        return v


# ---------------------------------------------------------------------------
# SSN proposal dataset (ssn_dataset.py + localization/ssn_utils.py)
# ---------------------------------------------------------------------------


def load_localize_proposal_file(path: str) -> List[Tuple]:
    """Parse the SSN proposal-file format (ssn_utils.py:10-77):

        # idx
        video_id
        num_frames
        fps
        num_gts
        label start_frame end_frame            (x num_gts)
        num_proposals
        label best_iou overlap_self start end  (x num_proposals)

    Returns [(video_id, num_frames, fps, gts, proposals), ...] with gts
    and proposals as float arrays (possibly empty)."""
    out = []
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        if not lines[i].startswith("#"):
            i += 1
            continue
        video_id = lines[i + 1]
        num_frames = int(float(lines[i + 2]))
        fps = float(lines[i + 3])
        n_gt = int(lines[i + 4])
        gt = np.asarray([lines[i + 5 + j].split() for j in range(n_gt)],
                        np.float64).reshape(n_gt, 3)
        i += 5 + n_gt
        n_prop = int(lines[i])
        prop = np.asarray([lines[i + 1 + j].split() for j in range(n_prop)],
                          np.float64).reshape(n_prop, 5)
        i += 1 + n_prop
        out.append((video_id, num_frames, fps, gt, prop))
    return out


class SSNProposal:
    """SSNInstance equivalent (ssn_dataset.py:19-49): frame-span proposal
    with its best-gt tIoU and self-overlap.  Duck-compatible with
    SampleProposalFrames (`start_frame`/`end_frame`)."""

    def __init__(self, start_frame: int, end_frame: int, num_frames: int,
                 label: int = -1, best_iou: float = 0.0,
                 overlap_self: float = 0.0):
        self.start_frame = int(start_frame)
        self.end_frame = int(min(end_frame, num_frames))
        self.num_video_frames = num_frames
        self.label = label
        self.coverage = (end_frame - start_frame) / max(num_frames, 1)
        self.best_iou = best_iou
        self.overlap_self = overlap_self


class SSNDataset:
    """Proposal dataset for SSN training (ssn_dataset.py:60-330): parses
    the proposal file, and per video draws the fixed
    positive/incomplete/background proposal layout through
    train.localization_trainer.sample_ssn_proposals.  `normalized_`
    files are handled by the denormalize_proposals data tool."""

    def __init__(self, ann_file: str, data_prefix: Optional[str] = None,
                 sampler_cfg=None, seed: int = 0):
        from ..train.localization_trainer import SSNSamplerConfig

        self.sampler_cfg = sampler_cfg or SSNSamplerConfig()
        self.rng = np.random.default_rng(seed)
        self.video_infos = []
        for vid, num_frames, fps, gt, prop in \
                load_localize_proposal_file(ann_file):
            frame_dir = os.path.join(data_prefix, vid) if data_prefix else vid
            gts = [SSNProposal(g[1], g[2], num_frames, label=int(g[0]),
                               best_iou=1.0)
                   for g in gt if g[2] > g[1] and g[1] < num_frames]
            props = [SSNProposal(p[3], p[4], num_frames, label=int(p[0]),
                                 best_iou=p[1], overlap_self=p[2])
                     for p in prop if p[4] > p[3] and p[3] < num_frames]
            self.video_infos.append(dict(
                frame_dir=frame_dir, video_id=vid, total_frames=num_frames,
                fps=fps, gts=gts, proposals=props))

    def __len__(self) -> int:
        return len(self.video_infos)

    def __getitem__(self, idx: int) -> Dict:
        """One training sample: the sampled proposal layout + the
        `out_proposals`/`total_frames` keys SampleProposalFrames reads."""
        from ..train.localization_trainer import sample_ssn_proposals

        info = self.video_infos[idx]
        gts, props = info["gts"], info["proposals"]
        if not gts or not props:
            raise ValueError(f"video {info['video_id']} has no usable "
                             "gts/proposals")
        prop_arr = np.asarray(
            [[p.start_frame, p.end_frame] for p in props], np.float64)
        gt_arr = np.asarray(
            [[g.start_frame, g.end_frame] for g in gts], np.float64)
        gt_labels = np.asarray([g.label for g in gts], np.int64)
        sampled = sample_ssn_proposals(prop_arr, gt_arr, gt_labels,
                                       self.sampler_cfg, self.rng)
        out_props = [
            SSNProposal(s, e, info["total_frames"])
            for s, e in np.asarray(sampled["proposals"], np.int64)]
        return dict(info, out_proposals=out_props, start_index=0,
                    sampled_proposals=sampled["proposals"],
                    labels=sampled["labels"],
                    proposal_type=sampled["proposal_type"],
                    bbox_targets=sampled["bbox_targets"])

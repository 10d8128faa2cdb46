"""Pipeline ops beyond data/pipelines.py: geometry, image decode and the
formatting tail.

Counterpart of the matching ops of
cross_modal_video_engine_tpu/data/pipelines_extra.py, over the same
`results` dict contract and registry keys:

* `RandomCrop` (augmentations.py:556-680): a square crop at a seeded
  random corner, carrying keypoints, boxes (pixel or, with
  `bbox_coords='normalized'`, [0, 1] coordinates) and the crop
  quadruple along;
* `RandomRescale` (augmentations.py:1171-1220): the short side resized to
  a seeded random size in a closed range, aspect kept;
* `BuildPseudoClip` (loading.py:1611-1640): one image repeated into a
  clip;
* `ImageDecode`: one image file as the clip's only frame, RGB, read by
  `reader` (filename -> (H, W, 3) uint8 RGB; the default reads with cv2,
  imported on call: the card's machine has no cv2, so a caller there
  hands a reader in);
* `ArrayDecode` (loading.py:1350-1390): frames picked from an in-memory
  (T, H, W, C) array, RGB or two-channel flow;
* `Rename`, `Transpose`, `Collect` (formatting.py);
* the localization ops (loading.py:470-725, 1697-1860):
  `LoadLocalizationFeature` (a (T, C) csv as raw_feature (C, T)),
  `GenerateLocalizationLabels` (segments in seconds -> gt_bbox in [0,
  1]), `LoadProposals` (the top-k PGM proposals and their BSP features)
  and `SampleProposalFrames` (SSN's starting / course / ending segment
  sampling around each proposal, seeded; strided in test mode);
* `SampleAVAFrames` (loading.py:424-467): a clip centred on an AVA
  keyframe, each frame jittered by a draw of the op's seeded numpy
  generator in train mode (bounds `(-fi) // 2` and `(fi + 1) // 2`),
  clamped to the shot.

* the pose ops (pose_loading.py, formatting.py, augmentations.py),
  numpy copies of the JAX ops: `UniformSampleFrames` (test mode from a
  fixed seed; in train mode from the op's `rng`, an unseeded numpy
  generator a caller may replace to hand the draws in),
  `PaddingWithLoop`, `PoseDecode`, `LoadKineticsPose`, `PoseNormalize`,
  `PoseCompact`, `JointToBone`, `FormatGCNInput` and
  `GeneratePoseTarget` (keypoint and limb pseudo-heatmaps, max-combined
  over persons, (T, H, W, K)).

The audio ops come with ROADMAP.md queue 1 item 8g
(data/pipelines.UNPORTED_OPS).
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import PIPELINES
from .pipelines import Resize


def _combine_quadruple(a, b):
    return (a[0] + a[2] * b[0], a[1] + a[3] * b[1], a[2] * b[2], a[3] * b[3])


@PIPELINES.register("RandomCrop")
class RandomCrop:
    """A size x size crop at a corner drawn from default_rng(seed)."""

    def __init__(self, size: int, seed: Optional[int] = None):
        self.size = size
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _box_crop(box, crop_bbox):
        x1, y1, x2, y2 = crop_bbox
        out = box.copy()
        out[..., 0::2] = np.clip(box[..., 0::2] - x1, 0, x2 - x1 - 1)
        out[..., 1::2] = np.clip(box[..., 1::2] - y1, 0, y2 - y1 - 1)
        return out

    @staticmethod
    def _box_crop_normalized(box, x0, y0, size, img_w, img_h):
        out = np.asarray(box, np.float32).copy()
        out[..., 0::2] = np.clip(
            (out[..., 0::2] - x0 / img_w) * img_w / size, 0.0, 1.0)
        out[..., 1::2] = np.clip(
            (out[..., 1::2] - y0 / img_h) * img_h / size, 0.0, 1.0)
        return out

    def __call__(self, results: Dict) -> Dict:
        img_h, img_w = results["img_shape"]
        if self.size > img_h or self.size > img_w:
            raise ValueError(f"crop {self.size} of a {img_h}x{img_w} image")
        y0 = int(self.rng.integers(0, img_h - self.size)) \
            if img_h > self.size else 0
        x0 = int(self.rng.integers(0, img_w - self.size)) \
            if img_w > self.size else 0
        bbox = np.array([x0, y0, x0 + self.size, y0 + self.size])
        if "imgs" in results:
            results["imgs"] = [im[y0:y0 + self.size, x0:x0 + self.size]
                               for im in results["imgs"]]
        if "keypoint" in results:
            results["keypoint"] = results["keypoint"] - bbox[:2]
        normalized = results.get("bbox_coords") == "normalized"
        for key in ("gt_bboxes", "proposals"):
            if results.get(key) is None or not len(results[key]):
                continue
            if normalized:
                results[key] = self._box_crop_normalized(
                    results[key], x0, y0, self.size, img_w, img_h)
            else:
                results[key] = self._box_crop(results[key], bbox)
        quad = results.get("crop_quadruple", (0.0, 0.0, 1.0, 1.0))
        results["crop_quadruple"] = _combine_quadruple(
            quad, (x0 / img_w, y0 / img_h, self.size / img_w,
                   self.size / img_h))
        results["crop_bbox"] = bbox
        results["img_shape"] = (self.size, self.size)
        return results


@PIPELINES.register("RandomRescale")
class RandomRescale:
    """The short side resized to an int drawn in [lo, hi] from
    default_rng(seed), aspect kept (data/pipelines.Resize)."""

    def __init__(self, scale_range: Tuple[int, int],
                 seed: Optional[int] = None):
        lo, hi = scale_range
        if not 0 < lo < hi:
            raise ValueError(f"scale_range {scale_range}")
        self.scale_range = (lo, hi)
        self.rng = np.random.default_rng(seed)

    def __call__(self, results: Dict) -> Dict:
        short = int(self.rng.integers(self.scale_range[0],
                                      self.scale_range[1] + 1))
        results = Resize((-1, short), keep_ratio=True)(results)
        results["short_edge"] = short
        return results


@PIPELINES.register("BuildPseudoClip")
class BuildPseudoClip:
    """One image repeated clip_len times (copies after the first)."""

    def __init__(self, clip_len: int):
        self.clip_len = clip_len

    def __call__(self, results: Dict) -> Dict:
        if len(results["imgs"]) != 1:
            raise ValueError("BuildPseudoClip takes a single image")
        results["imgs"] = [results["imgs"][0]] + \
            [np.copy(results["imgs"][0]) for _ in range(1, self.clip_len)]
        results["clip_len"] = self.clip_len
        results["num_clips"] = 1
        return results


def read_image_rgb(filename: str) -> np.ndarray:
    """cv2.imread's BGR image as RGB (mmcv's imfrombytes 'rgb')."""
    import cv2
    img = cv2.imread(filename)
    if img is None:
        raise FileNotFoundError(filename)
    return img[..., ::-1]


@PIPELINES.register("ImageDecode")
class ImageDecode:
    """The image file `results["filename"]` as the only frame (RGB);
    reader: filename -> (H, W, 3) uint8 RGB (default read_image_rgb)."""

    def __init__(self, reader: Optional[Callable] = None):
        self.reader = reader or read_image_rgb

    def __call__(self, results: Dict) -> Dict:
        img = np.ascontiguousarray(self.reader(results["filename"]))
        results["imgs"] = [img]
        results["original_shape"] = img.shape[:2]
        results["img_shape"] = img.shape[:2]
        results["total_frames"] = 1
        return results


@PIPELINES.register("ArrayDecode")
class ArrayDecode:
    """Frames `frame_inds` (+ offset) of `results["array"]`: RGB frames,
    or for 'Flow' the x and y planes of each."""

    def __call__(self, results: Dict) -> Dict:
        array = results["array"]
        inds = np.asarray(results["frame_inds"])
        if inds.ndim != 1:
            inds = np.squeeze(inds)
        inds = inds + results.get("offset", 0)
        modality = results.get("modality", "RGB")
        imgs = []
        for idx in np.atleast_1d(inds):
            if modality == "RGB":
                imgs.append(array[idx])
            elif modality == "Flow":
                imgs.extend([array[idx, ..., 0], array[idx, ..., 1]])
            else:
                raise NotImplementedError(modality)
        results["imgs"] = imgs
        results["original_shape"] = imgs[0].shape[:2]
        results["img_shape"] = imgs[0].shape[:2]
        return results


@PIPELINES.register("Rename")
class Rename:
    def __init__(self, mapping: Dict[str, str]):
        self.mapping = dict(mapping)

    def __call__(self, results: Dict) -> Dict:
        for old, new in self.mapping.items():
            if old in results:
                if new in results:
                    raise KeyError(f"Rename {old!r}: {new!r} exists")
                results[new] = results.pop(old)
        return results


@PIPELINES.register("Transpose")
class Transpose:
    def __init__(self, keys: Sequence[str], order: Sequence[int]):
        self.keys = list(keys)
        self.order = tuple(order)

    def __call__(self, results: Dict) -> Dict:
        for key in self.keys:
            results[key] = np.asarray(results[key]).transpose(self.order)
        return results


@PIPELINES.register("Collect")
class Collect:
    """Only `keys` kept, with `meta_keys` under 'img_metas' when given."""

    def __init__(self, keys: Sequence[str], meta_keys: Sequence[str] = ()):
        self.keys = list(keys)
        self.meta_keys = list(meta_keys)

    def __call__(self, results: Dict) -> Dict:
        out = {k: results[k] for k in self.keys}
        if self.meta_keys:
            out["img_metas"] = {k: results[k] for k in self.meta_keys
                                if k in results}
        return out


@PIPELINES.register("SampleAVAFrames")
class SampleAVAFrames:
    """loading.py:424-467: clip centered on the keyframe timestamp, jittered
    per frame in train mode, clamped to the shot boundaries."""

    def __init__(self, clip_len: int, frame_interval: int = 2,
                 test_mode: bool = False, seed: Optional[int] = None):
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.test_mode = test_mode
        self.rng = np.random.default_rng(seed)

    def __call__(self, results: Dict) -> Dict:
        fps = results["fps"]
        center = fps * (results["timestamp"]
                        - results["timestamp_start"]) + 1
        # a video's shot defaults to all its frames
        shot = results.get("shot_info") or (0, results["total_frames"])
        start = center - (self.clip_len // 2) * self.frame_interval
        end = center + ((self.clip_len + 1) // 2) * self.frame_interval
        inds = np.arange(start, end, self.frame_interval)
        if not self.test_mode:
            # (-fi) // 2 floors the negated interval: -2 for fi = 3
            inds = inds + self.rng.integers(
                (-self.frame_interval) // 2, (self.frame_interval + 1) // 2,
                size=self.clip_len)
        inds = np.clip(inds, shot[0], shot[1] - 1)
        results["frame_inds"] = inds.astype(np.int64) + \
            results.get("start_index", 0)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = self.frame_interval
        results["num_clips"] = 1
        results["crop_quadruple"] = np.array([0, 0, 1, 1], np.float32)
        return results


# -- localization features and proposals --------------------------------------

@PIPELINES.register("LoadLocalizationFeature")
class LoadLocalizationFeature:
    """loading.py:1697-1741: csv (T, C) -> raw_feature (C, T)."""

    def __init__(self, raw_feature_ext: str = ".csv"):
        assert raw_feature_ext == ".csv"
        self.raw_feature_ext = raw_feature_ext

    def __call__(self, results: Dict) -> Dict:
        path = os.path.join(results["data_prefix"],
                            results["video_name"] + self.raw_feature_ext)
        raw = np.loadtxt(path, dtype=np.float32, delimiter=",", skiprows=1)
        results["raw_feature"] = np.transpose(raw, (1, 0))
        return results


@PIPELINES.register("GenerateLocalizationLabels")
class GenerateLocalizationLabels:
    """loading.py:1744-1777: annotation segments (seconds) -> gt_bbox in
    [0, 1] of the feature-corrected duration."""

    def __call__(self, results: Dict) -> Dict:
        corrected = (float(results["feature_frame"])
                     / results["duration_frame"]
                     * results["duration_second"])
        gt = [[max(min(1, a["segment"][0] / corrected), 0),
               max(min(1, a["segment"][1] / corrected), 0)]
              for a in results["annotations"]]
        results["gt_bbox"] = np.array(gt)
        return results


@PIPELINES.register("LoadProposals")
class LoadProposals:
    """loading.py:1780-1857: top-k PGM proposals (tmin, tmax, scores,
    reference tIoU) + bsp features."""

    def __init__(self, top_k: int, pgm_proposals_dir: str,
                 pgm_features_dir: str, proposal_ext: str = ".csv",
                 feature_ext: str = ".npy"):
        assert proposal_ext == ".csv" and feature_ext == ".npy"
        self.top_k = top_k
        self.pgm_proposals_dir = pgm_proposals_dir
        self.pgm_features_dir = pgm_features_dir
        self.proposal_ext = proposal_ext
        self.feature_ext = feature_ext

    def __call__(self, results: Dict) -> Dict:
        name = results["video_name"]
        props = np.loadtxt(
            os.path.join(self.pgm_proposals_dir, name + self.proposal_ext),
            dtype=np.float32, delimiter=",", skiprows=1, ndmin=2)
        props = np.array(props[:self.top_k])
        feats = np.load(os.path.join(
            self.pgm_features_dir,
            name + self.feature_ext)).astype(np.float32)
        results["bsp_feature"] = feats[:self.top_k, :]
        results["tmin"] = props[:, 0]
        results["tmax"] = props[:, 1]
        results["tmin_score"] = props[:, 2]
        results["tmax_score"] = props[:, 3]
        results["reference_temporal_iou"] = props[:, 5]
        return results


def _proposal_bounds(proposal) -> Tuple[int, int]:
    if hasattr(proposal, "start_frame"):
        return proposal.start_frame, proposal.end_frame
    return proposal[0], proposal[1]


@PIPELINES.register("SampleProposalFrames")
class SampleProposalFrames:
    """loading.py:470-725: SSN-style three-stage (starting / course /
    ending) segment sampling around each proposal; whole-video strided
    sampling in test mode.  `out_proposals` entries are either reference
    ((rec, proposal), ...) nests, objects with start/end_frame, or plain
    (start, end) tuples."""

    def __init__(self, clip_len: int, body_segments: int,
                 aug_segments: Tuple[int, int], aug_ratio,
                 frame_interval: int = 1, test_interval: int = 6,
                 temporal_jitter: bool = False, mode: str = "train",
                 seed: Optional[int] = None):
        assert mode in ("train", "val", "test")
        self.clip_len = clip_len
        self.body_segments = body_segments
        self.aug_segments = tuple(aug_segments)
        if not isinstance(aug_ratio, (tuple, list)):
            aug_ratio = (aug_ratio, aug_ratio)
        self.aug_ratio = tuple(aug_ratio)
        self.frame_interval = frame_interval
        self.test_interval = test_interval
        self.temporal_jitter = temporal_jitter
        self.mode = mode
        self.rng = np.random.default_rng(seed)

    def _train_indices(self, valid_length: int, num_segments: int):
        avg = (valid_length + 1) // num_segments
        if avg > 0:
            base = np.arange(num_segments) * avg
            return base + self.rng.integers(0, avg, size=num_segments)
        return np.zeros((num_segments,), np.int64)

    @staticmethod
    def _val_indices(valid_length: int, num_segments: int):
        if valid_length >= num_segments:
            avg = valid_length / float(num_segments)
            return (np.arange(num_segments) * avg + avg / 2.0).astype(np.int64)
        return np.zeros((num_segments,), np.int64)

    def _proposal_clips(self, proposal, num_frames: int):
        start_frame, end_frame = _proposal_bounds(proposal)
        ori_clip_len = self.clip_len * self.frame_interval
        duration = end_frame - start_frame
        assert duration != 0
        valid_length = duration - ori_clip_len
        valid_starting = max(
            0, start_frame - int(duration * self.aug_ratio[0]))
        valid_ending = min(num_frames - ori_clip_len + 1,
                           end_frame - 1 + int(duration * self.aug_ratio[1]))
        valid_starting_length = start_frame - valid_starting - ori_clip_len
        valid_ending_length = (valid_ending - end_frame + 1) - ori_clip_len
        pick = (self._train_indices if self.mode == "train"
                else self._val_indices)
        starting = pick(valid_starting_length,
                        self.aug_segments[0]) + valid_starting
        course = pick(valid_length, self.body_segments) + start_frame
        ending = pick(valid_ending_length, self.aug_segments[1]) + end_frame
        return np.concatenate([starting, course, ending])

    def __call__(self, results: Dict) -> Dict:
        total_frames = results["total_frames"]
        if self.mode == "test":
            ori_clip_len = self.clip_len * self.frame_interval
            offsets = np.arange(0, total_frames - ori_clip_len,
                                self.test_interval, dtype=np.int64)
        else:
            proposals = results["out_proposals"]
            offsets = np.concatenate([
                self._proposal_clips(
                    p[0][1] if isinstance(p, (tuple, list))
                    and isinstance(p[0], (tuple, list)) else p, total_frames)
                for p in proposals])
        inds = (offsets[:, None]
                + np.arange(self.clip_len)[None, :] * self.frame_interval)
        inds = np.concatenate(inds)
        if self.temporal_jitter:
            inds = inds + self.rng.integers(0, self.frame_interval,
                                            size=len(inds))
        inds = np.mod(inds, total_frames) + results.get("start_index", 0)
        results["frame_inds"] = inds.astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = self.frame_interval
        results["num_clips"] = (self.body_segments + self.aug_segments[0]
                                + self.aug_segments[1])
        if self.mode in ("train", "val"):
            results["num_proposals"] = len(results["out_proposals"])
        return results


# -- pose / skeleton (pose_loading.py, formatting.py, augmentations.py) -----

@PIPELINES.register("UniformSampleFrames")
class UniformSampleFrames:
    """pose_loading.py:14-139: split into clip_len segments, one frame per
    segment; special cases below/near clip_len follow the reference exactly.
    Test mode draws from a fixed seed for reproducibility."""

    def __init__(self, clip_len: int, num_clips: int = 1,
                 test_mode: bool = False, seed: int = 255):
        self.clip_len = clip_len
        self.num_clips = num_clips
        self.test_mode = test_mode
        self.seed = seed
        self.rng = np.random.default_rng(None if not test_mode else seed)

    def _sample_once(self, num_frames: int, rng) -> np.ndarray:
        clip_len = self.clip_len
        if num_frames < clip_len:
            start = rng.integers(0, num_frames)
            return np.arange(start, start + clip_len)
        if num_frames < 2 * clip_len:
            basic = np.arange(clip_len)
            inds = rng.choice(clip_len + 1, num_frames - clip_len,
                              replace=False)
            offset = np.zeros(clip_len + 1, dtype=np.int64)
            offset[inds] = 1
            return basic + np.cumsum(offset)[:-1]
        bids = np.array([i * num_frames // clip_len
                         for i in range(clip_len + 1)])
        bsize = np.diff(bids)
        return bids[:clip_len] + rng.integers(0, bsize)

    def __call__(self, results: Dict) -> Dict:
        num_frames = results["total_frames"]
        if self.test_mode:
            rng = np.random.default_rng(self.seed)
            if num_frames < self.clip_len and num_frames < self.num_clips:
                starts = list(range(self.num_clips))
                inds = np.concatenate(
                    [np.arange(i, i + self.clip_len) for i in starts])
            elif num_frames < self.clip_len:
                starts = [i * num_frames // self.num_clips
                          for i in range(self.num_clips)]
                inds = np.concatenate(
                    [np.arange(i, i + self.clip_len) for i in starts])
            else:
                inds = np.concatenate([self._sample_once(num_frames, rng)
                                       for _ in range(self.num_clips)])
        else:
            assert self.num_clips == 1
            inds = self._sample_once(num_frames, self.rng)
        inds = np.mod(inds, num_frames) + results.get("start_index", 0)
        results["frame_inds"] = inds.astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = None
        results["num_clips"] = self.num_clips
        return results


@PIPELINES.register("PaddingWithLoop")
class PaddingWithLoop:
    """pose_loading.py:635-667: frames 0..clip_len looped over the video."""

    def __init__(self, clip_len: int, num_clips: int = 1):
        self.clip_len = clip_len
        self.num_clips = num_clips

    def __call__(self, results: Dict) -> Dict:
        inds = np.mod(np.arange(self.clip_len), results["total_frames"])
        results["frame_inds"] = inds.astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = None
        results["num_clips"] = self.num_clips
        return results


@PIPELINES.register("PoseDecode")
class PoseDecode:
    """pose_loading.py:142-196: gather keypoints (M, T, V, C) and scores
    (M, T, V) at frame_inds."""

    def __call__(self, results: Dict) -> Dict:
        if "frame_inds" not in results:
            results["frame_inds"] = np.arange(results["total_frames"])
        inds = np.asarray(results["frame_inds"])
        if inds.ndim != 1:   # reference guard (pose_loading.py:177):
            inds = np.squeeze(inds)   # a clip_len=1 (1,) keeps its axis
        inds = inds + results.get("offset", 0)
        if "keypoint_score" in results:
            results["keypoint_score"] = \
                results["keypoint_score"][:, inds].astype(np.float32)
        if "keypoint" in results:
            results["keypoint"] = \
                results["keypoint"][:, inds].astype(np.float32)
        return results


@PIPELINES.register("LoadKineticsPose")
class LoadKineticsPose:
    """pose_loading.py:199-343: unpack the per-detection (x, y, score)
    pickle into dense (num_person, T, V, 2) + scores, squeezing empty
    frames and dropping low-confidence persons beyond max_person by the
    face/torso/limb-weighted score."""

    _SUBSETS = {
        "openpose-18": dict(face=[0, 14, 15, 16, 17], torso=[1, 2, 8, 5, 11],
                            limb=[3, 4, 6, 7, 9, 10, 12, 13]),
        "mmpose": dict(face=[0, 1, 2, 3, 4], torso=[5, 6, 11, 12],
                       limb=[7, 8, 9, 10, 13, 14, 15, 16]),
    }

    def __init__(self, squeeze: bool = True, max_person: int = 100,
                 keypoint_weight: Optional[Dict] = None,
                 source: str = "mmpose"):
        if source not in self._SUBSETS:
            raise NotImplementedError(source)
        self.squeeze = squeeze
        self.max_person = max_person
        self.weight = dict(keypoint_weight or dict(face=1, torso=2, limb=3))
        self.source = source
        self.kpsubset = self._SUBSETS[source]

    def __call__(self, results: Dict) -> Dict:
        filename = results.pop("filename")
        anno_inds = results.pop("anno_inds", None)
        results.pop("box_score", None)
        with open(filename, "rb") as f:
            kps = pickle.load(f)
        total_frames = results["total_frames"]
        frame_inds = np.asarray(results.pop("frame_inds"))
        if anno_inds is not None:
            assert self.source == "mmpose"
            kps = kps[anno_inds]
            frame_inds = frame_inds[anno_inds]
        if self.squeeze:
            uni = {x: i for i, x in enumerate(np.unique(frame_inds))}
            frame_inds = np.array([uni[x] for x in frame_inds], np.int64)
            total_frames = int(frame_inds.max()) + 1
        results["total_frames"] = total_frames

        h, w = results["img_shape"]
        kps = np.asarray(kps, np.float32).copy()
        if self.source == "openpose-18":
            kps[:, :, 0] *= w
            kps[:, :, 1] *= h

        num_kp = kps.shape[1]
        counts = np.bincount(frame_inds, minlength=total_frames)
        num_person = int(counts.max()) if counts.size else 0
        new_kp = np.zeros([num_person, total_frames, num_kp, 2], np.float16)
        new_score = np.zeros([num_person, total_frames, num_kp], np.float16)
        cursor = np.zeros([total_frames], np.int64)
        for fi, kp in zip(frame_inds, kps):
            p = cursor[fi]
            new_kp[p, fi] = kp[:, :2]
            new_score[p, fi] = kp[:, 2]
            cursor[fi] += 1

        results["num_person"] = num_person
        if num_person > self.max_person:
            grp, wt = self.kpsubset, self.weight
            for i in range(total_frames):
                n = cursor[i]
                val = new_score[:n, i].astype(np.float32)
                score = (val[:, grp["face"]].sum(1) * wt["face"]
                         + val[:, grp["torso"]].sum(1) * wt["torso"]
                         + val[:, grp["limb"]].sum(1) * wt["limb"])
                order = np.argsort(-score)
                new_score[:n, i] = new_score[order, i]
                new_kp[:n, i] = new_kp[order, i]
            results["num_person"] = self.max_person
        results["keypoint"] = new_kp[:self.max_person]
        results["keypoint_score"] = new_score[:self.max_person]
        return results


@PIPELINES.register("PoseNormalize")
class PoseNormalize:
    """pose_loading.py:670-698: (kp - mean) / (max - min) per channel."""

    def __init__(self, mean=(960.0, 540.0, 0.5), min_value=(0.0, 0.0, 0.0),
                 max_value=(1920.0, 1080.0, 1.0)):
        shape = (-1, 1, 1, 1)
        self.mean = np.asarray(mean, np.float32).reshape(shape)
        self.min_value = np.asarray(min_value, np.float32).reshape(shape)
        self.max_value = np.asarray(max_value, np.float32).reshape(shape)

    def __call__(self, results: Dict) -> Dict:
        kp = results["keypoint"]
        results["keypoint"] = (kp - self.mean) / (self.max_value
                                                  - self.min_value)
        results["keypoint_norm_cfg"] = dict(
            mean=self.mean, min_value=self.min_value,
            max_value=self.max_value)
        return results


@PIPELINES.register("PoseCompact")
class PoseCompact:
    """augmentations.py:169-290: shrink img_shape to the padded tight box
    around all joints; zero coordinates mark missing joints and are kept
    out of the box (and left untranslated)."""

    def __init__(self, padding: float = 0.25, threshold: int = 10,
                 hw_ratio=None, allow_imgpad: bool = True):
        assert padding >= 0
        self.padding = padding
        self.threshold = threshold
        if hw_ratio is not None and not isinstance(hw_ratio, (tuple, list)):
            hw_ratio = (hw_ratio, hw_ratio)
        self.hw_ratio = hw_ratio
        self.allow_imgpad = allow_imgpad

    def __call__(self, results: Dict) -> Dict:
        h, w = results["img_shape"]
        kp = results["keypoint"]
        kp[np.isnan(kp)] = 0.0
        kp_x, kp_y = kp[..., 0], kp[..., 1]
        if not (kp_x != 0).any() or not (kp_y != 0).any():
            return results
        min_x, max_x = np.min(kp_x[kp_x != 0]), np.max(kp_x[kp_x != 0])
        min_y, max_y = np.min(kp_y[kp_y != 0]), np.max(kp_y[kp_y != 0])
        if max_x - min_x < self.threshold or max_y - min_y < self.threshold:
            return results
        center = ((max_x + min_x) / 2, (max_y + min_y) / 2)
        half_w = (max_x - min_x) / 2 * (1 + self.padding)
        half_h = (max_y - min_y) / 2 * (1 + self.padding)
        if self.hw_ratio is not None:
            half_h = max(self.hw_ratio[0] * half_w, half_h)
            half_w = max(1 / self.hw_ratio[1] * half_h, half_w)
        min_x, max_x = center[0] - half_w, center[0] + half_w
        min_y, max_y = center[1] - half_h, center[1] + half_h
        if not self.allow_imgpad:
            min_x, min_y = int(max(0, min_x)), int(max(0, min_y))
            max_x, max_y = int(min(w, max_x)), int(min(h, max_y))
        else:
            min_x, min_y = int(min_x), int(min_y)
            max_x, max_y = int(max_x), int(max_y)
        kp_x[kp_x != 0] -= min_x
        kp_y[kp_y != 0] -= min_y
        results["img_shape"] = (max_y - min_y, max_x - min_x)
        quad = results.get("crop_quadruple", (0.0, 0.0, 1.0, 1.0))
        results["crop_quadruple"] = _combine_quadruple(
            quad, (min_x / w, min_y / h, (max_x - min_x) / w,
                   (max_y - min_y) / h))
        return results


@PIPELINES.register("JointToBone")
class JointToBone:
    """formatting.py:378-434: bone[v1] = kp[v1] - kp[v2] over the skeleton
    pairs; 3-channel coco/openpose keeps the averaged score."""

    _PAIRS = {
        "nturgb+d": [(0, 1), (1, 20), (2, 20), (3, 2), (4, 20), (5, 4),
                     (6, 5), (7, 6), (8, 20), (9, 8), (10, 9), (11, 10),
                     (12, 0), (13, 12), (14, 13), (15, 14), (16, 0),
                     (17, 16), (18, 17), (19, 18), (21, 22), (20, 20),
                     (22, 7), (23, 24), (24, 11)],
        "openpose-18": [(0, 0), (1, 0), (2, 1), (3, 2), (4, 3), (5, 1),
                        (6, 5), (7, 6), (8, 2), (9, 8), (10, 9), (11, 5),
                        (12, 11), (13, 12), (14, 0), (15, 0), (16, 14),
                        (17, 15)],
        "coco": [(0, 0), (1, 0), (2, 0), (3, 1), (4, 2), (5, 0), (6, 0),
                 (7, 5), (8, 6), (9, 7), (10, 8), (11, 0), (12, 0),
                 (13, 11), (14, 12), (15, 13), (16, 14)],
    }

    def __init__(self, dataset: str = "nturgb+d"):
        if dataset not in self._PAIRS:
            raise ValueError(dataset)
        self.dataset = dataset
        self.pairs = self._PAIRS[dataset]

    def __call__(self, results: Dict) -> Dict:
        kp = results["keypoint"]
        m, t, v, c = kp.shape
        assert c in (2, 3)
        bone = np.zeros((m, t, v, c), np.float32)
        for v1, v2 in self.pairs:
            bone[..., v1, :] = kp[..., v1, :] - kp[..., v2, :]
            if c == 3 and self.dataset in ("openpose-18", "coco"):
                bone[..., v1, 2] = (kp[..., v1, 2] + kp[..., v2, 2]) / 2
        results["keypoint"] = bone
        return results


@PIPELINES.register("FormatGCNInput")
class FormatGCNInput:
    """formatting.py:438-500: (M, T, V, C[+score]) -> NCTVM padded/truncated
    to num_person."""

    def __init__(self, input_format: str = "NCTVM", num_person: int = 2):
        assert input_format == "NCTVM"
        self.num_person = num_person

    def __call__(self, results: Dict) -> Dict:
        kp = results["keypoint"]
        if "keypoint_score" in results:
            kp = np.concatenate(
                [kp, results["keypoint_score"][..., None]], axis=-1)
        kp = np.transpose(kp, (3, 1, 2, 0))  # M T V C -> C T V M
        if kp.shape[-1] < self.num_person:
            pad = np.zeros(kp.shape[:-1] + (self.num_person - kp.shape[-1],),
                           kp.dtype)
            kp = np.concatenate([kp, pad], axis=-1)
        elif kp.shape[-1] > self.num_person:
            kp = kp[..., :self.num_person]
        results["keypoint"] = kp
        results["input_shape"] = kp.shape
        return results


@PIPELINES.register("GeneratePoseTarget")
class GeneratePoseTarget:
    """pose_loading.py:346-633: gaussian keypoint (and limb-segment)
    pseudo-heatmaps, max-combined over persons, stacked (T, H, W, K)."""

    COCO_SKELETONS = ((0, 1), (0, 2), (1, 3), (2, 4), (0, 5), (5, 7), (7, 9),
                      (0, 6), (6, 8), (8, 10), (5, 11), (11, 13), (13, 15),
                      (6, 12), (12, 14), (14, 16), (11, 12))

    def __init__(self, sigma: float = 0.6, use_score: bool = True,
                 with_kp: bool = True, with_limb: bool = False,
                 skeletons: Sequence[Tuple[int, int]] = COCO_SKELETONS,
                 double: bool = False,
                 left_kp=(1, 3, 5, 7, 9, 11, 13, 15),
                 right_kp=(2, 4, 6, 8, 10, 12, 14, 16)):
        assert with_kp or with_limb
        self.sigma = sigma
        self.use_score = use_score
        self.with_kp = with_kp
        self.with_limb = with_limb
        self.skeletons = skeletons
        self.double = double
        self.left_kp = left_kp
        self.right_kp = right_kp
        self.eps = 1e-4

    def _kp_heatmap(self, h, w, centers, max_values):
        heatmap = np.zeros([h, w], np.float32)
        sigma = self.sigma
        for center, max_value in zip(centers, max_values):
            if max_value < self.eps:
                continue
            mu_x, mu_y = center[0], center[1]
            st_x, ed_x = max(int(mu_x - 3 * sigma), 0), \
                min(int(mu_x + 3 * sigma) + 1, w)
            st_y, ed_y = max(int(mu_y - 3 * sigma), 0), \
                min(int(mu_y + 3 * sigma) + 1, h)
            x = np.arange(st_x, ed_x, 1, np.float32)
            y = np.arange(st_y, ed_y, 1, np.float32)[:, None]
            if not (x.size and y.size):
                continue
            patch = np.exp(-((x - mu_x) ** 2 + (y - mu_y) ** 2)
                           / 2 / sigma ** 2) * max_value
            heatmap[st_y:ed_y, st_x:ed_x] = np.maximum(
                heatmap[st_y:ed_y, st_x:ed_x], patch)
        return heatmap

    def _limb_heatmap(self, h, w, starts, ends, svals, evals):
        heatmap = np.zeros([h, w], np.float32)
        sigma = self.sigma
        for start, end, sv, ev in zip(starts, ends, svals, evals):
            coeff_v = min(sv, ev)
            if coeff_v < self.eps:
                continue
            min_x = max(int(min(start[0], end[0]) - 3 * sigma), 0)
            max_x = min(int(max(start[0], end[0]) + 3 * sigma) + 1, w)
            min_y = max(int(min(start[1], end[1]) - 3 * sigma), 0)
            max_y = min(int(max(start[1], end[1]) + 3 * sigma) + 1, h)
            x = np.arange(min_x, max_x, 1, np.float32)
            y = np.arange(min_y, max_y, 1, np.float32)[:, None]
            if not (x.size and y.size):
                continue
            d2_start = (x - start[0]) ** 2 + (y - start[1]) ** 2
            d2_end = (x - end[0]) ** 2 + (y - end[1]) ** 2
            d2_ab = (start[0] - end[0]) ** 2 + (start[1] - end[1]) ** 2
            if d2_ab < 1:
                heatmap = np.maximum(
                    heatmap, self._kp_heatmap(h, w, [start], [sv]))
                continue
            coeff = (d2_start - d2_end + d2_ab) / 2.0 / d2_ab
            a_dom, b_dom = coeff <= 0, coeff >= 1
            seg_dom = 1 - a_dom - b_dom
            pos = np.stack(np.broadcast_arrays(x, y), -1)
            proj = start + coeff[..., None] * (end - start)
            d2_line = ((pos - proj) ** 2).sum(-1)
            d2_seg = a_dom * d2_start + b_dom * d2_end + seg_dom * d2_line
            patch = np.exp(-d2_seg / 2.0 / sigma ** 2) * coeff_v
            heatmap[min_y:max_y, min_x:max_x] = np.maximum(
                heatmap[min_y:max_y, min_x:max_x], patch)
        return heatmap

    def _frame(self, h, w, kps, max_values):
        maps = []
        if self.with_kp:
            for i in range(kps.shape[1]):
                maps.append(self._kp_heatmap(h, w, kps[:, i],
                                             max_values[:, i]))
        if self.with_limb:
            for s, e in self.skeletons:
                maps.append(self._limb_heatmap(
                    h, w, kps[:, s], kps[:, e],
                    max_values[:, s], max_values[:, e]))
        return np.stack(maps, axis=-1)

    def _gen(self, results):
        kps = results["keypoint"]
        scores = results.get(
            "keypoint_score", np.ones(kps.shape[:-1], np.float32))
        h, w = results["img_shape"]
        out = []
        for t in range(kps.shape[1]):
            mv = scores[:, t] if self.use_score else \
                np.ones(scores[:, t].shape, np.float32)
            out.append(self._frame(h, w, kps[:, t].astype(np.float32),
                                   mv.astype(np.float32)))
        return out

    def __call__(self, results: Dict) -> Dict:
        if not self.double:
            results["imgs"] = np.stack(self._gen(results))
            return results
        import copy
        flipped = copy.deepcopy(results)
        _, w = results["img_shape"]
        kp = flipped["keypoint"].copy()
        kp[..., 0] = w - kp[..., 0]
        order = list(range(kp.shape[2]))
        for l, r in zip(self.left_kp, self.right_kp):
            order[l], order[r] = order[r], order[l]
        flipped["keypoint"] = kp[:, :, order]
        results["imgs"] = np.concatenate(
            [self._gen(results), self._gen(flipped)])
        return results

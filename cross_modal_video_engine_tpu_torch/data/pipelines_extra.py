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

The audio and pose ops come with ROADMAP.md queue 1 items 8g and 8h
(data/pipelines.UNPORTED_OPS).
"""

from __future__ import annotations

import os
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

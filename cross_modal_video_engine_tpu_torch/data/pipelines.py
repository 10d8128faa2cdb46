"""Host-side data pipeline ops (frame sampling and geometric augmentation).

Counterpart of cross_modal_video_engine_tpu/data/pipelines.py: the same
18 ops on the same `results` dict, registered under the same names, so
one config drives both packages:

  SampleFrames / DenseSampleFrames / UntrimmedSampleFrames -> frame_inds
  RandomShuffleFrames / Resize / CenterCrop / RandomResizedCrop /
  MultiScaleCrop / ThreeCrop / TenCrop / Flip / ColorJitter /
  TorchvisionTrans / ImgaugTrans / PytorchVideoTrans / Normalize /
  FormatShape / MergeClips

Each random op keeps its own `np.random.default_rng(seed)`, so for one
seed both packages draw the same numbers.

The JAX package resizes with `cv2.resize(..., INTER_LINEAR)`.  The port
never calls OpenCV for it (the card's machine has none): `resize_linear`
is the same bilinear resize in numpy, and on uint8 frames it reproduces
OpenCV's fixed-point arithmetic bit for bit (11-bit weights, the
vertical pass rounded as OpenCV's SIMD path rounds it), so the CPU, the
card's machine and the JAX package see the same pixels.  The three
adapters of outside libraries import them on first use and raise
ImportError where they are missing.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..utils.registry import PIPELINES

# OpenCV's INTER_LINEAR fixed point for 8-bit images: weights in 11 bits
_COEF_SCALE = 2048


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """Per destination index along one axis: the two source indices
    (clamped to the image) and their weights, as OpenCV computes them: the
    source coordinate in float32 from a double scale, its floor, and the
    fraction.  clamp_weights: at the borders the horizontal axis also sets
    the fraction to 0 (a one-tap copy of the edge pixel); the vertical
    axis keeps the fraction and clamps only the row indices.  Returns
    (s0, s1, f) with f float32."""
    scale = src / dst
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low, high = s < 0, s >= src - 1
        s = np.where(low, 0, np.where(high, src - 1, s))
        f = np.where(low | high, np.float32(0), f)
    s0 = np.clip(s, 0, src - 1)
    s1 = np.clip(s + 1, 0, src - 1)
    return s0, s1, f


def _int_weights(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(1 - f, f) in 11 bits, rounded half to even as OpenCV's
    saturate_cast rounds them."""
    one = np.float32(1)
    scale = np.float32(_COEF_SCALE)
    return (np.rint((one - f) * scale).astype(np.int32),
            np.rint(f * scale).astype(np.int32))


def resize_linear(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of (..., H, W, C) frames to size = (w, h), as
    `cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)` resizes
    each frame.  uint8 frames take OpenCV's fixed-point path exactly: the
    horizontal pass S = p0 a0 + p1 a1 in integers, the vertical pass
    ((((S0 >> 4) b0) >> 16) + (((S1 >> 4) b1) >> 16) + 2) >> 2, all in
    int32 (S >> 4 <= 32640, so the result is at most 255).  Other dtypes
    compute in float32 with the same taps and keep their dtype (OpenCV's
    float path rounds otherwise: within 0.02 on the 0-255 scale).  Only
    the source rows the vertical taps read go through the horizontal
    pass."""
    frames = np.asarray(frames)
    new_w, new_h = int(size[0]), int(size[1])
    h, w, c = frames.shape[-3:]
    if (new_h, new_w) == (h, w):
        return frames.copy()
    x0, x1, fx = _linear_taps(w, new_w, clamp_weights=True)
    y0, y1, fy = _linear_taps(h, new_h, clamp_weights=False)
    need = np.unique(np.concatenate([y0, y1]))
    y0, y1 = np.searchsorted(need, y0), np.searchsorted(need, y1)
    # pixels of (W, C) as one axis: each tap gathers whole pixels
    ch = np.arange(c)
    i0 = (x0[:, None] * c + ch).ravel()
    i1 = (x1[:, None] * c + ch).ravel()
    flat = np.take(frames, need, axis=-3).reshape(
        frames.shape[:-3] + (len(need), w * c))
    p0, p1 = np.take(flat, i0, axis=-1), np.take(flat, i1, axis=-1)
    if frames.dtype == np.uint8:
        a0, a1 = (np.repeat(a, c) for a in _int_weights(fx))
        b0, b1 = _int_weights(fy)
        rows = (p0.astype(np.int32) * a0 + p1.astype(np.int32) * a1) >> 4
        out = (((np.take(rows, y0, axis=-2) * b0[:, None]) >> 16)
               + ((np.take(rows, y1, axis=-2) * b1[:, None]) >> 16)
               + 2) >> 2
    else:
        one = np.float32(1)
        a1 = np.repeat(fx, c)
        rows = (p0.astype(np.float32) * (one - a1)
                + p1.astype(np.float32) * a1)
        out = (np.take(rows, y0, axis=-2) * (one - fy)[:, None]
               + np.take(rows, y1, axis=-2) * fy[:, None])
    return out.astype(frames.dtype).reshape(
        frames.shape[:-3] + (new_h, new_w, c))


def _resize_frames(imgs, size: Tuple[int, int]) -> list:
    """A list of same-shape frames resized together (one numpy pass)."""
    return list(resize_linear(np.stack(imgs), size))


@PIPELINES.register("SampleFrames")
class SampleFrames:
    """mmaction loading.py:83-271 semantics (_get_train_clips,
    _get_test_clips)."""

    def __init__(self, clip_len: int, frame_interval: int = 1,
                 num_clips: int = 1, temporal_jitter: bool = False,
                 twice_sample: bool = False, out_of_bound_opt: str = "loop",
                 test_mode: bool = False, keep_tail_frames: bool = False,
                 seed: int | None = None):
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.temporal_jitter = temporal_jitter
        self.twice_sample = twice_sample
        self.out_of_bound_opt = out_of_bound_opt
        self.test_mode = test_mode
        self.keep_tail_frames = keep_tail_frames
        self.rng = np.random.default_rng(seed)

    def _get_train_clips(self, num_frames: int) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        if self.keep_tail_frames:
            avg_interval = (num_frames - ori_clip_len + 1) / float(self.num_clips)
            if num_frames > ori_clip_len - 1:
                base = np.arange(self.num_clips) * avg_interval
                return (base + self.rng.uniform(0, avg_interval,
                                                self.num_clips)).astype(np.int64)
            return np.zeros((self.num_clips,), np.int64)
        avg_interval = (num_frames - ori_clip_len + 1) // self.num_clips
        if avg_interval > 0:
            base = np.arange(self.num_clips) * avg_interval
            return base + self.rng.integers(0, avg_interval, self.num_clips)
        if num_frames > max(self.num_clips, ori_clip_len):
            return np.sort(self.rng.integers(
                0, num_frames - ori_clip_len + 1, self.num_clips))
        if avg_interval == 0:
            ratio = (num_frames - ori_clip_len + 1.0) / self.num_clips
            return np.around(np.arange(self.num_clips) * ratio).astype(np.int64)
        return np.zeros((self.num_clips,), np.int64)

    def _get_test_clips(self, num_frames: int) -> np.ndarray:
        ori_clip_len = self.clip_len * self.frame_interval
        avg_interval = (num_frames - ori_clip_len + 1) / float(self.num_clips)
        if num_frames > ori_clip_len - 1:
            base = np.arange(self.num_clips) * avg_interval
            offsets = (base + avg_interval / 2.0).astype(np.int64)
            if self.twice_sample:
                offsets = np.concatenate([offsets, base.astype(np.int64)])
            return offsets
        return np.zeros((self.num_clips,), np.int64)

    def __call__(self, results: Dict) -> Dict:
        total_frames = results["total_frames"]
        offsets = (self._get_test_clips(total_frames) if self.test_mode
                   else self._get_train_clips(total_frames))
        inds = offsets[:, None] + np.arange(self.clip_len)[None, :] * \
            self.frame_interval
        inds = np.concatenate(inds)
        if self.temporal_jitter:
            inds += self.rng.integers(0, self.frame_interval, len(inds))
        inds = inds.reshape((-1, self.clip_len))
        if self.out_of_bound_opt == "loop":
            inds = np.mod(inds, total_frames)
        elif self.out_of_bound_opt == "repeat_last":
            safe = inds < total_frames
            last = np.max(np.where(safe, inds, 0), axis=1)
            inds = np.where(safe, inds, last[:, None])
        else:
            raise ValueError(self.out_of_bound_opt)
        inds = np.concatenate(inds) + results.get("start_index", 0)
        results["frame_inds"] = inds.astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = self.frame_interval
        results["num_clips"] = (self.num_clips * 2 if
                                (self.test_mode and self.twice_sample)
                                else self.num_clips)
        return results


@PIPELINES.register("DenseSampleFrames")
class DenseSampleFrames(SampleFrames):
    """loading.py:332-430: dense sampling from a 64-frame window."""

    def __init__(self, *args, sample_range: int = 64,
                 num_sample_positions: int = 10, **kwargs):
        super().__init__(*args, **kwargs)
        self.sample_range = sample_range
        self.num_sample_positions = num_sample_positions

    def _get_train_clips(self, num_frames: int) -> np.ndarray:
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        start_idx = 0 if sample_position == 1 else \
            self.rng.integers(0, sample_position)
        base = np.arange(self.num_clips) * interval
        return (base + start_idx) % num_frames

    def _get_test_clips(self, num_frames: int) -> np.ndarray:
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        start_list = np.linspace(0, sample_position - 1,
                                 self.num_sample_positions, dtype=np.int64)
        base = np.arange(self.num_clips) * interval
        return np.concatenate([(base + s) % num_frames for s in start_list])


@PIPELINES.register("UntrimmedSampleFrames")
class UntrimmedSampleFrames:
    """loading.py:273-330: fixed-interval sampling over the whole video."""

    def __init__(self, clip_len: int = 1, frame_interval: int = 16,
                 start_index: int = 0):
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.start_index = start_index

    def __call__(self, results: Dict) -> Dict:
        total_frames = results["total_frames"]
        start_index = results.get("start_index", self.start_index)
        clip_centers = np.arange(self.frame_interval // 2, total_frames,
                                 self.frame_interval)
        num_clips = clip_centers.shape[0]
        inds = clip_centers[:, None] + np.arange(
            -(self.clip_len // 2), self.clip_len - (self.clip_len // 2))[None, :]
        inds = np.clip(inds, 0, total_frames - 1)
        results["frame_inds"] = np.concatenate(inds).astype(np.int64) + start_index
        results["clip_len"] = self.clip_len
        results["frame_interval"] = self.frame_interval
        results["num_clips"] = num_clips
        return results


@PIPELINES.register("RandomShuffleFrames")
class RandomShuffleFrames:
    """augmentations.py:1224: temporal-shuffle probe for interpretability;
    records the permutation in results['shuffle_idx']."""

    def __init__(self, seed: int | None = None, shuffle_idx=None):
        self.rng = np.random.default_rng(seed)
        self.shuffle_idx = shuffle_idx

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        n = len(imgs)
        idx = (np.asarray(self.shuffle_idx) if self.shuffle_idx is not None
               else self.rng.permutation(n))
        results["imgs"] = [imgs[i] for i in idx]
        results["shuffle_idx"] = idx
        return results


@PIPELINES.register("Resize")
class Resize:
    """augmentations.py:1041: scale=(-1, N) means short side N, keeping
    the aspect ratio."""

    def __init__(self, scale, keep_ratio: bool = True):
        self.scale = tuple(scale) if isinstance(scale, (list, tuple)) else (scale,)
        self.keep_ratio = keep_ratio

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        h, w = imgs[0].shape[:2]
        if self.keep_ratio and self.scale[0] == -1:
            short = self.scale[1]
            if w <= h:
                new_w, new_h = short, int(round(h * short / w))
            else:
                new_w, new_h = int(round(w * short / h)), short
        elif self.keep_ratio and len(self.scale) == 2:
            # mmcv rescale_size: (w, h) is a MAX box when keep_ratio —
            # scale so both edges fit, preserving aspect; stretching to
            # the exact size is keep_ratio=False
            mw, mh = self.scale
            f = min(max(mw, mh) / max(h, w), min(mw, mh) / min(h, w))
            new_w, new_h = int(w * f + 0.5), int(h * f + 0.5)
        elif len(self.scale) == 2:
            new_w, new_h = self.scale
        else:
            new_w = new_h = self.scale[0]
        results["imgs"] = _resize_frames(imgs, (new_w, new_h))
        results["img_shape"] = (new_h, new_w)
        return results


@PIPELINES.register("CenterCrop")
class CenterCrop:
    def __init__(self, crop_size: int):
        self.crop_size = crop_size

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        h, w = imgs[0].shape[:2]
        c = self.crop_size
        y0 = (h - c) // 2
        x0 = (w - c) // 2
        results["imgs"] = [im[y0:y0 + c, x0:x0 + c] for im in imgs]
        results["img_shape"] = (c, c)
        return results


@PIPELINES.register("RandomResizedCrop")
class RandomResizedCrop:
    """A random crop of random area and aspect ratio (a later Resize sizes
    it, as in the JAX package); a center crop after ten misses."""

    def __init__(self, area_range=(0.08, 1.0), aspect_ratio_range=(3 / 4, 4 / 3),
                 seed: int | None = None):
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.rng = np.random.default_rng(seed)

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        h, w = imgs[0].shape[:2]
        area = h * w
        for _ in range(10):
            target_area = self.rng.uniform(*self.area_range) * area
            ar = np.exp(self.rng.uniform(np.log(self.aspect_ratio_range[0]),
                                         np.log(self.aspect_ratio_range[1])))
            cw = int(round(np.sqrt(target_area * ar)))
            ch = int(round(np.sqrt(target_area / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = self.rng.integers(0, w - cw + 1)
                y0 = self.rng.integers(0, h - ch + 1)
                results["imgs"] = [im[y0:y0 + ch, x0:x0 + cw] for im in imgs]
                results["img_shape"] = (ch, cw)
                return results
        return CenterCrop(min(h, w))(results)


@PIPELINES.register("MultiScaleCrop")
class MultiScaleCrop:
    """augmentations.py MultiScaleCrop: pick a scale pair from `scales`,
    crop at one of 5 fixed offsets (or anywhere with random_crop), resize
    to input_size."""

    def __init__(self, input_size: int, scales=(1.0, 0.875, 0.75, 0.66),
                 max_wh_scale_gap: int = 1, random_crop: bool = False,
                 seed: int | None = None):
        self.input_size = input_size
        self.scales = scales
        self.max_gap = max_wh_scale_gap
        self.random_crop = random_crop
        self.rng = np.random.default_rng(seed)

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        h, w = imgs[0].shape[:2]
        base = min(h, w)
        sizes = [int(base * s) for s in self.scales]
        pairs = [(i, j) for i in range(len(sizes)) for j in range(len(sizes))
                 if abs(i - j) <= self.max_gap]
        i, j = pairs[self.rng.integers(0, len(pairs))]
        cw, ch = sizes[i], sizes[j]
        if self.random_crop:
            x0 = self.rng.integers(0, w - cw + 1)
            y0 = self.rng.integers(0, h - ch + 1)
        else:
            cands = [(0, 0), (w - cw, 0), (0, h - ch), (w - cw, h - ch),
                     ((w - cw) // 2, (h - ch) // 2)]
            x0, y0 = cands[self.rng.integers(0, len(cands))]
        crop = [im[y0:y0 + ch, x0:x0 + cw] for im in imgs]
        results["imgs"] = _resize_frames(crop, (self.input_size,
                                                self.input_size))
        results["img_shape"] = (self.input_size, self.input_size)
        return results


@PIPELINES.register("ThreeCrop")
class ThreeCrop:
    """augmentations.py:1706: 3 crops along the long side; frames triple."""

    def __init__(self, crop_size: int):
        self.crop_size = crop_size

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        h, w = imgs[0].shape[:2]
        c = self.crop_size
        if w >= h:
            offsets = [(0, 0), ((w - c) // 2, 0), (w - c, 0)]
        else:
            offsets = [(0, 0), (0, (h - c) // 2), (0, h - c)]
        out = []
        for x0, y0 in offsets:
            out.extend(im[y0:y0 + c, x0:x0 + c] for im in imgs)
        results["imgs"] = out
        results["num_crops"] = 3
        results["img_shape"] = (c, c)
        return results


@PIPELINES.register("TenCrop")
class TenCrop:
    """augmentations.py:1779: 4 corners + center, plus their flips."""

    def __init__(self, crop_size: int):
        self.crop_size = crop_size

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        h, w = imgs[0].shape[:2]
        c = self.crop_size
        offsets = [(0, 0), (w - c, 0), (0, h - c), (w - c, h - c),
                   ((w - c) // 2, (h - c) // 2)]
        out = []
        for x0, y0 in offsets:
            crops = [im[y0:y0 + c, x0:x0 + c] for im in imgs]
            out.extend(crops)
            out.extend(np.ascontiguousarray(cr[:, ::-1]) for cr in crops)
        results["imgs"] = out
        results["num_crops"] = 10
        results["img_shape"] = (c, c)
        return results


@PIPELINES.register("Flip")
class Flip:
    def __init__(self, flip_ratio: float = 0.5, seed: int | None = None):
        self.flip_ratio = flip_ratio
        self.rng = np.random.default_rng(seed)

    def __call__(self, results: Dict) -> Dict:
        flip = self.rng.random() < self.flip_ratio
        results["flip"] = flip
        if flip:
            results["imgs"] = [np.ascontiguousarray(im[:, ::-1])
                               for im in results["imgs"]]
            # mirror x1y1x2y2 boxes in their declared frame: normalized
            # [0,1] (the AVA convention, the default) or pixel coords
            normalized = results.get("bbox_coords", "normalized") \
                == "normalized"
            w_img = results["imgs"][0].shape[1]
            for key in ("gt_bboxes", "proposals"):
                if results.get(key) is not None and len(results[key]):
                    b = np.asarray(results[key], np.float32).copy()
                    span = 1.0 if normalized else float(w_img)
                    b[:, [0, 2]] = span - b[:, [2, 0]]
                    results[key] = b
        return results


@PIPELINES.register("ColorJitter")
class ColorJitter:
    """Photometric jitter per clip (reference augmentations.py:1509-1599):
    per-clip factors drawn uniformly, applied in a random-but-fixed op
    order; contrast/saturation blend against the Rec601 grayscale;
    brightness is a plain scale; hue rotates the hue channel cyclically
    (numpy HSV, 0..180 wrap semantics)."""

    def __init__(self, brightness=0.5, contrast=0.5, saturation=0.5,
                 hue=0.1, seed: int | None = None):
        def rng_range(val, lim, base):
            if isinstance(val, (tuple, list)):
                if not base - lim <= val[0] <= val[1] <= base + lim:
                    raise ValueError(f"range {val} outside {base} +- {lim}")
                return tuple(val)
            if val > lim:
                raise ValueError(f"{val} above {lim}")
            return (base - val, base + val)

        self.brightness = rng_range(brightness, 1, 1)
        self.contrast = rng_range(contrast, 1, 1)
        self.saturation = rng_range(saturation, 1, 1)
        self.hue = rng_range(hue, 0.5, 0)
        self.rng = np.random.default_rng(seed)
        self.fn_order = self.rng.permutation(4)

    @staticmethod
    def rgb_to_grayscale(img):
        return (0.2989 * img[..., 0] + 0.587 * img[..., 1]
                + 0.114 * img[..., 2])

    @classmethod
    def adjust_contrast(cls, img, factor):
        return factor * img + (1 - factor) * cls.rgb_to_grayscale(img).mean()

    @classmethod
    def adjust_saturation(cls, img, factor):
        gray = cls.rgb_to_grayscale(img)[..., None]
        return factor * img + (1 - factor) * gray

    @staticmethod
    def adjust_hue(img, factor):
        img = np.clip(img, 0, 255) / 255.0
        mx, mn = img.max(-1), img.min(-1)
        diff = mx - mn
        safe = np.where(diff == 0, 1.0, diff)
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        h = np.where(mx == r, (g - b) / safe % 6,
                     np.where(mx == g, (b - r) / safe + 2,
                              (r - g) / safe + 4)) / 6.0
        h = np.where(diff == 0, 0.0, h)
        s = np.where(mx == 0, 0.0, diff / np.where(mx == 0, 1.0, mx))
        h = (h + factor) % 1.0
        # hsv -> rgb
        i = np.floor(h * 6).astype(int) % 6
        f = h * 6 - np.floor(h * 6)
        p, q, t = mx * (1 - s), mx * (1 - f * s), mx * (1 - (1 - f) * s)
        lut = np.stack([
            np.stack([mx, t, p], -1), np.stack([q, mx, p], -1),
            np.stack([p, mx, t], -1), np.stack([p, q, mx], -1),
            np.stack([t, p, mx], -1), np.stack([mx, p, q], -1)], 0)
        out = np.take_along_axis(lut, i[None, ..., None], axis=0)[0]
        return (out * 255.0).astype(np.float32)

    def __call__(self, results: Dict) -> Dict:
        b = self.rng.uniform(*self.brightness)
        c = self.rng.uniform(*self.contrast)
        s = self.rng.uniform(*self.saturation)
        h = self.rng.uniform(*self.hue)
        new_imgs = []
        for img in results["imgs"]:
            img = img.astype(np.float32)
            for fn_id in self.fn_order:
                if fn_id == 0 and b != 1:
                    img = img * b
                elif fn_id == 1 and c != 1:
                    img = self.adjust_contrast(img, c)
                elif fn_id == 2 and s != 1:
                    img = self.adjust_saturation(img, s)
                elif fn_id == 3 and h != 0:
                    img = self.adjust_hue(img, h)
            new_imgs.append(np.clip(img, 0, 255).astype(np.float32))
        results["imgs"] = new_imgs
        return results


class _ExternalTrans:
    """Adapter applying an outside library's per-image transform to the
    img list (reference augmentations.py Imgaug/Torchvision/PytorchVideo
    adapters).  The library is imported when the op is built, so where it
    is missing the pipeline's build raises ImportError, not an epoch."""

    lib = ""

    def __init__(self, type: str, **kwargs):  # noqa: A002 (mmaction key)
        self.trans = self._build(type, kwargs)

    def _build(self, name, kwargs):
        raise NotImplementedError

    def __call__(self, results: Dict) -> Dict:
        results["imgs"] = [np.asarray(self._apply(im), np.float32)
                           for im in results["imgs"]]
        return results

    def _apply(self, img):
        return self.trans(img)


@PIPELINES.register("TorchvisionTrans")
class TorchvisionTrans(_ExternalTrans):
    lib = "torchvision"

    def _build(self, name, kwargs):
        import torchvision.transforms as T
        return getattr(T, name)(**kwargs)

    def _apply(self, img):
        import torch
        t = torch.from_numpy(
            np.ascontiguousarray(img.transpose(2, 0, 1))).float()
        return np.asarray(self.trans(t)).transpose(1, 2, 0)


@PIPELINES.register("ImgaugTrans")
class ImgaugTrans(_ExternalTrans):
    lib = "imgaug"

    def _build(self, name, kwargs):
        import imgaug.augmenters as iaa
        return getattr(iaa, name)(**kwargs)

    def _apply(self, img):
        return self.trans(image=np.asarray(img, np.uint8))


@PIPELINES.register("PytorchVideoTrans")
class PytorchVideoTrans(_ExternalTrans):
    lib = "pytorchvideo"

    def _build(self, name, kwargs):
        import pytorchvideo.transforms as ptv
        return getattr(ptv, name)(**kwargs)

    def __call__(self, results: Dict) -> Dict:
        import torch
        clip = torch.from_numpy(
            np.stack(results["imgs"]).transpose(3, 0, 1, 2)).float()
        out = np.asarray(self.trans(clip))
        results["imgs"] = list(out.transpose(1, 2, 3, 0))
        return results


@PIPELINES.register("Normalize")
class Normalize:
    """(x - mean) / std per channel on the host, in float32; to_bgr
    matches mmaction's to_rgb inversion."""

    def __init__(self, mean, std, to_bgr: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_bgr = to_bgr

    def __call__(self, results: Dict) -> Dict:
        imgs = np.stack(results["imgs"]).astype(np.float32)
        if self.to_bgr:
            imgs = imgs[..., ::-1]
        imgs = (imgs - self.mean) / self.std
        results["imgs"] = list(imgs)
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std)
        return results


@PIPELINES.register("FormatShape")
class FormatShape:
    """formatting.py FormatShape: NCTHW/NCHW packing from the img list,
    and 'NTHWC' (channels last), the layout the models read."""

    def __init__(self, input_format: str = "NTHWC"):
        if input_format not in ("NCTHW", "NCHW", "NTHWC"):
            raise ValueError(f"input_format {input_format!r}")
        self.input_format = input_format

    def __call__(self, results: Dict) -> Dict:
        imgs = np.stack(results["imgs"])            # (M, H, W, C)
        num_clips = results.get("num_clips", 1) * results.get("num_crops", 1)
        clip_len = results.get("clip_len", imgs.shape[0] // max(num_clips, 1))
        if self.input_format == "NCHW":
            results["imgs"] = imgs.transpose(0, 3, 1, 2)
        else:
            n = imgs.shape[0] // clip_len
            imgs = imgs.reshape((n, clip_len) + imgs.shape[1:])
            if self.input_format == "NCTHW":
                results["imgs"] = imgs.transpose(0, 4, 1, 2, 3)
            else:                                   # NTHWC
                results["imgs"] = imgs
        results["input_shape"] = results["imgs"].shape
        return results


@PIPELINES.register("MergeClips")
class MergeClips:
    """Fold the clip axis into time: (N, T, H, W, C) -> (1, N*T, H, W, C),
    the 1x1xN segment protocol of the 2D families on one static layout.
    Place after FormatShape('NTHWC')."""

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        if getattr(imgs, "ndim", 0) != 5:
            raise ValueError("MergeClips expects (N, T, H, W, C); run "
                             "FormatShape('NTHWC') first")
        n, t = imgs.shape[:2]
        results["imgs"] = imgs.reshape((1, n * t) + imgs.shape[2:])
        results["clip_len"] = n * t
        results["num_clips"] = 1
        results["input_shape"] = results["imgs"].shape
        return results


class Compose:
    def __init__(self, ops: Sequence):
        self.ops = list(ops)

    def __call__(self, results: Dict) -> Dict:
        for op in self.ops:
            results = op(results)
        return results


def with_reader(cfgs: Sequence[Dict], reader) -> list:
    """Copies of the op dicts, the decode-init ops (DecordInit,
    OpenCVInit) given `reader` (filename -> decord-alike reader) in place
    of opening the file; reader=None leaves them as they are."""
    return [dict(c, reader=reader)
            if reader is not None and c.get("type") in ("DecordInit",
                                                        "OpenCVInit")
            else dict(c) for c in cfgs]


# the JAX package's pipelines_extra ops, by the part of ROADMAP.md queue 1
# item 8 that ports them
UNPORTED_OPS = {op: "8g" for op in (
    "AudioDecodeInit", "LoadAudioFeature", "AudioDecode",
    "AudioFeatureSelector", "AudioAmplify", "MelSpectrogram",
    "FormatAudioShape")}


def build_pipeline(cfgs: Sequence[Dict]) -> Compose:
    """Build from mmaction-style [{'type': 'SampleFrames', ...}, ...].
    An op type that is not ported raises KeyError naming the part of
    ROADMAP.md queue 1 item 8 that ports it (`UNPORTED_OPS`: the audio
    ops of the JAX package's pipelines_extra)."""
    # the decode ops (DecordInit, DecordDecode, ...) register on import
    from ..io import video_decode  # noqa: F401
    ops = []
    for cfg in cfgs:
        cfg = dict(cfg)
        name = cfg.pop("type")
        if name in UNPORTED_OPS:
            raise KeyError(
                f"pipeline op {name!r} is not ported to the PyTorch package "
                f"yet: it comes with ROADMAP.md queue 1 item "
                f"{UNPORTED_OPS[name]}")
        if name not in PIPELINES:
            raise KeyError(f"unknown pipeline op {name!r}; ported: "
                           f"{sorted(PIPELINES)}")
        ops.append(PIPELINES.get(name)(**cfg))
    return Compose(ops)


# the ops of pipelines_extra register with the ones above
from . import pipelines_extra  # noqa: E402,F401

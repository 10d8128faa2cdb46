"""Video decode on the host.

Counterpart of cross_modal_video_engine_tpu/io/video_decode.py:
`CvVideoReader` (a decord.VideoReader-alike over OpenCV's
`cv2.VideoCapture`), `open_video`, the test fixture `write_test_video`,
and the five decode ops of the pipelines (`DecordInit`, `DecordDecode`,
`OpenCVInit`, `OpenCVDecode`, `RawFrameDecode`, registered in
utils/registry.PIPELINES).  Frames come back RGB uint8 (decord's
convention).

OpenCV is imported inside the functions that use it, never when this
module is imported, so the package imports on a machine without cv2.
There `open_video`, `RawFrameDecode` and `write_test_video` raise
ImportError naming cv2; nothing else decodes instead.  `DecordInit`
takes the reader from a callable (`reader=`, default `open_video`): a
caller on such a machine hands it any decord-alike reader (`__len__`,
`fps`, `get_batch(indices)`, `release()`), and the rest of the pipeline
runs as it does on the file.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Sequence

import numpy as np

from ..utils.registry import PIPELINES


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video decode needs OpenCV (the cv2 module), "
                          "which is not installed") from e
    return cv2


class CvVideoReader:
    """decord.VideoReader-alike over cv2.VideoCapture."""

    def __init__(self, path: str):
        cv2 = _cv2()
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self._cv = cv2
        self.path = path
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video {path}")
        self._n = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = self._cap.get(cv2.CAP_PROP_FPS)
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._pos = 0

    def __len__(self) -> int:
        return self._n

    def _read_at(self, idx: int) -> np.ndarray:
        cv2 = self._cv
        if idx != self._pos:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = self._cap.read()
        if not ok:
            # fall back: re-open and seek (some containers mis-seek)
            self._cap.release()
            self._cap = cv2.VideoCapture(self.path)
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, frame = self._cap.read()
            if not ok:
                raise IOError(f"decode failed at frame {idx} of {self.path}")
        self._pos = idx + 1
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Sorted-unique decode then gather, like decord get_batch."""
        indices = np.asarray(indices, np.int64)
        uniq = np.unique(indices)
        cache = {int(i): self._read_at(int(i)) for i in uniq}
        return np.stack([cache[int(i)] for i in indices])

    def release(self):
        self._cap.release()


def open_video(path: str) -> CvVideoReader:
    return CvVideoReader(path)


# -- pipeline ops ------------------------------------------------------------

@PIPELINES.register("DecordInit")
class DecordInit:
    """loading.py:1027: attach a reader and total_frames to results.
    reader: filename -> decord-alike reader (default open_video)."""

    def __init__(self, reader: Callable | None = None):
        self.reader = reader or open_video

    def __call__(self, results: Dict) -> Dict:
        reader = self.reader(results["filename"])
        results["video_reader"] = reader
        results["total_frames"] = len(reader)
        results.setdefault("start_index", 0)
        results["avg_fps"] = reader.fps
        return results


@PIPELINES.register("DecordDecode")
class DecordDecode:
    """loading.py:1081: decode results['frame_inds'] into results['imgs']
    and release the reader."""

    def __call__(self, results: Dict) -> Dict:
        reader = results["video_reader"]
        frames = reader.get_batch(results["frame_inds"])
        results["imgs"] = list(frames)
        results["original_shape"] = frames.shape[1:3]
        results["img_shape"] = frames.shape[1:3]
        reader.release()
        results["video_reader"] = None
        return results


@PIPELINES.register("OpenCVInit")
class OpenCVInit(DecordInit):
    pass


@PIPELINES.register("OpenCVDecode")
class OpenCVDecode(DecordDecode):
    pass


@PIPELINES.register("RawFrameDecode")
class RawFrameDecode:
    """loading.py:1249: read img_{idx:05d}.jpg frames from frame_dir.
    frame_inds index the template directly (RawframeDataset's start_index
    defaults to 1, the mmaction 1-based rawframe convention)."""

    def __call__(self, results: Dict) -> Dict:
        cv2 = _cv2()
        tmpl = results.get("filename_tmpl", "img_{:05d}.jpg")
        d = results["frame_dir"]
        imgs = []
        for idx in results["frame_inds"]:
            p = os.path.join(d, tmpl.format(int(idx)))
            img = cv2.imread(p)
            if img is None:
                raise IOError(f"missing frame {p}")
            imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        results["imgs"] = imgs
        results["original_shape"] = imgs[0].shape[:2]
        results["img_shape"] = imgs[0].shape[:2]
        return results


def write_test_video(path: str, frames: np.ndarray, fps: int = 10) -> None:
    """Write an RGB uint8 (T, H, W, 3) array as an mp4 (test fixture)."""
    cv2 = _cv2()
    t, h, w, _ = frames.shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open a video writer for {path}")
    try:
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()

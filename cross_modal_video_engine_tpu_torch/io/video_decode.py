"""Video decode on the host.

Counterpart of cross_modal_video_engine_tpu/io/video_decode.py for what the
composed-retrieval path reads: `CvVideoReader` (a decord.VideoReader-alike
over OpenCV's `cv2.VideoCapture`), `open_video` and the test fixture
`write_test_video`.  Frames come back RGB uint8 (decord's convention).

OpenCV is imported inside the functions that use it, never when this
module is imported, so the package imports on a machine without cv2.
There `open_video` and `write_test_video` raise ImportError naming cv2;
nothing else decodes instead.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


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

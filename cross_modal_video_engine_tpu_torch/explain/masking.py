"""Concept masking: detections -> per-class masked videos.

A copy of cross_modal_video_engine_tpu/explain/masking.py (numpy; cv2 is
imported inside `draw_box`).

Rebuild of the modified yolov5 detect path the CTV pipeline shells out to
(MCT/yolov5/detect.py:114-233 + utils/plots.py:117-123 `box_mask`):

  * every detected box of class c is FILLED (blacked out) to produce a
    per-class masked copy of the video;
  * classes seen in <= `min_frames` frames are dropped as noise
    (detect.py:207-208);
  * detect_raw-style box drawing is provided for visualization.

Instead of writing masked .mp4 files and re-reading them (the reference's
os.system round trip, inference_demo.py:136-146), masked clips stay in
memory as arrays feeding the embedding batch directly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def box_mask(frame: np.ndarray, xyxy: Sequence[float],
             value: int = 0) -> np.ndarray:
    """Fill the box region (plots.py:117-123). Mutates and returns frame."""
    h, w = frame.shape[:2]
    # clamp BOTH corners into [0, size]: a negative x2/y2 would become
    # a negative-index slice and mask a large wrong region
    x1, y1 = int(min(max(0, xyxy[0]), w)), int(min(max(0, xyxy[1]), h))
    x2, y2 = int(min(max(0, xyxy[2]), w)), int(min(max(0, xyxy[3]), h))
    frame[y1:y2, x1:x2] = value
    return frame


def draw_box(frame: np.ndarray, xyxy: Sequence[float],
             color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    import cv2
    cv2.rectangle(frame, (int(xyxy[0]), int(xyxy[1])),
                  (int(xyxy[2]), int(xyxy[3])), color, thickness)
    return frame


def per_class_masked_videos(frames: np.ndarray,
                            detections: Sequence[np.ndarray],
                            class_names: Sequence[str],
                            min_frames: int = 10
                            ) -> Dict[str, np.ndarray]:
    """frames: (T, H, W, 3) uint8; detections[t]: (n, 6) x1,y1,x2,y2,conf,cls.
    Returns {class_name: masked copy of the whole clip} for classes present
    in > min_frames frames (detect.py:202-233 per-class writers + the
    noise filter)."""
    T = len(frames)
    frames_with: Dict[int, set] = {}
    for t, det in enumerate(detections):
        for row in det:
            frames_with.setdefault(int(row[5]), set()).add(t)
    keep = {c for c, ts in frames_with.items() if len(ts) > min_frames}
    out: Dict[str, np.ndarray] = {}
    for c in keep:
        masked = frames.copy()
        for t, det in enumerate(detections):
            for row in det:
                if int(row[5]) == c:
                    box_mask(masked[t], row[:4])
        out[class_names[c]] = masked
    return out


def detect_video(detector_fn: Callable[[np.ndarray], List[np.ndarray]],
                 frames: np.ndarray, batch_size: int = 16
                 ) -> List[np.ndarray]:
    """Run a batched detector over all frames of a clip.  The tail
    batch is padded to batch_size by repeating the last frame, so the
    detector sees one batch shape, as in the JAX package."""
    dets: List[np.ndarray] = []
    for i in range(0, len(frames), batch_size):
        chunk = frames[i:i + batch_size]
        n = len(chunk)
        if n < batch_size:
            pad = np.repeat(chunk[-1:], batch_size - n, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        dets.extend(detector_fn(chunk)[:n])
    return dets

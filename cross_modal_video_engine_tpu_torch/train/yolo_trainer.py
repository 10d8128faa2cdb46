"""The detector's letterbox, the geometry of its validation batches.

Counterpart of the letterbox half of
cross_modal_video_engine_tpu/train/yolo_trainer.py (utils/augmentations.py
letterbox of the reference): an aspect-preserving resize and a constant
pad to a square.  The resize is data/pipelines.resize_linear, bit-equal to
cv2.resize's uint8 INTER_LINEAR; the pad is np.pad in place of
cv2.copyMakeBorder, so neither needs cv2.  The train step, its state and
its schedule are ROADMAP.md queue 1 item 7b-ii.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data.pipelines import resize_linear


def letterbox(img: np.ndarray, new: int = 640,
              color: int = 114) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """(H, W, C) -> (new, new, C): resized by r = min(new/H, new/W), padded
    with `color` (half each side, the odd pixel to the bottom/right).
    Returns the image, r and the (dx, dy) pad in pixels."""
    h, w = img.shape[:2]
    r = min(new / h, new / w)
    nh, nw = round(h * r), round(w * r)
    if (nh, nw) != (h, w):
        img = resize_linear(img, (nw, nh))
    dy, dx = (new - nh) / 2, (new - nw) / 2
    top, bottom = int(round(dy - 0.1)), int(round(dy + 0.1))
    left, right = int(round(dx - 0.1)), int(round(dx + 0.1))
    pad = [(top, bottom), (left, right)] + [(0, 0)] * (img.ndim - 2)
    out = np.pad(img, pad, mode="constant", constant_values=color)
    return out, r, (left, top)


def letterbox_boxes(boxes: np.ndarray, r: float, pad: Tuple[float, float],
                    orig_hw: Tuple[int, int], new: int) -> np.ndarray:
    """Map normalized [cls, cx, cy, w, h] label rows through the
    `letterbox` geometry."""
    if len(boxes) == 0:
        return boxes
    h, w = orig_hw
    out = boxes.copy()
    out[:, 1] = (boxes[:, 1] * w * r + pad[0]) / new
    out[:, 2] = (boxes[:, 2] * h * r + pad[1]) / new
    out[:, 3] = boxes[:, 3] * w * r / new
    out[:, 4] = boxes[:, 4] * h * r / new
    return out

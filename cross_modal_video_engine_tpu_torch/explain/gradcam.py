"""GradCAM over TimeSformer tokens.

A copy of cross_modal_video_engine_tpu/explain/gradcam.py (numpy; cv2 is
imported inside `overlay_heatmap`).

Equivalent of MCT/mmaction/utils/gradcam_utils.py adapted to the
transformer token layout: channel weights are token-averaged gradients,
the CAM is ReLU(sum_c w_c * act_c) per patch token, reshaped to
(T, grid, grid) and min-max normalized.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gradcam_from_tokens(activations: np.ndarray, gradients: np.ndarray,
                        num_frames: int, grid: int) -> np.ndarray:
    """activations/gradients: (B, 1 + P*T, D) in patch-major (p t) order.
    Returns (B, T, grid, grid) normalized localization maps."""
    act = activations[:, 1:, :]
    grad = gradients[:, 1:, :]
    B, PT, D = act.shape
    P = PT // num_frames
    weights = grad.mean(axis=1, keepdims=True)          # (B, 1, D)
    cam = np.maximum((weights * act).sum(-1), 0.0)      # (B, P*T)
    cam = cam.reshape(B, P, num_frames).transpose(0, 2, 1)   # (B, T, P)
    cam = cam.reshape(B, num_frames, grid, grid)
    flat = cam.reshape(B, -1)
    lo = flat.min(axis=1)[:, None, None, None]
    hi = flat.max(axis=1)[:, None, None, None]
    return ((cam - lo) / np.maximum(hi - lo, 1e-12)).astype(np.float32)


def overlay_heatmap(frame: np.ndarray, cam: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """Blend a (grid, grid) cam onto an RGB uint8 frame (H, W, 3)."""
    import cv2

    h, w = frame.shape[:2]
    heat = cv2.resize((cam * 255).astype(np.uint8), (w, h))
    heat = cv2.applyColorMap(heat, cv2.COLORMAP_JET)[:, :, ::-1]
    return (alpha * heat + (1 - alpha) * frame).astype(np.uint8)

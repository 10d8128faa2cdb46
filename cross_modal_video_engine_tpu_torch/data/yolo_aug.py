"""The detector's label geometry for validation.

A copy of what the validation path needs of
cross_modal_video_engine_tpu/data/yolo_aug.py (utils/general.py of the
reference): boxes from polygons and the two box conversions.  The
training augmentations (mosaic, mixup, perspective, HSV, flips) are
ROADMAP.md queue 1 item 7b-ii.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def xywhn2xyxy(x: np.ndarray, w: float, h: float, padw: float = 0.0,
               padh: float = 0.0) -> np.ndarray:
    """Normalized cxcywh -> pixel xyxy (utils/general.py)."""
    y = np.empty_like(x, dtype=np.float64)
    y[:, 0] = w * (x[:, 0] - x[:, 2] / 2) + padw
    y[:, 1] = h * (x[:, 1] - x[:, 3] / 2) + padh
    y[:, 2] = w * (x[:, 0] + x[:, 2] / 2) + padw
    y[:, 3] = h * (x[:, 1] + x[:, 3] / 2) + padh
    return y


def xyxy2xywhn(x: np.ndarray, w: float, h: float, clip: bool = True,
               eps: float = 1e-3) -> np.ndarray:
    """Pixel xyxy -> normalized cxcywh with edge clipping."""
    x = x.astype(np.float64).copy()
    if clip:
        x[:, [0, 2]] = x[:, [0, 2]].clip(0, w - eps)
        x[:, [1, 3]] = x[:, [1, 3]].clip(0, h - eps)
    y = np.empty_like(x)
    y[:, 0] = ((x[:, 0] + x[:, 2]) / 2) / w
    y[:, 1] = ((x[:, 1] + x[:, 3]) / 2) / h
    y[:, 2] = (x[:, 2] - x[:, 0]) / w
    y[:, 3] = (x[:, 3] - x[:, 1]) / h
    return y


def segments2boxes(segments: Sequence[Tuple[float, np.ndarray]]
                   ) -> np.ndarray:
    """Polygon rows -> (n, 5) [cls, cx, cy, w, h] in the polygon's own
    coordinate frame (xyxy from min/max, then xywh)."""
    boxes = []
    for cls, pts in segments:
        x, y = pts[:, 0], pts[:, 1]
        boxes.append([cls, (x.min() + x.max()) / 2,
                      (y.min() + y.max()) / 2,
                      x.max() - x.min(), y.max() - y.min()])
    return (np.asarray(boxes, np.float32) if boxes
            else np.zeros((0, 5), np.float32))


# -- cv2.fillPoly in Python ---------------------------------------------------
# OpenCV's drawing.cpp (fillPoly with LINE_8, shift 0): each edge is drawn
# by the 8-connected line iterator, then the scanlines between the edges
# (x in 16.16 fixed point, stepped by a truncated slope) are filled.  The
# same integer steps give the same pixels.

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """cv::clipLine: the segment clipped to the image; None if outside."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    code = lambda x, y: ((x < 0) + (x > right) * 2 + (y < 0) * 4
                         + (y > bottom) * 8)
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return ((x1, y1), (x2, y2)) if (c1 | c2) == 0 else None


def _draw_line(img: np.ndarray, p1, p2, value) -> None:
    """cv::Line with 8-connectivity, left to right (LineIterator)."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p1[1] < h
            and 0 <= p2[0] < w and 0 <= p2[1] < h):
        clipped = _clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    x, y = p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ystep = -1 if dy < 0 else 1
    dy = abs(dy)
    # the major axis: x steps (plus) unless the line is steep
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    for _ in range(dx + 1):
        img[y, x] = value
        # err < 0: a diagonal step (both axes), else along the major axis
        diag = err < 0
        err += minus_delta + (plus_delta if diag else 0)
        if steep:
            y += ystep
            x += 1 if diag else 0
        else:
            x += 1
            y += ystep if diag else 0


def fill_poly(img: np.ndarray, pts: np.ndarray, value) -> np.ndarray:
    """cv2.fillPoly(img, [pts], value) for one polygon of int32 (n, 2) xy
    points, LINE_8, shift 0: fills img in place and returns it."""
    h, w = img.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []              # [y0, y1, x (16.16), dx (16.16)]
    half = _XY_ONE >> 1
    pt0 = (pts[-1][0] << _XY_SHIFT, pts[-1][1])
    for v in pts:
        pt1 = (v[0] << _XY_SHIFT, v[1])
        t0 = ((pt0[0] + half) >> _XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + half) >> _XY_SHIFT, pt1[1])
        _draw_line(img, t0, t1, value)
        p0c, p1c = list(pt0), list(pt1)
        if not (0 <= t0[0] < w and 0 <= t1[0] < w
                and 0 <= t0[1] < h and 0 <= t1[1] < h):
            clipped = _clip_line(w, h, t0, t1)
            c0, c1 = clipped if clipped is not None else (t0, t1)
            if c0[1] != c1[1]:
                p0c = [c0[0] << _XY_SHIFT, c0[1]]
                p1c = [c1[0] << _XY_SHIFT, c1[1]]
        if pt0[1] != pt1[1]:
            # a clipped edge keeps the unclipped rows: its x is carried
            # back along the clipped slope to the unclipped first row
            dx = _cdiv(p1c[0] - p0c[0], p1c[1] - p0c[1])
            if pt0[1] < pt1[1]:
                edges.append([pt0[1], pt1[1],
                              p0c[0] + (pt0[1] - p0c[1]) * dx, dx])
            else:
                edges.append([pt1[1], pt0[1],
                              p1c[0] + (pt1[1] - p1c[1]) * dx, dx])
        pt0 = pt1
    _fill_edges(img, edges, value)
    return img


def _fill_edges(img: np.ndarray, edges, value) -> None:
    """FillEdgeCollection: scanlines between pairs of active edges."""
    if len(edges) < 2:
        return
    h, w = img.shape[:2]
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    y_max = min(y_max, h)
    active = []             # edges crossing the scanline, ordered by x
    i = 0
    for y in range(edges[0][0], y_max):
        active = [e for e in active if e[1] != y]
        while i < len(edges) and edges[i][0] == y:
            # inserted before the first active edge whose x is not less
            e = edges[i]
            k = 0
            while k < len(active) and active[k][2] < e[2]:
                k += 1
            active.insert(k, e)
            i += 1
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                x1, x2 = sorted((a[2], b[2]))
                x1, x2 = (x1 + _XY_ONE - 1) >> _XY_SHIFT, x2 >> _XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = value
            a[2] += a[3]
            b[2] += b[3]
        # the bubble sort keeps the active list ordered by x (stable)
        active.sort(key=lambda e: e[2])

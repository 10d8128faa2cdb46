"""The detector's training augmentations and label geometry, in numpy.

Counterpart of cross_modal_video_engine_tpu/data/yolo_aug.py (the
reference's utils/augmentations.py and utils/dataloaders.py): HSV jitter,
the composed perspective warp with `box_candidates`, the 4-image mosaic
(and its segment variant), mixup, copy-paste, polygon resampling, and
`augment_sample` / `augment_seg_sample`, the whole per-sample pipeline.
Every draw from the `np.random.RandomState` comes in the JAX module's
order, and the labels are the same numpy arithmetic on the same matrix,
so one seed gives the same labels exactly.

The JAX module calls cv2; the card's machine has none, so its operations
are done here in numpy:

* RGB -> HSV on uint8 is OpenCV's fixed point (RGB2HSV_b: the 12-bit
  division tables): bit-equal;
* HSV -> RGB on uint8 follows OpenCV 5 on an AVX2 host: whole vector
  steps of 32 pixels of a row take the vector path (f32, values scaled
  by 1/255, the tabs with a fused multiply-add, truncated after * 255),
  the rest of the row the scalar path (rounded to nearest): bit-equal on
  the vector path over the whole HSV cube, 1.1e-5 of the scalar path's
  channels one level off (tests/test_torch_yolo_aug.py);
* `cv2.LUT`, `split`/`merge` and `flip` are numpy indexing;
* getRotationMatrix2D is its formula (math.cos/sin of the angle);
* warpAffine (INTER_LINEAR, border 114) follows OpenCV 5's f32 path: the
  inverse matrix in double, rounded to f32; source coordinates as
  fma(M00, x, M01*y + M02); the four taps interpolated in f32 and rounded
  to nearest: bit-equal on the tested shapes; warpPerspective divides by
  the third row the same way (the shipped configs keep perspective 0);
* drawContours(FILLED) of one contour is fillPoly (`fill_poly`, a Python
  copy of OpenCV's edge filling);
* the resize to the training size is data/pipelines.resize_linear,
  cv2.resize's uint8 INTER_LINEAR bit for bit.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from ..train.yolo_trainer import letterbox
from .pipelines import resize_linear


class YoloAugHyp(NamedTuple):
    """Augmentation hyperparameters (hyp.scratch-low.yaml)."""
    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0
    mixup: float = 0.0
    copy_paste: float = 0.0   # segment-only


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


# -- cv2's colour conversions, warps and rotation matrix in numpy --------------

_F32 = np.float32
_HSV_SHIFT = 12
_I = np.arange(256, dtype=np.float64)
_SDIV = np.where(_I > 0, np.rint((255 << _HSV_SHIFT) / np.maximum(_I, 1)),
                 0).astype(np.int64)
_HDIV = np.where(_I > 0, np.rint((180 << _HSV_SHIFT)
                                 / (6.0 * np.maximum(_I, 1))),
                 0).astype(np.int64)
# the tab each of b, g, r takes in sectors 0-5 (HSV2RGB)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) of uint8 RGB: h in [0, 180)."""
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _fma(a, b, c) -> np.ndarray:
    """f32 a * b + c rounded once (the float64 product is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


_HSV_LANES = 32     # pixels of one vector step of cv2's HSV2RGB_b (AVX2)


def _hsv_tabs(hsv: np.ndarray, vector: bool) -> np.ndarray:
    """The r, g, b of uint8 HSV as cv2's HSV2RGB_b computes them: the
    vector path (h sector by truncation, the tabs with fused
    multiply-adds, * 255 truncated) or the scalar one (the sector by
    floor, plain f32, * 255 rounded to nearest)."""
    one = _F32(1)
    s = (hsv[..., 1].astype(_F32) * _F32(1 / 255.0)).astype(_F32)
    v = (hsv[..., 2].astype(_F32) * _F32(1 / 255.0)).astype(_F32)
    h = (hsv[..., 0].astype(_F32) * _F32(6.0 / 180.0)).astype(_F32)
    pre = np.trunc(h) if vector else np.floor(h)
    f = (h - pre).astype(_F32)
    if vector:
        t2 = (v * _fma(-s, f, one)).astype(_F32)
        t3 = (v * _fma(-s, (one - f).astype(_F32), one)).astype(_F32)
    else:
        t2 = (v * (one - (s * f).astype(_F32))).astype(_F32)
        t3 = (v * (one - (s * (one - f)).astype(_F32))).astype(_F32)
    tab = np.stack([v, (v * (one - s)).astype(_F32), t2, t3], -1)
    pick = _SECTORS[pre.astype(np.int64) % 6]                 # (..., 3) bgr
    if not vector:
        tab = np.where((hsv[..., 1] == 0)[..., None], v[..., None], tab)
    out = (np.take_along_axis(tab, pick, -1)[..., ::-1]
           * _F32(255)).astype(_F32)
    rounded = np.trunc(out) if vector else np.rint(out)
    return np.clip(rounded, 0, 255).astype(np.uint8)


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) of uint8 (H, W, 3) HSV: each row's
    whole vector steps of 32 pixels by the vector path, the rest of the
    row by the scalar one (see the module docstring)."""
    cut = hsv.shape[1] // _HSV_LANES * _HSV_LANES
    return np.concatenate([_hsv_tabs(hsv[:, :cut], vector=True),
                           _hsv_tabs(hsv[:, cut:], vector=False)], 1)


def rotation_matrix_2d(angle: float, scale: float,
                       center: Tuple[float, float] = (0.0, 0.0)
                       ) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): (2, 3) float64."""
    a = angle * (math.pi / 180.0)        # angle *= CV_PI/180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(M: np.ndarray) -> np.ndarray:
    """cv::invertAffineTransform, in double."""
    M = np.array(M, np.float64).reshape(2, 3)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = M[1, 1] * d, M[0, 0] * d
    M[0, 0], M[0, 1], M[1, 0], M[1, 1] = a11, M[0, 1] * -d, M[1, 0] * -d, a22
    b1 = -M[0, 0] * M[0, 2] - M[0, 1] * M[1, 2]
    b2 = -M[1, 0] * M[0, 2] - M[1, 1] * M[1, 2]
    M[0, 2], M[1, 2] = b1, b2
    return M


def _bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
              border: int) -> np.ndarray:
    """Sample uint8 (H, W, C) at f32 source coordinates: the four taps
    (border outside) interpolated in f32, rounded to nearest."""
    H, W = img.shape[:2]
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    a = (sx - ix).astype(_F32)[..., None]
    b = (sy - iy).astype(_F32)[..., None]
    src = img.astype(_F32)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = src[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        return np.where(ok[..., None], v, _F32(border))

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    v = _fma(b, (v1 - v0).astype(_F32), v0)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _grid(dsize: Tuple[int, int]):
    w, h = dsize
    ys, xs = np.meshgrid(np.arange(h, dtype=_F32), np.arange(w, dtype=_F32),
                         indexing="ij")
    return xs, ys


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int],
                border: int = 114) -> np.ndarray:
    """cv2.warpAffine(img, M, dsize, INTER_LINEAR, BORDER_CONSTANT,
    borderValue=(border,) * 3) of a uint8 (H, W, C) image."""
    m = _invert_affine(M).astype(_F32)
    xs, ys = _grid(dsize)
    sx = _fma(m[0, 0], xs, (m[0, 1] * ys + m[0, 2]).astype(_F32))
    sy = _fma(m[1, 0], xs, (m[1, 1] * ys + m[1, 2]).astype(_F32))
    return _bilinear(img, sx, sy, border)


def warp_perspective(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int],
                     border: int = 114) -> np.ndarray:
    """cv2.warpPerspective(img, M, dsize, INTER_LINEAR, BORDER_CONSTANT,
    borderValue=(border,) * 3) of a uint8 (H, W, C) image."""
    m = np.linalg.inv(np.asarray(M, np.float64)).astype(_F32)
    xs, ys = _grid(dsize)
    row = [_fma(m[i, 0], xs, (m[i, 1] * ys + m[i, 2]).astype(_F32))
           for i in range(3)]
    w = np.where(row[2] != 0, (_F32(1) / row[2]).astype(_F32), _F32(0))
    return _bilinear(img, (row[0] * w).astype(_F32),
                     (row[1] * w).astype(_F32), border)


# -- the augmentations ------------------------------------------------------------

def augment_hsv(img: np.ndarray, rng: np.random.RandomState,
                hgain: float = 0.5, sgain: float = 0.5,
                vgain: float = 0.5) -> np.ndarray:
    """LUT HSV jitter (augmentations.py:67-81).  Returns a new image."""
    if not (hgain or sgain or vgain):
        return img
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = rgb2hsv(img)
    x = np.arange(0, 256, dtype=r.dtype)
    lut_hue = ((x * r[0]) % 180).astype(img.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
    hsv = np.stack([lut_hue[hsv[..., 0]], lut_sat[hsv[..., 1]],
                    lut_val[hsv[..., 2]]], -1)
    return hsv2rgb(hsv)


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2,
                   ar_thr: float = 100, area_thr: float = 0.1,
                   eps: float = 1e-16) -> np.ndarray:
    """Boxes that survived the warp; box1/box2 (4, n) xyxy before/after."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr))


def _warp_canvas(img: np.ndarray, rng: np.random.RandomState,
                 degrees: float, translate: float, scale: float,
                 shear: float, perspective: float,
                 border: Tuple[int, int]
                 ) -> Tuple[np.ndarray, np.ndarray, float, int, int]:
    """The matrix T @ S @ R @ P @ C of random_perspective, drawn in the
    reference's order, and the image warped by it.  Returns (img, M, s,
    width, height)."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = rotation_matrix_2d(a, s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    M = T @ S @ R @ P @ C
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = warp_perspective(img, M, (width, height))
        else:
            img = warp_affine(img, M[:2], (width, height))
    return img, M, s, width, height


def random_perspective(img: np.ndarray, targets: np.ndarray,
                       rng: np.random.RandomState,
                       degrees: float = 10, translate: float = 0.1,
                       scale: float = 0.1, shear: float = 10,
                       perspective: float = 0.0,
                       border: Tuple[int, int] = (0, 0)
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """targets (n, 5) [cls, x1, y1, x2, y2] pixel boxes; border < 0 trims a
    mosaic canvas back to the image size."""
    img, M, s, width, height = _warp_canvas(
        img, rng, degrees, translate, scale, shear, perspective, border)
    n = len(targets)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective
              else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(targets[:, 1:5].T * s, new.T, area_thr=0.10)
        targets = targets[keep].copy()
        targets[:, 1:5] = new[keep]
    return img, targets


def mosaic4(items: Sequence[Tuple[np.ndarray, np.ndarray]], img_size: int,
            rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """The 4-image mosaic: (2s, 2s, 3) canvas and (m, 5) pixel-xyxy labels
    clipped to it; the caller trims with random_perspective(border=-s/2)."""
    img4, out, _ = mosaic4_seg([(img, labels, []) for img, labels in items],
                               img_size, rng)
    return img4, out


def mixup(img: np.ndarray, labels: np.ndarray, img2: np.ndarray,
          labels2: np.ndarray, rng: np.random.RandomState
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Beta(32, 32) blend."""
    r = rng.beta(32.0, 32.0)
    out = (img.astype(np.float32) * r
           + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return out, np.concatenate((labels, labels2), 0)


def resample_segments(segments: List[np.ndarray], n: int = 1000
                      ) -> List[np.ndarray]:
    """Each closed polygon up-sampled to n points along the vertex index."""
    out = []
    for s in segments:
        s = np.concatenate((s, s[0:1, :]), axis=0)
        x = np.linspace(0, len(s) - 1, n)
        xp = np.arange(len(s))
        out.append(np.stack([np.interp(x, xp, s[:, i]) for i in range(2)],
                            1))
    return out


def segment2box(segment: np.ndarray, width: float, height: float
                ) -> np.ndarray:
    """Polygon -> xyxy box over its points inside the image."""
    x, y = segment.T
    inside = (x >= 0) & (y >= 0) & (x <= width) & (y <= height)
    x, y = x[inside], y[inside]
    return (np.array([x.min(), y.min(), x.max(), y.max()])
            if len(x) else np.zeros(4))


def bbox_ioa(box1: np.ndarray, box2: np.ndarray,
             eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2's area; box1 (4,), box2 (n, 4) xyxy."""
    b1x1, b1y1, b1x2, b1y2 = box1
    b2x1, b2y1, b2x2, b2y2 = box2.T
    inter = ((np.minimum(b1x2, b2x2) - np.maximum(b1x1, b2x1)).clip(0)
             * (np.minimum(b1y2, b2y2) - np.maximum(b1y1, b2y1)).clip(0))
    area2 = (b2x2 - b2x1) * (b2y2 - b2y1) + eps
    return inter / area2


def copy_paste(img: np.ndarray, labels: np.ndarray,
               segments: List[np.ndarray], p: float,
               rng: np.random.RandomState):
    """Copy-Paste: the horizontal mirror of round(p * n) instances whose
    mirrored box covers no label by 30% or more.  labels pixel xyxy (n, 5),
    segments pixel polygons."""
    n = len(segments)
    if p and n:
        h, w = img.shape[:2]
        im_new = np.zeros(img.shape, np.uint8)
        for j in rng.choice(n, size=round(p * n), replace=False):
            l, s = labels[j], segments[j]
            box = w - l[3], l[2], w - l[1], l[4]
            ioa = bbox_ioa(np.asarray(box), labels[:, 1:5])
            if (ioa < 0.30).all():
                labels = np.concatenate((labels, [[l[0], *box]]), 0)
                segments.append(
                    np.concatenate((w - s[:, 0:1], s[:, 1:2]), 1))
                fill_poly(im_new, s.astype(np.int32), 1)
        i = im_new[:, ::-1].astype(bool)
        img = img.copy()
        img[i] = img[:, ::-1][i]
    return img, labels, segments


def random_perspective_seg(img: np.ndarray, targets: np.ndarray,
                           segments: List[np.ndarray],
                           rng: np.random.RandomState,
                           degrees: float = 10, translate: float = 0.1,
                           scale: float = 0.1, shear: float = 10,
                           perspective: float = 0.0,
                           border: Tuple[int, int] = (0, 0)):
    """The segment variant: polygons resampled to 1000 points, warped by
    the same matrix, each box re-derived from its polygon's inside-image
    extent; survivors filter with area_thr 0.01.  Returns (img, (m, 5)
    pixel-xyxy targets, warped polygons)."""
    img, M, s, width, height = _warp_canvas(
        img, rng, degrees, translate, scale, shear, perspective, border)
    n = len(targets)
    if n:
        segments = resample_segments(list(segments))
        new = np.zeros((n, 4))
        new_segs = []
        for i, seg in enumerate(segments):
            xy = np.ones((len(seg), 3))
            xy[:, :2] = seg
            xy = xy @ M.T
            xy = xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]
            new[i] = segment2box(xy, width, height)
            new_segs.append(xy)
        keep = box_candidates(targets[:, 1:5].T * s, new.T, area_thr=0.01)
        targets = targets[keep].copy()
        targets[:, 1:5] = new[keep]
        segments = [ns for ns, k in zip(new_segs, keep) if k]
    return img, targets, segments


def mosaic4_seg(items, img_size: int, rng: np.random.RandomState):
    """The segment mosaic: items (image, (n, 5) normalized labels,
    [normalized polygon]); polygons ride the same scale and pad as the
    boxes and clip to the 2s canvas.  Returns (canvas, pixel-xyxy labels,
    pixel polygons)."""
    s = img_size
    yc, xc = (int(rng.uniform(s // 2, 2 * s - s // 2)) for _ in range(2))
    labels4: List[np.ndarray] = []
    segments4: List[np.ndarray] = []
    img4 = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    for i, (img, labels, segs) in enumerate(items):
        h, w = img.shape[:2]
        if i == 0:    # top left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:         # bottom right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2,
                                                                yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        padw, padh = x1a - x1b, y1a - y1b
        if len(labels):
            lab = labels.astype(np.float64).copy()
            lab[:, 1:5] = xywhn2xyxy(labels[:, 1:5], w, h, padw, padh)
            labels4.append(lab)
            segments4.extend(p * [w, h] + [padw, padh] for p in segs)
    if labels4:
        out = np.concatenate(labels4, 0)
        out[:, 1:5] = out[:, 1:5].clip(0, 2 * s)
        segments4 = [p.clip(0, 2 * s) for p in segments4]
    else:
        out = np.zeros((0, 5), np.float64)
    return img4, out, segments4


def load_image_resized(img: np.ndarray, img_size: int,
                       augment: bool = True) -> np.ndarray:
    """load_image's resize: the long side to img_size, INTER_LINEAR
    (resize_linear).  OpenCV's INTER_AREA, which the reference takes for
    a shrink without augmentation, no pipeline here asks for: it raises."""
    h0, w0 = img.shape[:2]
    r = img_size / max(h0, w0)
    if r != 1:
        if not (augment or r > 1):
            raise NotImplementedError("INTER_AREA shrink (augment=False)")
        img = resize_linear(img, (math.ceil(w0 * r), math.ceil(h0 * r)))
    return img


def _tail(img, labels, rng, hyp: YoloAugHyp, segs=None):
    """The common tail: labels to normalized xywh, HSV, the flips."""
    if len(labels):
        labels = labels.copy()
        labels[:, 1:5] = xyxy2xywhn(labels[:, 1:5], img.shape[1],
                                    img.shape[0])
    img = augment_hsv(img, rng, hyp.hsv_h, hyp.hsv_s, hyp.hsv_v)
    if rng.rand() < hyp.flipud:
        img = np.flipud(img)
        if len(labels):
            labels[:, 2] = 1 - labels[:, 2]
            if segs is not None:
                segs = [np.stack([p[:, 0], img.shape[0] - p[:, 1]], 1)
                        for p in segs]
    if rng.rand() < hyp.fliplr:
        img = np.fliplr(img)
        if len(labels):
            labels[:, 1] = 1 - labels[:, 1]
            if segs is not None:
                segs = [np.stack([img.shape[1] - p[:, 0], p[:, 1]], 1)
                        for p in segs]
    return np.ascontiguousarray(img), labels.astype(np.float32), segs


def augment_seg_sample(load, index: int, n_items: int, img_size: int,
                       hyp: YoloAugHyp, rng: np.random.RandomState):
    """One segment training sample: mosaic (+ mixup) or letterbox, the
    segment-aware perspective, HSV, flips.  load(i) -> (uint8 RGB image,
    [(cls, normalized polygon (k, 2))]).  Returns (img_size² uint8 image,
    (m, 5) normalized labels, [pixel polygon])."""
    def load_scaled(i):
        img, polys = load(i)
        img = load_image_resized(img, img_size)
        labels = segments2boxes([(c, p) for c, p in polys])
        return img, labels, [p for _, p in polys]

    use_mosaic = rng.rand() < hyp.mosaic

    def one_mosaic(idx):
        picks = [idx] + [int(rng.randint(n_items)) for _ in range(3)]
        rng.shuffle(picks)
        items = [load_scaled(j) for j in picks]
        img4, lab4, seg4 = mosaic4_seg(items, img_size, rng)
        img4, lab4, seg4 = copy_paste(img4, lab4, seg4, hyp.copy_paste, rng)
        return random_perspective_seg(
            img4, lab4, seg4, rng, hyp.degrees, hyp.translate, hyp.scale,
            hyp.shear, hyp.perspective,
            border=(-img_size // 2, -img_size // 2))

    if use_mosaic:
        img, labels, segs = one_mosaic(index)
        if rng.rand() < hyp.mixup:
            img2, labels2, segs2 = one_mosaic(int(rng.randint(n_items)))
            img, labels = mixup(img, labels, img2, labels2, rng)
            segs = segs + segs2
    else:
        raw, labels, segs = load_scaled(index)
        h, w = raw.shape[:2]
        img, r, pad = letterbox(raw, img_size)
        labels = labels.astype(np.float64).copy()
        if len(labels):
            labels[:, 1:5] = xywhn2xyxy(labels[:, 1:5], r * w, r * h,
                                        pad[0], pad[1])
        segs = [p * [r * w, r * h] + list(pad) for p in segs]
        img, labels, segs = random_perspective_seg(
            img, labels, segs, rng, hyp.degrees, hyp.translate, hyp.scale,
            hyp.shear, hyp.perspective)
    return _tail(img, labels, rng, hyp, segs)


def augment_sample(load, index: int, n_items: int, img_size: int,
                   hyp: YoloAugHyp, rng: np.random.RandomState
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One detection training sample: mosaic (+ mixup) or letterbox, the
    perspective warp, HSV, flips.  load(i) -> (uint8 RGB image, (n, 5)
    normalized labels).  Returns (img_size² uint8 image, (m, 5)
    normalized labels)."""
    use_mosaic = rng.rand() < hyp.mosaic

    def one_mosaic(idx):
        picks = [idx] + [int(rng.randint(n_items)) for _ in range(3)]
        rng.shuffle(picks)
        items = []
        for j in picks:
            img, lab = load(j)
            items.append((load_image_resized(img, img_size), lab))
        img4, lab4 = mosaic4(items, img_size, rng)
        return random_perspective(
            img4, lab4, rng, hyp.degrees, hyp.translate, hyp.scale,
            hyp.shear, hyp.perspective,
            border=(-img_size // 2, -img_size // 2))

    if use_mosaic:
        img, labels = one_mosaic(index)
        if rng.rand() < hyp.mixup:
            img2, labels2 = one_mosaic(int(rng.randint(n_items)))
            img, labels = mixup(img, labels, img2, labels2, rng)
    else:
        raw, lab = load(index)
        raw = load_image_resized(raw, img_size)
        h, w = raw.shape[:2]
        img, r, pad = letterbox(raw, img_size)
        labels = lab.astype(np.float64).copy()
        if len(labels):
            labels[:, 1:5] = xywhn2xyxy(lab[:, 1:5], r * w, r * h,
                                        pad[0], pad[1])
        img, labels = random_perspective(
            img, labels, rng, hyp.degrees, hyp.translate, hyp.scale,
            hyp.shear, hyp.perspective)
    img, labels, _ = _tail(img, labels, rng, hyp)
    return img, labels

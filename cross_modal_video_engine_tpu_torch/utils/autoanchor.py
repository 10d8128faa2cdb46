"""AutoAnchor: kmeans and genetic anchor evolution (host-side numpy).

A copy of cross_modal_video_engine_tpu/utils/autoanchor.py (the
reference's utils/autoanchor.py): `check_anchors` measures the
best-possible recall of the current anchors against the dataset's box
shapes and, below 0.98, evolves a better set with whitened kmeans
(scipy's, seeded from the same RandomState) and mutation hill-climbing
(`kmean_anchors`); `group_anchors` keeps the mean anchor area rising
with the stride.  Plain numpy and scipy, so the same RandomState gives
the same anchors in both packages.  Anchors are in pixels.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def dataset_wh(shapes: np.ndarray, labels: Sequence[np.ndarray],
               img_size: int,
               rng: np.random.RandomState = None) -> np.ndarray:
    """Collect label wh in train-resolution pixels
    (autoanchor.py:33-35): per-image shapes scaled so the long side is
    img_size, boxes scaled by a 0.9-1.1 jitter when rng is given.

    shapes: (N, 2) original (h, w) per image;
    labels: per image (n, 5) normalized [cls, cx, cy, w, h]."""
    shapes = np.asarray(shapes, np.float64)
    scaled = img_size * shapes / shapes.max(1, keepdims=True)
    if rng is not None:
        scaled = scaled * rng.uniform(0.9, 1.1, size=(len(shapes), 1))
    whs = []
    for s, lab in zip(scaled, labels):
        if len(lab):
            # normalized w scales by image w (s[1]), h by s[0]
            whs.append(lab[:, 3:5] * s[::-1])
    return (np.concatenate(whs, 0) if whs
            else np.zeros((0, 2), np.float64))


def anchor_metric(anchors: np.ndarray, wh: np.ndarray,
                  thr: float = 4.0) -> Tuple[float, float]:
    """(best-possible-recall, anchors-above-threshold-per-target)
    (autoanchor.py:37-43).  anchors (A, 2) pixels, wh (N, 2) pixels."""
    if len(wh) == 0:
        return 1.0, float(len(anchors))
    r = wh[:, None] / anchors[None]
    x = np.minimum(r, 1.0 / r).min(2)
    best = x.max(1)
    aat = float((x > 1.0 / thr).sum(1).mean())
    bpr = float((best > 1.0 / thr).mean())
    return bpr, aat


def kmean_anchors(wh: np.ndarray, n: int = 9, img_size: int = 640,
                  thr: float = 4.0, gen: int = 1000,
                  rng: np.random.RandomState = None) -> np.ndarray:
    """Whitened kmeans init + genetic evolution (autoanchor.py:69-170).
    Returns (n, 2) anchors sorted small-to-large by area."""
    rng = rng or np.random.RandomState(0)
    inv_thr = 1.0 / thr
    wh = np.asarray(wh, np.float64)
    wh = wh[(wh >= 2.0).any(1)]                       # filter tiny (:128)

    def fitness(k):
        r = wh[:, None] / k[None]
        best = np.minimum(r, 1.0 / r).min(2).max(1)
        return (best * (best > inv_thr)).mean()       # (:98-100)

    try:
        from scipy.cluster.vq import kmeans
        assert n <= len(wh)
        s = wh.std(0)
        k = kmeans(wh / s, n, iter=30, seed=rng)[0] * s
        assert n == len(k)
    except Exception:
        k = np.sort(rng.rand(n * 2)).reshape(n, 2) * img_size   # (:139)

    f, sh, mp, sigma = fitness(k), k.shape, 0.9, 0.1
    for _ in range(gen):                              # evolve (:156-167)
        v = np.ones(sh)
        while (v == 1).all():
            v = ((rng.random_sample(sh) < mp) * rng.rand()
                 * rng.randn(*sh) * sigma + 1).clip(0.3, 3.0)
        kg = (k.copy() * v).clip(min=2.0)
        fg = fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()
    return k[np.argsort(k.prod(1))].astype(np.float32)


def group_anchors(anchors: np.ndarray, nl: int = 3) -> Tuple:
    """(n, 2) area-sorted anchors -> per-layer tuples, smallest on the
    highest-resolution layer (check_anchor_order semantics :19-26 —
    mean area ascending with stride)."""
    per = len(anchors) // nl
    return tuple(tuple((float(w), float(h))
                       for w, h in anchors[i * per:(i + 1) * per])
                 for i in range(nl))


def check_anchors(shapes: np.ndarray, labels: Sequence[np.ndarray],
                  anchors: Sequence[Sequence[Tuple[float, float]]],
                  thr: float = 4.0, img_size: int = 640,
                  gen: int = 1000,
                  rng: np.random.RandomState = None):
    """check_anchors (:29-66): returns (anchors, bpr, recomputed).
    `anchors` in/out are the per-layer pixel tuples of YoloConfig."""
    rng = rng or np.random.RandomState(0)
    wh = dataset_wh(shapes, labels, img_size, rng)
    flat = np.asarray([a for layer in anchors for a in layer], np.float64)
    bpr, _ = anchor_metric(flat, wh, thr)
    if bpr > 0.98 or len(wh) < len(flat):
        return tuple(anchors), bpr, False
    new = kmean_anchors(wh, n=len(flat), img_size=img_size, thr=thr,
                        gen=gen, rng=rng)
    new_bpr, _ = anchor_metric(new, wh, thr)
    if new_bpr <= bpr:                                # keep originals (:63)
        return tuple(anchors), bpr, False
    return group_anchors(new, len(anchors)), new_bpr, True

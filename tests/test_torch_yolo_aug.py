"""The port's detector augmentations (data/yolo_aug.py) and AutoAnchor
(utils/autoanchor.py) against the JAX package's and against cv2, on the
CPU.  Images, labels and polygons are drawn with numpy; both packages get
the same `np.random.RandomState` seed.

The numpy replacements of cv2 against this environment's cv2:
RGB2HSV, getRotationMatrix2D, warpAffine (INTER_LINEAR, border 114),
fillPoly-as-drawContours and flip bit-equal on every tested shape;
HSV2RGB at most 3e-4 of the channels off by one level (measured over the
whole HSV cube: the vector path bit-equal, the scalar path of a row's
last pixels 1.1e-5 off); warpPerspective at most 1e-3 of the channels
off, by at most 2 levels.

The pipelines: `augment_sample` and `augment_seg_sample` give labels
(and polygons) equal to JAX's and leave the RandomState where JAX's
leaves it; the images differ only where HSV2RGB (or, with perspective,
the warp) does: at most 1e-3 of the channels, by at most 2 levels.
`kmean_anchors` and `check_anchors` equal JAX's."""

import cv2
import numpy as np
import pytest

from cross_modal_video_engine_tpu.data import yolo_aug as jaug
from cross_modal_video_engine_tpu.utils import autoanchor as jaa
from cross_modal_video_engine_tpu_torch.data import yolo_aug as taug
from cross_modal_video_engine_tpu_torch.utils import autoanchor as taa

SHAPES = [(17, 23), (32, 32), (40, 71), (64, 48), (90, 33), (5, 120),
          (128, 96), (33, 200), (200, 31), (77, 77), (240, 320)]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape + (3,),
                                                dtype=np.uint8)


def _off(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return float((d > 0).mean()), int(d.max(initial=0))


@pytest.mark.parametrize("shape", SHAPES)
def test_hsv_conversions_against_cv2(shape):
    img = _img(shape, sum(shape))
    hsv = taug.rgb2hsv(img)
    np.testing.assert_array_equal(hsv, cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    share, worst = _off(taug.hsv2rgb(hsv),
                        cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    assert share <= 3e-4 and worst <= 1


def _matrix(rng, h, w):
    M = np.eye(3)
    M[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-30, 30),
                                    center=(0, 0),
                                    scale=rng.uniform(0.5, 1.5))
    M[0, 1] += rng.uniform(-0.2, 0.2)
    M[0, 2], M[1, 2] = rng.uniform(-20, w), rng.uniform(-20, h)
    return M


@pytest.mark.parametrize("shape", SHAPES)
def test_warps_against_cv2(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    img = _img(shape, sum(shape) + 2)
    h, w = shape
    M = _matrix(rng, h, w)
    dsize = (int(rng.integers(20, 120)), int(rng.integers(20, 120)))
    np.testing.assert_array_equal(
        taug.warp_affine(img, M[:2], dsize),
        cv2.warpAffine(img, M[:2], dsize=dsize, borderValue=(114, 114, 114)))
    M[2, :2] = rng.uniform(-1e-3, 1e-3, 2)
    share, worst = _off(
        taug.warp_perspective(img, M, dsize),
        cv2.warpPerspective(img, M, dsize=dsize,
                            borderValue=(114, 114, 114)))
    assert share <= 1e-3 and worst <= 2


@pytest.mark.parametrize("angle,scale", [(0.0, 1.0), (10.0, 0.5),
                                         (-33.3, 1.7), (90.0, 1.0),
                                         (179.0, 0.9)])
def test_rotation_matrix_against_cv2(angle, scale):
    np.testing.assert_array_equal(
        taug.rotation_matrix_2d(angle, scale),
        cv2.getRotationMatrix2D(angle=angle, center=(0, 0), scale=scale))


@pytest.mark.parametrize("seed", range(10))
def test_fill_poly_is_draw_contours(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(20, 90, 2))
    n = int(rng.integers(3, 12))
    pts = np.stack([rng.uniform(-10, w + 10, n),
                    rng.uniform(-10, h + 10, n)], 1).astype(np.int32)
    want = np.zeros((h, w, 3), np.uint8)
    cv2.drawContours(want, [pts], -1, (1, 1, 1), cv2.FILLED)
    got = taug.fill_poly(np.zeros((h, w, 3), np.uint8), pts, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.ascontiguousarray(got[:, ::-1]),
                                  cv2.flip(want, 1))


# -- the pipelines -----------------------------------------------------------

def _dataset(n, seed, size=(60, 100)):
    """n images of varied shapes with 0-4 boxes each, and per box a
    polygon inside it (normalized)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(*size, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        polys = []
        for _ in range(int(rng.integers(0, 5))):
            c = rng.uniform(0.2, 0.8, 2)
            r = rng.uniform(0.05, 0.2)
            a = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 9))))
            p = c + r * np.stack([np.cos(a), np.sin(a)], 1)
            polys.append((float(rng.integers(0, 3)),
                          p.clip(0, 1).astype(np.float32)))
        items.append((img, polys))
    return items


HYPS = {
    "shipped": {},
    "no-mosaic": dict(mosaic=0.0, degrees=5.0, shear=2.0),
    "mixup+flipud": dict(mixup=1.0, flipud=0.5, degrees=10.0, scale=0.3),
    "perspective": dict(perspective=5e-4, degrees=3.0),
}


@pytest.mark.parametrize("name", sorted(HYPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_sample_matches_jax(name, seed):
    items = _dataset(6, 30 + seed)

    def load(i):
        img, polys = items[i]
        return img, jaug.segments2boxes(polys)

    kw = HYPS[name]
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    for index in range(3):
        want_img, want_lab = jaug.augment_sample(
            load, index, len(items), 64, jaug.YoloAugHyp(**kw), jr)
        got_img, got_lab = taug.augment_sample(
            load, index, len(items), 64, taug.YoloAugHyp(**kw), tr)
        np.testing.assert_array_equal(got_lab, want_lab)
        assert got_img.shape == want_img.shape == (64, 64, 3)
        share, worst = _off(got_img, want_img)
        assert share <= 1e-3 and worst <= 2, (share, worst)
    assert str(jr.get_state()) == str(tr.get_state())


@pytest.mark.parametrize("name,copy", [("shipped", 0.0), ("shipped", 0.5),
                                       ("no-mosaic", 0.0),
                                       ("mixup+flipud", 0.3)])
def test_augment_seg_sample_matches_jax(name, copy):
    items = _dataset(5, 40)
    kw = dict(HYPS[name], copy_paste=copy)
    jr, tr = np.random.RandomState(3), np.random.RandomState(3)
    for index in range(3):
        want = jaug.augment_seg_sample(lambda i: items[i], index, len(items),
                                       64, jaug.YoloAugHyp(**kw), jr)
        got = taug.augment_seg_sample(lambda i: items[i], index, len(items),
                                      64, taug.YoloAugHyp(**kw), tr)
        np.testing.assert_array_equal(got[1], want[1])
        assert len(got[2]) == len(want[2])
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
        share, worst = _off(got[0], want[0])
        assert share <= 1e-3 and worst <= 2, (share, worst)
    assert str(jr.get_state()) == str(tr.get_state())


def test_load_image_resized_matches_jax():
    for shape in SHAPES:
        img = _img(shape, 7)
        np.testing.assert_array_equal(taug.load_image_resized(img, 64),
                                      jaug.load_image_resized(img, 64))


# -- AutoAnchor ----------------------------------------------------------------

def _labels(seed, n_img=12, wh_range=(0.01, 0.9)):
    rng = np.random.default_rng(seed)
    shapes = rng.integers(200, 640, (n_img, 2)).astype(np.float64)
    labels = []
    for _ in range(n_img):
        k = int(rng.integers(1, 6))
        wh = rng.uniform(*wh_range, (k, 2))
        labels.append(np.concatenate(
            [rng.integers(0, 3, (k, 1)), rng.uniform(0.2, 0.8, (k, 2)), wh],
            1).astype(np.float32))
    return shapes, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_kmean_anchors_matches_jax(seed):
    shapes, labels = _labels(seed)
    wh = taa.dataset_wh(shapes, labels, 640, np.random.RandomState(seed))
    np.testing.assert_array_equal(
        wh, jaa.dataset_wh(shapes, labels, 640, np.random.RandomState(seed)))
    np.testing.assert_array_equal(
        taa.kmean_anchors(wh, 9, 640, gen=200,
                          rng=np.random.RandomState(seed)),
        jaa.kmean_anchors(wh, 9, 640, gen=200,
                          rng=np.random.RandomState(seed)))


@pytest.mark.parametrize("wh_range,changed", [((0.03, 0.4), False),
                                               ((0.005, 0.9), True)])
def test_check_anchors_matches_jax(wh_range, changed):
    shapes, labels = _labels(5, wh_range=wh_range)
    anchors = (((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45), (59, 119)),
               ((116, 90), (156, 198), (373, 326)))
    got = taa.check_anchors(shapes, labels, anchors, gen=200)
    want = jaa.check_anchors(shapes, labels, anchors, gen=200)
    assert got == want
    assert got[2] == changed

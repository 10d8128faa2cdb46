"""The port's YOLOv5 criterion (losses/yolo.py) against the JAX package's,
on the CPU: `build_targets` field by field, `yolo_loss` and
`yolo_seg_loss` values and gradients with respect to the raw maps and
prototypes, a batch whose targets share cells (the objectness target by
max), and one past the segment loss's mask cap.  Maps, targets and masks
are drawn with numpy.

Tolerances: `build_targets` equal (the float fields within 1e-6); loss
values within 1e-5 relative; gradients within 1e-5 of their largest
magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.losses import yolo as jloss
from cross_modal_video_engine_tpu_torch.losses import yolo as tloss

ANCHORS = ((10, 13), (16, 30), (33, 23)), ((30, 61), (62, 45), (59, 119)), \
    ((116, 90), (156, 198), (373, 326))
STRIDES = (8, 16, 32)
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _targets(seed, B=2, T=5, nc=3, n_valid=(3, 5), size=(0.05, 0.6)):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0.05, 0.95, (B, T, 2))
    wh = rng.uniform(*size, (B, T, 2))
    cls = rng.integers(0, nc, (B, T, 1))
    t = np.concatenate([cls, cxy, wh], -1).astype(np.float32)
    valid = np.zeros((B, T), bool)
    for b, n in enumerate(n_valid):
        valid[b, :n] = True
    return t, valid


def _maps(seed, B, img, no, nm=0):
    rng = np.random.default_rng(seed)
    maps = [rng.standard_normal((B, img // s, img // s, 3 * no))
            .astype(np.float32) for s in STRIDES]
    proto = (rng.standard_normal((B, img // 4, img // 4, nm))
             .astype(np.float32) if nm else None)
    return maps, proto


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("seed,img", [(0, 64), (1, 96), (2, 128)])
def test_build_targets_matches_jax(seed, img):
    t, v = _targets(seed)
    shapes = [(img // s, img // s) for s in STRIDES]
    want = jloss.build_targets(jnp.asarray(t), jnp.asarray(v), ANCHORS,
                               STRIDES, shapes)
    got = tloss.build_targets(torch.from_numpy(t), torch.from_numpy(v),
                              ANCHORS, STRIDES, shapes)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for field in tloss.LayerTargets._fields:
            a, b = getattr(g, field).numpy(), np.asarray(getattr(w, field))
            assert a.shape == b.shape, field
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                           err_msg=field)
            else:
                np.testing.assert_array_equal(a, b, err_msg=field)
    assert any(bool(g.mask.any()) for g in got)


def _jax_loss(maps, t, v, nc, proto=None, gt=None, nm=0, cap=128):
    hyp = jloss.scale_hyp(jloss.YoloHyp(), nl=3, nc=nc, imgsz=64)

    def f(maps, proto):
        if proto is None:
            return jloss.yolo_loss(maps, jnp.asarray(t), jnp.asarray(v),
                                   ANCHORS, hyp=hyp, num_classes=nc)
        return jloss.yolo_seg_loss(maps, proto, jnp.asarray(t),
                                   jnp.asarray(v), jnp.asarray(gt), ANCHORS,
                                   hyp=hyp, num_classes=nc, nm=nm,
                                   mask_cap=cap)

    (total, items), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(m) for m in maps],
        None if proto is None else jnp.asarray(proto))
    return total, items, grads


def _torch_loss(maps, t, v, nc, proto=None, gt=None, nm=0, cap=128):
    hyp = tloss.scale_hyp(tloss.YoloHyp(), nl=3, nc=nc, imgsz=64)
    tm = [torch.tensor(m, requires_grad=True) for m in maps]
    tp = None if proto is None else torch.tensor(proto, requires_grad=True)
    if tp is None:
        total, items = tloss.yolo_loss(tm, torch.from_numpy(t),
                                       torch.from_numpy(v), ANCHORS, hyp=hyp,
                                       num_classes=nc)
    else:
        total, items = tloss.yolo_seg_loss(
            tm, tp, torch.from_numpy(t), torch.from_numpy(v),
            torch.from_numpy(gt), ANCHORS, hyp=hyp, num_classes=nc, nm=nm,
            mask_cap=cap)
    total.backward()
    return total, items, ([m.grad for m in tm],
                          None if tp is None else tp.grad)


def _check(got, want):
    (gt_total, g_items, (g_maps, g_proto)) = got
    (w_total, w_items, (w_maps, w_proto)) = want
    _close(gt_total.detach(), w_total)
    assert set(g_items) == set(w_items)
    for k in w_items:
        _close(g_items[k].detach(), w_items[k])
    for a, b in zip(g_maps, w_maps):
        _close(a, b)
    if w_proto is not None:
        _close(g_proto, w_proto)


@pytest.mark.parametrize("nc,seed", [(3, 3), (1, 4), (5, 5)])
def test_yolo_loss_and_grads_match_jax(nc, seed):
    t, v = _targets(seed, nc=nc)
    maps, _ = _maps(seed, 2, 64, 5 + nc)
    _check(_torch_loss(maps, t, v, nc), _jax_loss(maps, t, v, nc))


def test_duplicate_cells_take_the_max_objectness():
    """Two targets of one image at the same centre and nearly the same
    size: their candidates write the same cells."""
    t, v = _targets(6, T=4, n_valid=(4, 2))
    t[0, 1, 1:] = t[0, 0, 1:] * np.float32(1.01)
    t[0, 2, 1:3] = t[0, 0, 1:3]
    maps, _ = _maps(6, 2, 64, 8)
    got = _torch_loss(maps, t, v, 3)
    _check(got, _jax_loss(maps, t, v, 3))
    shapes = [(64 // s, 64 // s) for s in STRIDES]
    lt = tloss.build_targets(torch.from_numpy(t), torch.from_numpy(v),
                             ANCHORS, STRIDES, shapes)
    cells = [(int(b), int(j), int(i), int(a)) for l in lt[:1]
             for b, j, i, a, m in zip(l.b, l.gj, l.gi, l.a, l.mask) if m]
    assert len(cells) > len(set(cells))


@pytest.mark.parametrize("cap,seed", [(128, 7), (4, 8)])
def test_yolo_seg_loss_matches_jax(cap, seed):
    nc, nm = 3, 4
    t, v = _targets(seed, T=6, n_valid=(6, 4))
    maps, proto = _maps(seed, 2, 64, 5 + nc + nm, nm)
    gt = (np.random.default_rng(seed).random((2, 6, 16, 16)) > 0.6).astype(
        np.float32)
    got = _torch_loss(maps, t, v, nc, proto, gt, nm, cap)
    want = _jax_loss(maps, t, v, nc, proto, gt, nm, cap)
    _check(got, want)
    if cap == 4:
        assert int(got[1]["seg_dropped"]) > 0


def test_bbox_ciou_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.uniform(0.1, 3, (50, 4)).astype(np.float32)
    b = rng.uniform(0.1, 3, (50, 4)).astype(np.float32)
    _close(tloss.bbox_ciou(torch.from_numpy(a), torch.from_numpy(b)),
           jloss.bbox_ciou(jnp.asarray(a), jnp.asarray(b)))

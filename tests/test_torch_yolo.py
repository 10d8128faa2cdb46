"""The port's YOLOv5 (models/yolo.py, the YOLO pair of convert/from_jax.py)
against the JAX package's, on the CPU at a small size (width 0.125, depth
0.33, 64-128 px images, f32).  One seeded state dict in the ultralytics
layout (models/yolo.random_state_dict) loads into the port directly and
into the JAX package through convert_yolov5 / convert_yolov5_cls.

Tolerances: raw maps, prototypes and class logits within 1e-5 of their
largest magnitude; decoded predictions within 1e-5 relative; NMS outputs,
masks, TTA row counts and the converters' trees equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.convert import (convert_yolov5,
                                                  convert_yolov5_cls)
from cross_modal_video_engine_tpu.models import yolo as jyolo
from cross_modal_video_engine_tpu_torch.convert import (
    yolo_cls_state_dict_from_jax, yolo_cls_variables_to_jax,
    yolo_state_dict_from_jax, yolo_variables_to_jax)
from cross_modal_video_engine_tpu_torch.models import yolo as tyolo

REL = 1e-5
DETECT = tyolo.YoloConfig(num_classes=6, depth_multiple=0.33,
                          width_multiple=0.125, img_size=64)
SEGMENT = dataclasses.replace(DETECT, masks=4, protos=16)
CLASSIFY = tyolo.YoloConfig(num_classes=5, depth_multiple=0.33,
                            width_multiple=0.125, img_size=64)
CONFIGS = {"detect": DETECT, "segment": SEGMENT}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _jcfg(cfg):
    return jyolo.YoloConfig(**dataclasses.asdict(cfg))


def _images(n, h, w, seed=5):
    return np.random.default_rng(seed).random((n, h, w, 3), np.float32)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(scale, 1e-6))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(config, seeded state dict, the port's model, the JAX variables
    from convert_yolov5, and both packages' raw outputs on one seeded
    batch of 64x96 images)."""
    cfg = CONFIGS[request.param]
    sd = tyolo.random_state_dict(cfg, seed=3, fire=(1, 4))
    tm = tyolo.YoloV5(cfg, device="cpu")
    tm.load_state_dict(sd)
    variables = convert_yolov5(sd, cfg)
    x = _images(2, 64, 96)
    want = jax.jit(jyolo.YoloV5(_jcfg(cfg)).apply)(variables, jnp.asarray(x))
    return cfg, sd, tm, variables, _run_port(tm, x), want


def _run_port(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x))


def test_raw_maps_and_prototypes_match_jax(pair):
    cfg, _, _, _, got, want = pair
    if cfg.masks:
        (want, wproto), (got, gproto) = want, got
        assert gproto.shape == (2, 16, 24, cfg.masks)
        _close(gproto.numpy(), wproto)
    assert [tuple(g.shape) for g in got] == [
        (2, 8, 12, 3 * (5 + cfg.num_classes + cfg.masks)),
        (2, 4, 6, 3 * (5 + cfg.num_classes + cfg.masks)),
        (2, 2, 3, 3 * (5 + cfg.num_classes + cfg.masks))]
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_classifier_matches_jax():
    sd = tyolo.random_state_dict(CLASSIFY, seed=4, classifier=True)
    tm = tyolo.YoloClassifier(CLASSIFY, device="cpu")
    tm.load_state_dict(sd)
    variables = convert_yolov5_cls(sd, CLASSIFY)
    x = _images(3, 64, 64, seed=6)
    want = jax.jit(jyolo.YoloClassifier(_jcfg(CLASSIFY)).apply)(
        variables, jnp.asarray(x))
    _close(_run_port(tm, x).numpy(), want)
    # both directions of the converter pair
    back = yolo_cls_state_dict_from_jax(variables, CLASSIFY)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    _same_tree(yolo_cls_variables_to_jax(sd, CLASSIFY), variables)


def _same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_from_jax_round_trips_the_converter(pair):
    cfg, sd, _, variables, _, _ = pair
    _same_tree(yolo_variables_to_jax(sd, cfg), variables)
    back = yolo_state_dict_from_jax(variables, cfg)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_decode_matches_jax(pair):
    cfg, _, _, _, raw, jraw = pair
    want = jyolo.decode_predictions(jraw[0] if cfg.masks else jraw,
                                    _jcfg(cfg))
    got = tyolo.decode_predictions(raw[0] if cfg.masks else raw, cfg)
    assert got.shape == want.shape == (2, 3 * (96 + 24 + 6), 5 +
                                       cfg.num_classes + cfg.masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL,
                               atol=REL)


def test_decode_order_is_h_w_anchor():
    """Row r of a scale is cell (r // 3 // W, r // 3 % W), anchor r % 3,
    as the JAX package flattens it (not ultralytics' anchor-major)."""
    cfg = dataclasses.replace(DETECT, num_classes=1)
    maps = [torch.zeros(1, h, w, 18) for h, w in ((4, 6), (2, 3), (1, 2))]
    maps[0][0, 2, 5, 6 + 4] = 9.0          # cell (2, 5), anchor 1: obj
    dec = tyolo.decode_predictions(maps, cfg)
    row = int(dec[0, :, 4].argmax())
    assert row == (2 * 6 + 5) * 3 + 1
    assert float(dec[0, row, 0]) == pytest.approx((0.5 + 5) * 8)


def test_nms_and_postprocess_match_jax(pair):
    cfg, _, _, _, raw, _ = pair
    preds = tyolo.decode_predictions(raw[0] if cfg.masks else raw,
                                     cfg).numpy()
    for conf, multi in ((0.25, False), (0.001, True)):
        if cfg.masks:
            proto = raw[1].numpy()
            got = tyolo.postprocess_seg(preds, proto, (64, 96), conf,
                                        multi_label=multi)
            want = jyolo.postprocess_seg(preds, proto, (64, 96), conf,
                                         multi_label=multi)
            for (gd, gm), (wd, wm) in zip(got, want):
                np.testing.assert_array_equal(gd, wd)
                np.testing.assert_array_equal(gm, wm)
        else:
            got = tyolo.postprocess(preds, conf, multi_label=multi)
            want = jyolo.postprocess(preds, conf, multi_label=multi)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert sum(len(g if not cfg.masks else g[0]) for g in got) > 0


def test_process_mask_matches_jax():
    rng = np.random.default_rng(9)
    proto = rng.standard_normal((16, 24, 4)).astype(np.float32)
    coefs = rng.standard_normal((5, 4)).astype(np.float32)
    xy = rng.uniform(0, 60, (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (5, 2))], 1)
    for up in (True, False):
        want = jyolo.process_mask(proto, coefs, boxes, (64, 96), up)
        got = tyolo.process_mask(proto, coefs, boxes, (64, 96), up)
        np.testing.assert_array_equal(got, want)
        assert got.any()


@pytest.mark.parametrize("ratio,flip", jyolo.TTA_SCALES)
def test_tta_geometry_matches_jax(ratio, flip):
    x = _images(2, 64, 96, seed=10)
    want = jyolo.scale_img(jnp.asarray(x), ratio)
    got = tyolo.scale_img(torch.from_numpy(x), ratio)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    p = np.random.default_rng(11).random((2, 30, 11)).astype(np.float32)
    np.testing.assert_allclose(
        tyolo.descale_pred(torch.from_numpy(p), flip, ratio,
                           (64, 96)).numpy(),
        np.asarray(jyolo.descale_pred(jnp.asarray(p), flip, ratio,
                                      (64, 96))), rtol=1e-6, atol=1e-5)


def test_clip_augmented_matches_jax():
    ys = [np.zeros((1, 21 * 3 * k, 2), np.float32) for k in (16, 11, 7)]
    for y in ys:
        y[..., 0] = np.arange(y.shape[1])
    got = tyolo.clip_augmented([torch.from_numpy(y) for y in ys])
    want = jyolo.clip_augmented([jnp.asarray(y) for y in ys])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hw,ok", [((352, 480), True), ((360, 480), False),
                                   ((340, 256), False)])
def test_both_packages_refuse_frames_off_the_32_grid(hw, ok):
    """The size rule does not depend on the width: shapes only (the JAX
    model traced abstractly, the port's on the meta device)."""
    jm = jyolo.YoloV5(_jcfg(DETECT))
    variables = convert_yolov5(tyolo.random_state_dict(DETECT, 1), DETECT)
    x = jax.ShapeDtypeStruct((1, *hw, 3), jnp.float32)
    tm = tyolo.YoloV5(DETECT, device="meta")
    t = torch.empty(1, *hw, 3, device="meta")
    if ok:
        jax.eval_shape(jm.apply, variables, x)
        assert [tuple(m.shape[1:3]) for m in tm(t)] == [
            (hw[0] // s, hw[1] // s) for s in (8, 16, 32)]
        return
    with pytest.raises(TypeError, match="oncatenate"):
        jax.eval_shape(jm.apply, variables, x)
    with pytest.raises(ValueError, match="multiples of 32"):
        tm(t)


def test_train_mode_and_s2d_stem_are_refused():
    """Train mode is ported (flax's BatchNorm update: running = 0.97 *
    running + 0.03 * batch with the biased variance); the s2d stem, a TPU
    retiling, stays refused."""
    model = tyolo.YoloV5(DETECT, device="cpu")
    model.load_state_dict(tyolo.random_state_dict(DETECT, seed=1))
    bn = model.model[0].bn
    before = bn.running_var.clone(), bn.running_mean.clone()
    x = torch.from_numpy(_images(2, 64, 64))
    with torch.no_grad():
        pre = model.model[0].conv(x.permute(0, 3, 1, 2))
        model.train()(x)
    var, mean = torch.var_mean(pre, dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.97 * before[1] + 0.03 * mean)
    torch.testing.assert_close(bn.running_var, 0.97 * before[0] + 0.03 * var)
    with pytest.raises(ValueError, match="s2d_stem"):
        tyolo.YoloConfig(s2d_stem=True)


def test_nms_breaks_ties_as_the_jax_package_does():
    """Equal scores: NMS meets them in np.argsort(-scores)'s order, so
    the kept boxes of the same candidates are the JAX package's."""
    rng = np.random.default_rng(13)
    xy = rng.uniform(0, 60, (40, 2))
    boxes = np.concatenate([xy, rng.uniform(10, 30, (40, 2))], 1)
    scores = np.repeat(rng.uniform(0.3, 0.9, 10), 4)
    classes = rng.integers(0, 2, 40)
    got = tyolo.nms(boxes, scores, classes, 0.45)
    np.testing.assert_array_equal(got, jyolo.nms(boxes, scores, classes,
                                                 0.45))
    assert len(got) < 40


def test_sppf_pads_its_pools_with_minus_infinity():
    """An all-negative map: each pool's border takes the window's own
    maximum, not the 0 a zero pad would give."""
    sppf = tyolo.SPPF(8, 8, device="cpu").eval()
    x = -1.0 - torch.rand(1, 4, 6, 6)
    with torch.no_grad():
        y = torch.nn.functional.max_pool2d(x, 5, 1, 2)
    assert float(y.max()) < 0
    assert torch.equal(y[0, :, 0, 0], x[0, :, :3, :3].amax((1, 2)))
    sppf(torch.zeros(1, 8, 6, 6))            # shapes only


def test_detect_biases_come_from_the_weights_only():
    """No bias prior is applied at build or load time: a built model's
    Detect biases are zero, a loaded one's those of the state dict."""
    model = tyolo.YoloV5(DETECT, device="cpu")
    for conv in model.model[24].m:
        assert not conv.bias.any()
    sd = tyolo.random_state_dict(DETECT, 2)
    model.load_state_dict(sd)
    for i, conv in enumerate(model.model[24].m):
        assert torch.equal(conv.bias, sd[f"model.24.m.{i}.bias"])

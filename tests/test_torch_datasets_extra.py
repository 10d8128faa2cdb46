"""The port's extra datasets, sampler and pipeline ops against the JAX
package's, on the CPU:

* `ClassSpecificSampler`: the same indices for every epoch, in both
  `dynamic_length` modes, shuffled or not, over world sizes and ranks;
* `HVUDataset`, `ImageDataset` (single and many-hot labels),
  `RawVideoDataset`, `RepeatDataset`, `ConcatDataset`: the same
  annotations, items and batches;
* the eight pipeline ops `RandomCrop` (pixel and normalized boxes,
  keypoints, the crop quadruple), `RandomRescale`, `BuildPseudoClip`,
  `ImageDecode` (cv2 in both; the port's `reader` seam), `ArrayDecode`
  (RGB and flow), `Rename`, `Transpose`, `Collect`: bit-equal results.
"""

import json

import numpy as np
import pytest

from cross_modal_video_engine_tpu.data import datasets as jds
from cross_modal_video_engine_tpu.data import datasets_extra as jdx
from cross_modal_video_engine_tpu.data import pipelines as jp
from cross_modal_video_engine_tpu_torch.data import datasets as tds
from cross_modal_video_engine_tpu_torch.data import datasets_extra as tdx
from cross_modal_video_engine_tpu_torch.data import pipelines as tp
from cross_modal_video_engine_tpu_torch.data import pipelines_extra as tpx


def _same(a, b):
    """Results dicts (or values) equal, arrays bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("dynamic", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("world,rank", [(1, 0), (3, 2)])
def test_class_specific_sampler_matches_jax(dynamic, shuffle, world, rank):
    labels = list(np.random.default_rng(2).integers(0, 4, 23))
    prob = {0: 1.5, 1: 0.4, 2: 2.0, 3: 1.0, 5: 3.0}
    kw = dict(world_size=world, rank=rank, shuffle=shuffle, seed=11,
              dynamic_length=dynamic)
    j = jds.ClassSpecificSampler(labels, prob, **kw)
    t = tds.ClassSpecificSampler(labels, prob, **kw)
    for epoch in range(3):
        want = [int(i) for i in j.indices(epoch)]
        assert t.indices(epoch) == want


class _Pipe:
    """A pipeline that makes a clip from the item's index."""

    def __call__(self, results):
        n = int(results["filename"].split("_")[-1].split(".")[0])
        return dict(results, imgs=np.full((1, 2, 2, 3), n, np.float32))


def _write(path, text):
    path.write_text(text)
    return str(path)


def test_datasets_match_jax(tmp_path):
    img = _write(tmp_path / "img.txt",
                 "a_0.jpg 3\nb_1.jpg 1\n\nc_2.jpg 0\n")
    multi = _write(tmp_path / "multi.txt", "a_0.jpg 3 1\nb_1.jpg 2\n")
    raw = _write(tmp_path / "raw.txt", "v0 2 5 0 3\nv1 0 4\n")
    for jd, td in (
            (jds.ImageDataset(img, _Pipe(), data_prefix="p"),
             tds.ImageDataset(img, _Pipe(), data_prefix="p")),
            (jds.ImageDataset(multi, _Pipe(), num_classes=4),
             tds.ImageDataset(multi, _Pipe(), num_classes=4)),
            (jds.RawVideoDataset(raw, _Pipe(), data_prefix="r"),
             tds.RawVideoDataset(raw, _Pipe(), data_prefix="r"))):
        _same(jd.video_infos, td.video_infos)
    with pytest.raises(ValueError, match="num_classes"):
        tds.ImageDataset(multi, _Pipe())

    jimg = jds.ImageDataset(img, _Pipe())
    timg = tds.ImageDataset(img, _Pipe())
    jrep, trep = jds.RepeatDataset(jimg, 3), tds.RepeatDataset(timg, 3)
    jcat = jds.ConcatDataset([jimg, jrep])
    tcat = tds.ConcatDataset([timg, trep])
    for jd, td in ((jrep, trep), (jcat, tcat)):
        assert len(jd) == len(td)
        for i in range(len(jd)):
            _same(jd[i], td[i])
        for order in (None, [5, 0, 7, 2, 2]):
            for (ji, jit, jn), (ti, tit, tn) in zip(
                    jd.batches(4, order), td.batches(4, order)):
                _same(ji, ti)
                _same(jit, tit)
                assert jn == tn


def test_hvu_dataset_matches_jax(tmp_path):
    ann = tmp_path / "hvu.json"
    ann.write_text(json.dumps([
        {"filename": "x.mp4", "label": {"action": [0, 2], "scene": [1]}},
        {"filename": "y.mp4", "label": {"object": [3]}},
        {"filename": "z.mp4"}]))
    cats, nums = ["action", "scene", "object"], {"action": 4, "scene": 2,
                                                 "object": 5}
    j = jdx.HVUDataset(str(ann), cats, nums, data_prefix="d")
    t = tdx.HVUDataset(str(ann), cats, nums, data_prefix="d")
    assert len(j) == len(t) == 3
    for i in range(3):
        _same(j[i], t[i])
    jp_ = jdx.HVUDataset(str(ann), cats, nums, pipeline=lambda r: dict(
        r, seen=True))
    tp_ = tdx.HVUDataset(str(ann), cats, nums, pipeline=lambda r: dict(
        r, seen=True))
    _same(jp_[1], tp_[1])


def _results(seed=0, h=20, w=28):
    rng = np.random.default_rng(seed)
    return {"imgs": [rng.integers(0, 255, (h, w, 3), np.uint8)
                     for _ in range(3)],
            "img_shape": (h, w),
            "keypoint": rng.random((2, 3, 4, 2)).astype(np.float32) * 20,
            "gt_bboxes": np.array([[2.0, 3.0, 15.0, 18.0],
                                   [0.0, 0.0, 27.0, 19.0]], np.float32),
            "proposals": np.array([[5.0, 1.0, 9.0, 12.0]], np.float32)}


def _copy(r):
    return {k: ([x.copy() for x in v] if isinstance(v, list) else
                v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in r.items()}


def _both(cfg, results):
    """One op built from cfg by each package, on copies of results."""
    jp.build_pipeline([])                # registers the JAX decode ops
    from cross_modal_video_engine_tpu.utils.registry import PIPELINES as JP
    from cross_modal_video_engine_tpu_torch.utils.registry import (
        PIPELINES as TPR)
    kw = {k: v for k, v in cfg.items() if k != "type"}
    return (JP.get(cfg["type"])(**kw)(_copy(results)),
            TPR.get(cfg["type"])(**kw)(_copy(results)))


@pytest.mark.parametrize("cfg,extra", [
    (dict(type="RandomCrop", size=12, seed=3), {}),
    (dict(type="RandomCrop", size=20, seed=4), {}),
    (dict(type="RandomCrop", size=16, seed=5),
     {"bbox_coords": "normalized",
      "gt_bboxes": np.array([[0.1, 0.2, 0.9, 0.7]], np.float32),
      "crop_quadruple": (0.1, 0.0, 0.8, 1.0)}),
    (dict(type="RandomRescale", scale_range=(14, 30), seed=6), {}),
    (dict(type="Rename", mapping={"keypoint": "kp", "absent": "x"}), {}),
    (dict(type="Transpose", keys=["keypoint"], order=[1, 0, 3, 2]), {}),
    (dict(type="Collect", keys=["imgs", "img_shape"]), {}),
    (dict(type="Collect", keys=["imgs"], meta_keys=["img_shape", "nope"]),
     {}),
])
def test_pipeline_ops_match_jax(cfg, extra):
    for seed in range(3):
        r = dict(_results(seed), **extra)
        _same(*_both(cfg, r))


def test_pseudo_clip_and_array_decode_match_jax():
    rng = np.random.default_rng(8)
    one = {"imgs": [rng.integers(0, 255, (6, 7, 3), np.uint8)]}
    j, t = _both(dict(type="BuildPseudoClip", clip_len=5), one)
    _same(j, t)
    assert len(t["imgs"]) == 5 and t["imgs"][1] is not t["imgs"][0]
    arr = rng.random((9, 6, 7, 3)).astype(np.float32)
    flow = rng.random((9, 6, 7, 2)).astype(np.float32)
    for results in ({"array": arr, "frame_inds": np.array([0, 4, 8])},
                    {"array": arr, "frame_inds": np.array([[2]]),
                     "offset": 1},
                    {"array": flow, "frame_inds": np.array([1, 3]),
                     "modality": "Flow"}):
        _same(*_both(dict(type="ArrayDecode"), results))


def test_image_decode_matches_jax(tmp_path):
    import cv2
    img = np.random.default_rng(9).integers(0, 255, (10, 14, 3), np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    j, t = _both(dict(type="ImageDecode"), {"filename": path})
    _same(j, t)
    np.testing.assert_array_equal(t["imgs"][0], img[..., ::-1])
    seen = []
    op = tpx.ImageDecode(reader=lambda f: seen.append(f) or img)
    out = op({"filename": "any"})
    assert seen == ["any"] and out["img_shape"] == (10, 14)
    with pytest.raises(FileNotFoundError):
        tpx.ImageDecode()({"filename": str(tmp_path / "missing.png")})
    # built from a config as the JAX package builds it
    pipe = tp.build_pipeline([dict(type="ImageDecode"),
                              dict(type="BuildPseudoClip", clip_len=2)])
    assert len(pipe({"filename": path})["imgs"]) == 2

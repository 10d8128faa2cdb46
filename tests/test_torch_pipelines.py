"""The port's host-side caption modules against the JAX package's, on the
CPU: the pipeline ops (data/pipelines.py, the decode ops of
io/video_decode.py), the registry, Config on the shipped seq_generate
configs, VideoDatasetRelseq and the accuracy metrics.

`Resize` never calls OpenCV in the port; on uint8 frames it must equal
`cv2.resize(..., INTER_LINEAR)` (and so the JAX op) bit for bit, on
downscales, upscales and the identity.  Float frames follow OpenCV's
float path within 0.02 on the 0-255 scale (its own rounding order).  Every
other op gives the JAX op's output exactly for the same seed and input;
seq_average_precision equals JAX's within 1e-7."""

import copy
import glob
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from cross_modal_video_engine_tpu import config as jconfig
from cross_modal_video_engine_tpu.data import datasets as jds
from cross_modal_video_engine_tpu.data import pipelines as jp
from cross_modal_video_engine_tpu.io import video_decode as jvd
from cross_modal_video_engine_tpu.metrics import accuracy as jacc
from cross_modal_video_engine_tpu.models.decoder_head import (
    RNNDecoderConfig as JaxDecoderConfig)
from cross_modal_video_engine_tpu_torch import config as tconfig
from cross_modal_video_engine_tpu_torch.data import datasets as tds
from cross_modal_video_engine_tpu_torch.data import pipelines as tp
from cross_modal_video_engine_tpu_torch.io import video_decode as tvd
from cross_modal_video_engine_tpu_torch.metrics import accuracy as tacc
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
from cross_modal_video_engine_tpu_torch.models.timesformer import (
    TimeSformerConfig)
from cross_modal_video_engine_tpu_torch.utils.registry import (
    PIPELINES, Registry)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (H, W) -> (h, w): the thirteen resizes of the caption path's sizes
# (short side 256 from common video sizes, 224 crops, the identity), then
# upscales and odd shapes at both borders
RESIZES = [((360, 480), (256, 341)), ((480, 640), (256, 341)),
           ((240, 320), (256, 341)), ((200, 300), (256, 384)),
           ((100, 150), (256, 384)), ((720, 1280), (256, 455)),
           ((1080, 1920), (256, 455)), ((480, 854), (256, 455)),
           ((512, 682), (256, 341)), ((256, 341), (224, 224)),
           ((448, 448), (224, 224)), ((257, 300), (256, 299)),
           ((256, 256), (256, 256)), ((7, 5), (3, 11)), ((1, 9), (4, 4)),
           ((40, 48), (32, 32)), ((31, 17), (64, 5)), ((2, 2), (9, 13)),
           ((64, 48), (128, 96)), ((300, 200), (150, 101))]
FLOAT_TOL = 0.02


def _frames(shape, seed=0, n=2):
    return np.random.default_rng(seed).integers(0, 256, (n,) + shape + (3,),
                                                dtype=np.uint8)


@pytest.mark.parametrize("src,dst", RESIZES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                              for a, b in RESIZES])
def test_resize_equals_cv2_bit_for_bit(src, dst):
    frames = _frames(src, seed=src[0] * 7 + dst[1])
    h, w = dst
    got = tp.resize_linear(frames, (w, h))
    want = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                     for f in frames])
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the op, on the JAX op's results dict
    t = tp.Resize(scale=(w, h), keep_ratio=False)({"imgs": list(frames)})
    j = jp.Resize(scale=(w, h), keep_ratio=False)({"imgs": list(frames)})
    np.testing.assert_array_equal(np.stack(t["imgs"]), np.stack(j["imgs"]))
    assert t["img_shape"] == j["img_shape"] == (h, w)


@pytest.mark.parametrize("src,dst", RESIZES[:4] + RESIZES[13:17])
def test_resize_float_frames_follow_cv2(src, dst):
    frames = _frames(src, seed=3).astype(np.float32) / 3.0
    h, w = dst
    got = tp.resize_linear(frames, (w, h))
    want = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                     for f in frames])
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)


@pytest.mark.parametrize("scale,keep_ratio", [
    ((-1, 256), True), ((-1, 40), True), ((64, 48), True),
    ((48, 64), True), ((30, 20), False), (50, True)])
def test_resize_op_sizes_match_jax(scale, keep_ratio):
    for shape in ((36, 50), (50, 36)):
        frames = list(_frames(shape, seed=5, n=3))
        t = tp.Resize(scale, keep_ratio)({"imgs": copy.deepcopy(frames)})
        j = jp.Resize(scale, keep_ratio)({"imgs": copy.deepcopy(frames)})
        assert t["img_shape"] == j["img_shape"]
        np.testing.assert_array_equal(np.stack(t["imgs"]),
                                      np.stack(j["imgs"]))


def test_port_resize_never_imports_cv2():
    code = ("import sys; sys.modules['cv2'] = None\n"
            "import numpy as np\n"
            "from cross_modal_video_engine_tpu_torch.data import pipelines\n"
            "from cross_modal_video_engine_tpu_torch import api\n"
            "r = pipelines.build_pipeline([dict(type='Resize', scale=(-1, 8)),"
            " dict(type='MultiScaleCrop', input_size=6, seed=0)])(\n"
            "    {'imgs': list(np.zeros((2, 12, 16, 3), np.uint8))})\n"
            "print(r['imgs'][0].shape)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.stdout.strip() == "(6, 6, 3)", out.stderr[-2000:]


# -- every op against the JAX op ----------------------------------------------

def _sampling_results():
    return {"total_frames": 37, "start_index": 1}


def _image_results(shape=(40, 52), n=6, seed=11, dtype=np.uint8):
    imgs = _frames(shape, seed=seed, n=n)
    return {"imgs": list(imgs.astype(dtype)), "img_shape": shape,
            "num_clips": 2, "clip_len": 3,
            "gt_bboxes": np.array([[0.1, 0.2, 0.5, 0.9]], np.float32),
            "proposals": np.array([[0.0, 0.0, 0.25, 1.0]], np.float32)}


# name -> (kwargs, input maker, calls): random ops are called several
# times so their generators advance as the JAX ones do
OPS = {
    "SampleFrames-train": ("SampleFrames", dict(clip_len=4, frame_interval=2,
                                                num_clips=3, seed=1),
                           _sampling_results, 3),
    "SampleFrames-test": ("SampleFrames", dict(clip_len=8, frame_interval=32,
                                               num_clips=1, test_mode=True),
                          _sampling_results, 1),
    "SampleFrames-twice": ("SampleFrames", dict(
        clip_len=4, frame_interval=3, num_clips=2, test_mode=True,
        twice_sample=True), _sampling_results, 1),
    "SampleFrames-jitter-repeat": ("SampleFrames", dict(
        clip_len=16, frame_interval=4, num_clips=2, temporal_jitter=True,
        out_of_bound_opt="repeat_last", seed=2), _sampling_results, 3),
    "SampleFrames-tail": ("SampleFrames", dict(
        clip_len=4, frame_interval=2, num_clips=3, keep_tail_frames=True,
        seed=3), _sampling_results, 3),
    "SampleFrames-short": ("SampleFrames", dict(
        clip_len=20, frame_interval=2, num_clips=2, seed=4),
        _sampling_results, 3),
    "DenseSampleFrames-train": ("DenseSampleFrames", dict(
        clip_len=4, frame_interval=1, num_clips=2, sample_range=16, seed=5),
        _sampling_results, 3),
    "DenseSampleFrames-test": ("DenseSampleFrames", dict(
        clip_len=4, num_clips=2, sample_range=16, test_mode=True,
        num_sample_positions=3), _sampling_results, 1),
    "UntrimmedSampleFrames": ("UntrimmedSampleFrames", dict(
        clip_len=3, frame_interval=8), _sampling_results, 1),
    "RandomShuffleFrames": ("RandomShuffleFrames", dict(seed=6),
                            _image_results, 3),
    "RandomShuffleFrames-idx": ("RandomShuffleFrames", dict(
        shuffle_idx=[5, 4, 3, 2, 1, 0]), _image_results, 1),
    "Resize": ("Resize", dict(scale=(-1, 32)), _image_results, 1),
    "CenterCrop": ("CenterCrop", dict(crop_size=24), _image_results, 1),
    "RandomResizedCrop": ("RandomResizedCrop", dict(seed=7),
                          _image_results, 4),
    "RandomResizedCrop-miss": ("RandomResizedCrop", dict(
        area_range=(3.0, 4.0), seed=7), _image_results, 1),
    "MultiScaleCrop": ("MultiScaleCrop", dict(input_size=20, seed=8),
                       _image_results, 4),
    "MultiScaleCrop-random": ("MultiScaleCrop", dict(
        input_size=24, random_crop=True, max_wh_scale_gap=2, seed=9),
        _image_results, 4),
    "ThreeCrop": ("ThreeCrop", dict(crop_size=30), _image_results, 1),
    "ThreeCrop-tall": ("ThreeCrop", dict(crop_size=30),
                       lambda: _image_results((52, 40)), 1),
    "TenCrop": ("TenCrop", dict(crop_size=30), _image_results, 1),
    "Flip": ("Flip", dict(flip_ratio=0.5, seed=10), _image_results, 6),
    "Flip-pixels": ("Flip", dict(flip_ratio=1.0),
                    lambda: dict(_image_results(), bbox_coords="pixels"), 1),
    "ColorJitter": ("ColorJitter", dict(seed=11),
                    lambda: _image_results(n=2), 3),
    "ColorJitter-ranges": ("ColorJitter", dict(
        brightness=(0.8, 1.2), contrast=0, saturation=(0.5, 1.5), hue=0.3,
        seed=12), lambda: _image_results(n=2), 2),
    "Normalize": ("Normalize", dict(mean=[123.675, 116.28, 103.53],
                                    std=[58.395, 57.12, 57.375]),
                  _image_results, 1),
    "Normalize-bgr": ("Normalize", dict(mean=[127.5] * 3, std=[127.5] * 3,
                                        to_bgr=True), _image_results, 1),
    "FormatShape-NTHWC": ("FormatShape", dict(input_format="NTHWC"),
                          _image_results, 1),
    "FormatShape-NCTHW": ("FormatShape", dict(input_format="NCTHW"),
                          _image_results, 1),
    "FormatShape-NCHW": ("FormatShape", dict(input_format="NCHW"),
                         _image_results, 1),
}


def _assert_results_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if k == "imgs" and isinstance(w, list):
            g, w = np.stack(g), np.stack(w)
        if isinstance(w, dict):
            for kk in w:
                np.testing.assert_array_equal(g[kk], w[kk])
        elif isinstance(w, (np.ndarray, list, tuple)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
        else:
            assert g == w, k


@pytest.mark.parametrize("case", list(OPS))
def test_op_matches_jax(case):
    name, kwargs, make, calls = OPS[case]
    t_op = tp.build_pipeline([dict(type=name, **kwargs)])
    j_op = jp.build_pipeline([dict(type=name, **kwargs)])
    for _ in range(calls):
        _assert_results_equal(t_op(make()), j_op(make()))


def test_merge_clips_matches_jax():
    pipe = [dict(type="FormatShape", input_format="NTHWC"),
            dict(type="MergeClips")]
    t = tp.build_pipeline(pipe)(_image_results())
    j = jp.build_pipeline(pipe)(_image_results())
    _assert_results_equal(t, j)
    assert t["imgs"].shape == (1, 6, 40, 52, 3)
    with pytest.raises(ValueError, match="FormatShape"):
        tp.MergeClips()(_image_results())


@pytest.mark.parametrize("name,lib", [("TorchvisionTrans", "torchvision"),
                                      ("ImgaugTrans", "imgaug"),
                                      ("PytorchVideoTrans", "pytorchvideo")])
def test_outside_library_adapters_import_when_built(name, lib, monkeypatch):
    """Each adapter imports its library when it is built: where the
    library is missing, both packages raise ImportError there."""
    for mod in [m for m in list(sys.modules) if m.split(".")[0] == lib]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, lib, None)
    for cls in (getattr(tp, name), getattr(jp, name)):
        with pytest.raises(ImportError):
            cls(type="Identity")


def test_unported_op_names_queue_item_8():
    with pytest.raises(KeyError, match="item 8"):
        tp.build_pipeline([dict(type="AudioDecode")])


def test_registry_matches_jax():
    from cross_modal_video_engine_tpu.utils.registry import (
        PIPELINES as JAX_PIPELINES)
    jp.build_pipeline([])          # registers the JAX decode ops
    ported = set(PIPELINES)
    assert len(ported) == 45 and ported <= set(JAX_PIPELINES)
    r = Registry("things")
    r.register()(Registry)
    r.register_value("x", 3)
    assert r.get("Registry") is Registry and "x" in r and list(r) == [
        "Registry", "x"]
    with pytest.raises(KeyError, match="already registered"):
        r.register_value("x", 4)
    with pytest.raises(KeyError, match="available"):
        r.get("y")


# -- decode ops ----------------------------------------------------------------

def test_decode_ops_match_jax(tmp_path):
    path = str(tmp_path / "v.mp4")
    jvd.write_test_video(path, _frames((36, 44), seed=21, n=20))
    pipe = [dict(type="DecordInit"),
            dict(type="SampleFrames", clip_len=4, frame_interval=3,
                 num_clips=2, test_mode=True),
            dict(type="DecordDecode"), dict(type="Resize", scale=(-1, 24)),
            dict(type="CenterCrop", crop_size=20),
            dict(type="Normalize", mean=[127.5] * 3, std=[127.5] * 3),
            dict(type="FormatShape", input_format="NTHWC")]
    for init, dec in (("DecordInit", "DecordDecode"),
                      ("OpenCVInit", "OpenCVDecode")):
        cfg = [dict(c, type={"DecordInit": init, "DecordDecode": dec}.get(
            c["type"], c["type"])) for c in pipe]
        t = tp.build_pipeline(cfg)({"filename": path})
        j = jp.build_pipeline(cfg)({"filename": path})
        _assert_results_equal(t, j)
        assert t["imgs"].shape == (2, 4, 20, 20, 3)


def test_raw_frame_decode_matches_jax(tmp_path):
    frames = _frames((18, 22), seed=22, n=5)
    for i, f in enumerate(frames, start=1):
        cv2.imwrite(str(tmp_path / f"img_{i:05d}.png"),
                    cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    res = {"frame_dir": str(tmp_path), "filename_tmpl": "img_{:05d}.png",
           "frame_inds": np.array([1, 3, 5])}
    t = tp.build_pipeline([dict(type="RawFrameDecode")])(dict(res))
    j = jp.build_pipeline([dict(type="RawFrameDecode")])(dict(res))
    _assert_results_equal(t, j)
    np.testing.assert_array_equal(np.stack(t["imgs"]), frames[[0, 2, 4]])
    with pytest.raises(IOError, match="missing frame"):
        tvd.RawFrameDecode()(dict(res, frame_inds=[9]))


class _Reader:
    """A decord-alike reader over frames in memory."""

    def __init__(self, frames):
        self.frames, self.fps, self.released = frames, 25.0, False

    def __len__(self):
        return len(self.frames)

    def get_batch(self, idx):
        return self.frames[np.asarray(idx)]

    def release(self):
        self.released = True


def test_decord_init_takes_a_reader(tmp_path):
    """Through `reader=` (and with_reader) a pipeline reads the frames a
    decord-alike object hands over, exactly as it reads the file."""
    frames = _frames((30, 40), seed=23, n=16)
    path = str(tmp_path / "v.mp4")
    tvd.write_test_video(path, frames)
    decoded = tvd.open_video(path).get_batch(np.arange(16))
    readers = []

    def reader(name):
        assert name == path
        readers.append(_Reader(decoded))
        return readers[-1]

    pipe = [dict(type="DecordInit"),
            dict(type="SampleFrames", clip_len=4, frame_interval=2,
                 num_clips=1, test_mode=True),
            dict(type="DecordDecode"), dict(type="Resize", scale=(-1, 20))]
    seam = tp.with_reader(pipe, reader)
    assert pipe[0] == dict(type="DecordInit") and seam[0]["reader"] is reader
    assert tp.with_reader(pipe, None) == pipe
    got = tp.build_pipeline(seam)({"filename": path})
    want = jp.build_pipeline(pipe)({"filename": path})
    np.testing.assert_array_equal(np.stack(got["imgs"]),
                                  np.stack(want["imgs"]))
    assert got["avg_fps"] == 25.0 and readers[0].released
    assert got["video_reader"] is None


# -- Config --------------------------------------------------------------------

SEQ_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "seq_generate",
                                            "*.py")))


@pytest.mark.parametrize("path", SEQ_CONFIGS,
                         ids=[os.path.basename(p) for p in SEQ_CONFIGS])
def test_config_files_load_to_the_jax_tree(path):
    t, j = tconfig.Config.fromfile(path), jconfig.Config.fromfile(path)
    assert t.to_dict() == j.to_dict()
    assert "_delete_" not in repr(t.to_dict())
    opts = ["model.decoder.max_len=7", "data.videos_per_gpu=2",
            "model.backbone.name='x'", "new.key=[1, 2]", "raw=abc"]
    t.merge_from_options(list(opts))
    j.merge_from_options(list(opts))
    assert t.to_dict() == j.to_dict()
    for key in ("model.decoder.max_len", "data.pipeline", "new.key",
                "data.val.ann_file", "model.missing", "raw.x"):
        assert t.get(key, "absent") == j.get(key, "absent")
        assert (key in t) == (key in j)


def test_config_builds_the_ports_dataclasses(tmp_path):
    cfg = tconfig.Config.fromfile(os.path.join(
        ROOT, "configs", "seq_generate", "timesformer_relseq.py"))
    dec = cfg.to_dataclass(RNNDecoderConfig, "model.decoder")
    assert dec == RNNDecoderConfig(num_classes=36, in_channels=768,
                                   max_len=5, threshold=0.5)
    jdec = jconfig.Config(cfg.to_dict()).to_dataclass(JaxDecoderConfig,
                                                      "model.decoder")
    assert vars(jdec) == vars(dec)
    bb = cfg.to_dataclass(TimeSformerConfig, "model.backbone")
    assert bb.attention_type == "divided_space_time" and bb.num_layers == 12
    json_path = str(tmp_path / "c.json")
    cfg.dump(json_path)
    assert tconfig.Config.fromfile(json_path)["model.decoder.num_classes"] \
        == 36
    with pytest.raises(KeyError):
        cfg["model.nothing"]


def test_config_delete_replaces_the_base(tmp_path):
    (tmp_path / "base.py").write_text(
        "model = dict(backbone=dict(a=1, b=2), head=dict(c=3))\n")
    (tmp_path / "child.py").write_text(
        "_base_ = './base.py'\n"
        "model = dict(backbone=dict(_delete_=True, z=9), head=dict(d=4))\n")
    path = str(tmp_path / "child.py")
    t, j = tconfig.Config.fromfile(path), jconfig.Config.fromfile(path)
    assert t.to_dict() == j.to_dict() == {
        "model": {"backbone": {"z": 9}, "head": {"c": 3, "d": 4}}}


# -- dataset and metrics -------------------------------------------------------

def test_relseq_dataset_matches_jax(tmp_path):
    ann = tmp_path / "ann.txt"
    ann.write_text("a.mp4 1,2->3->0\nb.mp4 4\n\nc.mp4 ->2,3->1->1->0->4\n")
    pipe_t = tp.Compose([lambda r: dict(r, imgs=np.full((1, 2), len(r)))])
    pipe_j = jp.Compose([lambda r: dict(r, imgs=np.full((1, 2), len(r)))])
    t = tds.VideoDatasetRelseq(str(ann), pipe_t, num_classes=5, max_len=4,
                               data_prefix="vids")
    j = jds.VideoDatasetRelseq(str(ann), pipe_j, num_classes=5, max_len=4,
                               data_prefix="vids")
    assert len(t) == len(j) == 3
    for a, b in zip(t.video_infos, j.video_infos):
        assert a["filename"] == b["filename"]
        np.testing.assert_array_equal(a["label"], b["label"])
        np.testing.assert_array_equal(a["mask"], b["mask"])
    for (ti, titems, tn), (ji, jitems, jn) in zip(t.batches(2),
                                                  j.batches(2)):
        np.testing.assert_array_equal(ti, ji)
        assert tn == jn and [x["filename"] for x in titems] == [
            x["filename"] for x in jitems]
    assert [n for _, _, n in t.batches(2, order=[2, 0, 1])] == [2, 1]


def _seq_scores(seed, n_videos=6, max_len=4, classes=5):
    rng = np.random.default_rng(seed)
    scores, labels = [], []
    for v in range(n_videos):
        lab = (rng.random((max_len, classes)) > 0.6).astype(np.float32)
        end = rng.integers(1, max_len + 1)
        lab[end:] = 0
        lab[end:, -1] = 1
        scores.append(rng.random(max_len * classes).astype(np.float32)
                      if v % 2 else rng.random((max_len, classes)))
        labels.append(lab)
    return scores, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seq_average_precision_matches_jax(seed):
    scores, labels = _seq_scores(seed)
    got = tacc.seq_average_precision(scores, labels)
    want = jacc.seq_average_precision(scores, labels)
    assert len(got) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_other_accuracy_metrics_match_jax():
    rng = np.random.default_rng(5)
    scores = rng.random((12, 4))
    labels = rng.integers(0, 4, 12)
    multi = (rng.random((12, 4)) > 0.5).astype(np.float32)
    multi[:, 2] = 0                         # a class with no positive
    for norm in (None, "true", "pred", "all"):
        np.testing.assert_array_equal(
            tacc.confusion_matrix(labels[::-1], labels, norm),
            jacc.confusion_matrix(labels[::-1], labels, norm))
    assert tacc.top_k_accuracy(scores, labels, (1, 2, 3)) == \
        jacc.top_k_accuracy(scores, labels, (1, 2, 3))
    assert tacc.mean_class_accuracy(scores, labels) == \
        jacc.mean_class_accuracy(scores, labels)
    assert tacc.mean_average_precision(list(scores), list(multi)) == \
        jacc.mean_average_precision(list(scores), list(multi))
    assert tacc.mmit_mean_average_precision(list(scores), list(multi)) == \
        jacc.mmit_mean_average_precision(list(scores), list(multi))
    for a, b in zip(tacc.binary_precision_recall_curve(scores[:, 0],
                                                       multi[:, 0]),
                    jacc.binary_precision_recall_curve(scores[:, 0],
                                                       multi[:, 0])):
        np.testing.assert_array_equal(a, b)

"""The 3D-CNN arms of the port's training, test and serving entry points,
on the CPU on tiny OpenCV-written fixtures (10-frame 32² videos whose
brightness encodes their class; backbones of width 4-8).

* `recognition_train.main` on a ResNet3D config (the JAX package's
  tests/test_recognition_cli.py fixture, at stage_blocks (1, 1, 1, 1),
  width 4): two epochs with validation, the loss falls on a repeated
  split, `model_best` holds params and batch_stats that the JAX
  BackboneClassifier reads (scores equal within 1e-5 in eval mode), and
  a run resumed from `epoch_0` ends with the parameters and running
  statistics of the uninterrupted run; then SlowFast with the s2d stem
  (the shipped recipe's flag), bf16, one epoch.
* `caption_train.main` on a tiny i3d_relseq config: `model_best` (with
  its `type`, decoder and batch_stats) read by the port's
  `api.init_recognizer` and by the JAX one, `forward_test` equal within
  1e-5, and served by the `/caption` handler, answers equal to
  `caption_clips`; a resumed epoch equal to the uninterrupted one.
* `recognition_test.main` against the JAX CLI on a TimeSformer
  classifier: the same report and `--out` scores within 1e-5; a 3D-CNN
  classifier checkpoint refused by both, as the JAX loader refuses it.
* One refusal for each part of slice 5 still to port, naming it.
* `_TemporalMean`, the caption backbone's pooling of a per-frame
  backbone, against the JAX module on a per-frame Dense (its branch of
  `build_caption_backbone` on a real TSM:
  tests/test_torch_recognizer2d_cli.py).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu import api as japi
from cross_modal_video_engine_tpu.cli import recognition_test as jrtest
from cross_modal_video_engine_tpu.io.video_decode import write_test_video
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import resnet3d as jr
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.cli import caption_train as tct
from cross_modal_video_engine_tpu_torch.cli import recognition_test as trtest
from cross_modal_video_engine_tpu_torch.cli import recognition_train as trt
from cross_modal_video_engine_tpu_torch.cli import serve
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.convert import (
    conv_recognizer_state_dict_from_jax)
from cross_modal_video_engine_tpu_torch.data.pipelines import build_pipeline
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt_train)
from torch_parity import random_variables, to_np


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


PIPELINE = """[
        dict(type='DecordInit'),
        dict(type='SampleFrames', clip_len=8, frame_interval=1,
             num_clips=1, test_mode=True),
        dict(type='DecordDecode'),
        dict(type='Resize', scale=(32, 32), keep_ratio=False),
        dict(type='Normalize', mean=[127.5]*3, std=[127.5]*3),
        dict(type='FormatShape', input_format='NTHWC'),
    ]"""
RESNET3D = ("dict(type='ResNet3D', stage_blocks=[1, 1, 1, 1], "
            "base_channels=4)")
SLOWFAST = ("dict(type='SlowFast', depth_blocks=[1, 1, 1, 1], alpha=4, "
            "beta_inv=2, base_channels=4, fast_s2d_stem=True)")
I3D = ("dict(type='ResNet3D', stage_blocks=[1, 1, 1, 1], base_channels=4, "
       "conv1_kernel_t=5, conv1_stride_t=2, pool1_stride_t=2, "
       "stage_temporal_kernels=[3, 3, 3, 3])")


@pytest.fixture(scope="module")
def clips_dir(tmp_path_factory):
    """Eight 10-frame 32² videos, class = brightness, and the splits."""
    root = tmp_path_factory.mktemp("cnn_videos")
    rng = np.random.default_rng(81)
    lines, seq = [], []
    for i in range(8):
        cls = i % 2
        frames = np.clip((40 if cls == 0 else 215)
                         + rng.integers(-20, 20, (10, 32, 32, 3)),
                         0, 255).astype(np.uint8)
        write_test_video(str(root / f"v{i}.mp4"), frames)
        lines.append(f"v{i}.mp4 {cls}")
        seq.append(f"v{i}.mp4 " + ("0,1->2" if cls == 0 else "3->3,1->0"))
    (root / "cls.txt").write_text("\n".join(lines))
    (root / "seq.txt").write_text("\n".join(seq))
    return root


def write_config(root, name, backbone, feat_dim=None, extra=""):
    """A config over the fixture: a classifier, or with feat_dim a caption
    model whose decoder takes the backbone's feat_dim."""
    caption = feat_dim is not None
    ann = root / ("seq.txt" if caption else "cls.txt")
    head = (f"decoder=dict(num_classes=4, in_channels={feat_dim}, "
            f"max_len=3)" if caption else "num_classes=2")
    cfg = root / f"{name}.py"
    cfg.write_text(f"""
model = dict(backbone={backbone}, {head})
data = dict(
    train=dict(ann_file=r'{ann}', data_prefix=r'{root}'),
    val=dict(ann_file=r'{ann}', data_prefix=r'{root}'),
    pipeline={PIPELINE},
    videos_per_gpu=4)
optimizer = dict(optimizer='sgd', learning_rate=0.05, momentum=0.9,
                 weight_decay=1e-4, grad_clip=10.0)
total_epochs = 2
eval_interval = 1
{extra}""")
    return str(cfg)


def _bn_state(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


# -- recognition_train ----------------------------------------------------------------

def test_recognition_train_resnet3d_end_to_end(clips_dir, tmp_path, capsys):
    cfg = write_config(clips_dir, "rec_resnet3d", RESNET3D)
    work = str(tmp_path / "work")
    state, history = trt.train_from_config(Config.fromfile(cfg), work,
                                           device="cpu")
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "top1_acc" in history[1]
    assert isinstance(state.model, trec.BackboneClassifier)
    assert history[1]["loss"] < history[0]["loss"]

    # model_best in the JAX format, read by the JAX classifier
    best = os.path.join(work, "model_best")
    variables, cfg_d, _ = jax_load_checkpoint(best)
    assert set(variables) == {"params", "batch_stats"}
    assert cfg_d["backbone"]["type"] == "ResNet3D"
    jm = jrec.BackboneClassifier(jr.ResNet3D(jr.ResNet3DConfig(
        stage_blocks=(1, 1, 1, 1), base_channels=4)), 2)
    clip = np.random.default_rng(3).standard_normal(
        (2, 8, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(clip)))
    model = trt.build_recognition_model(Config.fromfile(cfg), "cpu")
    model.load_state_dict(conv_recognizer_state_dict_from_jax(
        jax.tree.map(np.asarray, dict(variables)), model))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(clip))
    assert np.abs(to_np(got) - want).max() <= 1e-5
    # a 3D-CNN classifier is not a checkpoint init_recognizer serves
    with pytest.raises(ValueError, match="caption model"):
        api.init_recognizer(best, device="cpu")

    # epoch 1 resumed from epoch_0 equals the uninterrupted epoch 1
    final = _bn_state(state.model)
    resumed, history2 = trt.train_from_config(
        Config.fromfile(cfg), str(tmp_path / "again"),
        resume=os.path.join(work, "epoch_0"), device="cpu")
    assert [h["epoch"] for h in history2] == [1]
    assert history2[0]["loss"] == history[1]["loss"]
    for k, v in _bn_state(resumed.model).items():
        assert torch.equal(v, final[k]), k
    capsys.readouterr()


def test_recognition_train_slowfast_bf16(clips_dir, tmp_path, capsys):
    cfg = write_config(clips_dir, "rec_slowfast", SLOWFAST)
    history = trt.main([cfg, "--work_dir", str(tmp_path / "w"),
                        "--total_epochs", "1", "--device", "cpu",
                        "--cfg-options", "optimizer.bf16=True"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    variables, cfg_d, _ = jax_load_checkpoint(
        str(tmp_path / "w" / "model_best"))
    assert cfg_d["backbone"]["fast_s2d_stem"] is True
    assert all(np.asarray(x).dtype == np.float32
               for x in jax.tree.leaves(variables))
    capsys.readouterr()


# -- caption_train and serving --------------------------------------------------------

def test_caption_train_i3d_relseq(clips_dir, tmp_path, capsys):
    cfg = write_config(clips_dir, "cap_i3d", I3D, feat_dim=128)
    work = str(tmp_path / "work")
    history = tct.main([cfg, "--work_dir", work, "--device", "cpu"])
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    best = os.path.join(work, "model_best")

    model, cfg_d = api.init_recognizer(best, device="cpu")
    assert isinstance(model, trec.RecognizerRelseq)
    assert cfg_d["backbone"]["type"] == "ResNet3D"
    assert not model.training
    jm, jvars, _ = japi.init_recognizer(best)
    assert "batch_stats" in jvars
    pipe = build_pipeline(Config.fromfile(cfg)["data.pipeline"])
    clips = np.concatenate([pipe({"filename": str(clips_dir / f"v{i}.mp4"),
                                  "start_index": 0})["imgs"]
                            for i in range(2)]).astype(np.float32)
    with torch.no_grad():
        got = model.forward_test(torch.from_numpy(clips), num_segs=1)
    want = np.asarray(jm.apply(jvars, jnp.asarray(clips),
                               method="forward_test"))
    assert np.abs(to_np(got) - want).max() <= 1e-5

    # served from /caption: answers equal to caption_clips
    videos = {f"v{i}.mp4": str(clips_dir / f"v{i}.mp4") for i in range(2)}
    from cross_modal_video_engine_tpu_torch.cli import caption_inference
    old = caption_inference.DEFAULT_PIPELINE
    caption_inference.DEFAULT_PIPELINE = Config.fromfile(cfg)[
        "data.pipeline"]
    try:
        handler = serve.build_caption_handler(argparse.Namespace(
            caption_checkpoint=best, device="cpu"))
        try:
            for name, path in videos.items():
                answer = handler({"video": path})
                clip = pipe({"filename": path, "start_index": 0})["imgs"]
                steps, _ = api.caption_clips(
                    handler.model, torch.from_numpy(
                        np.asarray(clip, np.float32)))
                assert answer["steps"] == steps[0], name
        finally:
            handler.batcher.close()
    finally:
        caption_inference.DEFAULT_PIPELINE = old

    # a resumed epoch equals the uninterrupted one
    again = tct.main([cfg, "--work_dir", work, "--device", "cpu",
                      "--resume", "--total_epochs", "3"])
    assert [h["epoch"] for h in again] == [2]
    capsys.readouterr()


def test_caption_resume_equals_uninterrupted(clips_dir, tmp_path, capsys):
    cfg = write_config(clips_dir, "cap_x3d", (
        "dict(type='X3D', stage_blocks=[1, 1, 1, 1], "
        "stage_channels=[4, 8, 8, 8], feat_dim=16)"), feat_dim=16)
    full = tct.train_from_config(Config.fromfile(cfg), str(tmp_path / "a"),
                                 device="cpu")
    resumed = tct.train_from_config(
        Config.fromfile(cfg), str(tmp_path / "b"),
        resume=str(tmp_path / "a" / "epoch_0"), device="cpu")
    assert [h["epoch"] for h in resumed] == [1]
    assert resumed[0]["loss"] == full[1]["loss"]
    assert resumed[0]["seq_mAP"] == full[1]["seq_mAP"]
    capsys.readouterr()


# -- recognition_test ---------------------------------------------------------------

def test_recognition_test_matches_jax(clips_dir, tmp_path, capsys):
    ts = dict(num_frames=8, img_size=32, patch_size=8, embed_dims=32,
              num_heads=2, num_layers=2, drop_path_max=0.0)
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**ts), num_classes=2)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 8, 32, 32, 3), jnp.float32)), 17)
    ckpt = str(tmp_path / "ts")
    jax_save_checkpoint(ckpt, variables, {"backbone": ts, "num_classes": 2})
    cfg = write_config(clips_dir, "test_ts", "dict(type='TimeSformer')")
    text = open(cfg).read().replace("num_clips=1", "num_clips=2")
    open(cfg, "w").write(text)
    want = jrtest.main([cfg, "--checkpoint", ckpt, "--out",
                        str(tmp_path / "jax.npz")])
    got = trtest.main([cfg, "--checkpoint", ckpt, "--out",
                       str(tmp_path / "port.npz"), "--device", "cpu"])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert np.abs(a["scores"] - b["scores"]).max() <= 1e-5

    # a 3D-CNN classifier checkpoint: refused by both loaders
    cnn = str(tmp_path / "cnn")
    jax_save_checkpoint(cnn, {"params": {}},
                        {"backbone": {"type": "ResNet3D"}, "num_classes": 2})
    with pytest.raises(ValueError, match="caption model"):
        trtest.main([cfg, "--checkpoint", cnn, "--device", "cpu"])
    with pytest.raises(AssertionError):
        jrtest.main([cfg, "--checkpoint", cnn])
    capsys.readouterr()


# -- refusals, one per part ------------------------------------------------------------

@pytest.mark.parametrize("part,refused", [
    ("8g", lambda root: build_pipeline([dict(type="AudioDecode")])),
])
def test_refusals_name_their_part(part, refused, clips_dir):
    with pytest.raises((NotImplementedError, KeyError),
                       match=f"item {part}"):
        refused(clips_dir)
    assert part in trt_train.PARTS


def test_temporal_mean_matches_jax():
    """`_TemporalMean` (the caption backbone's pooling of a per-frame
    backbone) against the JAX module on one per-frame Dense: the same
    (B, C) features and the inner module's parameters under `inner`."""
    from flax import linen
    from cross_modal_video_engine_tpu.cli import recognition_train as jrt

    class JaxFrames(linen.Module):
        @linen.compact
        def __call__(self, videos, train=False):
            return linen.Dense(3)(videos.reshape(videos.shape[:2] + (-1,)))

    class Frames(torch.nn.Module):
        feat_dim = 3

        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(2 * 2 * 3, 3)

        def forward(self, videos):
            return self.fc(videos.reshape(*videos.shape[:2], -1))

    rng = np.random.default_rng(7)
    v = rng.standard_normal((2, 5, 2, 2, 3)).astype(np.float32)
    w = rng.standard_normal((12, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    pooled = trt._TemporalMean(Frames())
    pooled.load_state_dict({"inner.fc.weight": torch.from_numpy(w.T),
                            "inner.fc.bias": torch.from_numpy(b)})
    assert pooled.feat_dim == 3
    want = jrt._TemporalMean(JaxFrames()).apply(
        {"params": {"inner": {"Dense_0": {"kernel": w, "bias": b}}}},
        jnp.asarray(v))
    with torch.no_grad():
        got = pooled(torch.from_numpy(v))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)

"""The 2D, TSM and pyramid arms of the port's training, test and serving
entry points, on the CPU on tests/test_torch_recognition_cli.py's tiny
OpenCV-written fixture (10-frame 32² videos whose brightness encodes
their class; backbones of width 4-8, 8 frames).

* `recognition_train` on a TSM config: two epochs with validation, the
  loss falls, `model_best` (params and batch_stats) read by the JAX
  Recognizer2D with equal eval scores (within 1e-5), a run resumed from
  `epoch_0` equal to the uninterrupted one; one epoch each of TRN (a
  `model.head`), TPN (a `model.neck` over SlowOnly) and C3D (no
  BatchNorm: no batch_stats), each `model_best` read by its JAX model.
* `recognition_test` on the TSM and TPN checkpoints with two clips a
  video: the scores the JAX model's `forward_test` gives on the same
  clips (the JAX CLI's loader refuses a classifier that is not a
  TimeSformer; the port rebuilds it from the config).
* `caption_train` on a tiny seq_generate/tsm_relseq.py: `model_best`
  read by the port's and the JAX `init_recognizer` alike (equal
  `forward_test`), served by `/caption` with the answers of
  `caption_clips`.
* `build_caption_backbone`'s `_TemporalMean` branch on a real TSM
  against the JAX one.
* Every shipped config of the slice builds at its own widths: the eight
  recognition recipes and tsm_relseq.py, each with the JAX model's
  parameter count (jax.eval_shape of its init on the recipe's clip).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu import api as japi
from cross_modal_video_engine_tpu.cli import recognition_train as jcli
from cross_modal_video_engine_tpu.config import Config as JConfig
from cross_modal_video_engine_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.cli import caption_train as tct
from cross_modal_video_engine_tpu_torch.cli import recognition_test as trtest
from cross_modal_video_engine_tpu_torch.cli import recognition_train as trt
from cross_modal_video_engine_tpu_torch.cli import serve
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.data.pipelines import build_pipeline
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from test_torch_recognition_cli import clips_dir, write_config  # noqa: F401
from test_torch_resnet3d import random_conv_state_dict
from torch_parity import to_np

TSM = ("dict(type='TSM', stage_blocks=[1, 1, 1, 1], base_channels=4)")
TRN_HEAD = ("head=dict(type='TRNHead', num_segments=8, hidden_dim=8, "
            "bottleneck_dim=8, dropout_ratio=0.8, "
            "relation_type='TRNMultiScale')")
SLOWONLY = "dict(type='ResNet3D', stage_blocks=[1, 1, 1, 1], base_channels=4)"
TPN_NECK = ("neck=dict(type='TPN', in_channels=[64, 128], out_channels=16, "
            "mid_channels=8, lf_out_channels=16, fusion_channels=16, "
            "groups=4, downsample_scales=[8, 8])")
C3D = "dict(type='C3D', fc_dim=16)"
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def with_model(root, name, backbone, model_extra="", **kw):
    """write_config, with `model_extra` (a neck or head) in the model."""
    path = write_config(root, name, backbone, **kw)
    text = open(path).read()
    if model_extra:
        text = text.replace("num_classes=2)", f"num_classes=2, {model_extra})")
    open(path, "w").write(text)
    return path


def fixed_clips(seed=3, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 8, 32, 32, 3)).astype(np.float32)


def jax_model(path):
    """The JAX package's recognizer of the config (its CLI's
    build_recognition_model)."""
    return jcli.build_recognition_model(JConfig.fromfile(path))


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def test_recognition_train_tsm_end_to_end(clips_dir, tmp_path, capsys):
    cfg = with_model(clips_dir, "rec_tsm", TSM)
    work = str(tmp_path / "work")
    state, history = trt.train_from_config(Config.fromfile(cfg), work,
                                           device="cpu")
    assert [h["epoch"] for h in history] == [0, 1]
    assert isinstance(state.model, trec.Recognizer2D)
    assert history[1]["loss"] < history[0]["loss"]
    variables, cfg_d, _ = jax_load_checkpoint(os.path.join(work,
                                                           "model_best"))
    assert set(variables) == {"params", "batch_stats"}
    assert cfg_d["backbone"]["type"] == "TSM"
    clip = fixed_clips()
    want = np.asarray(jax_model(cfg).apply(variables, jnp.asarray(clip)))
    with torch.no_grad():
        got = trtest.load_recognizer(Config.fromfile(cfg), os.path.join(
            work, "model_best"), "cpu")(torch.from_numpy(clip))
    assert np.abs(to_np(got) - want).max() <= SCORE_TOL

    final = _state(state.model)
    resumed, history2 = trt.train_from_config(
        Config.fromfile(cfg), str(tmp_path / "again"),
        resume=os.path.join(work, "epoch_0"), device="cpu")
    assert [h["epoch"] for h in history2] == [1]
    assert history2[0]["loss"] == history[1]["loss"]
    for k, v in _state(resumed.model).items():
        assert torch.equal(v, final[k]), k

    # recognition_test: two clips a video, the JAX model's forward_test
    two = open(cfg).read().replace("num_clips=1", "num_clips=2")
    cfg2 = str(clips_dir / "test_tsm.py")
    open(cfg2, "w").write(two)
    _check_recognition_test(cfg2, os.path.join(work, "model_best"),
                            variables, tmp_path)
    capsys.readouterr()


def _check_recognition_test(cfg, ckpt, variables, tmp_path):
    out = str(tmp_path / "scores.npz")
    report = trtest.main([cfg, "--checkpoint", ckpt, "--out", out,
                          "--device", "cpu"])
    assert set(report) == {"top1_acc", "top2_acc", "mean_class_accuracy"}
    c = Config.fromfile(cfg)
    pipe = build_pipeline(c["data.pipeline"])
    root = c["data.val.data_prefix"]
    names = [line.split()[0] for line in open(c["data.val.ann_file"])
             if line.strip()]
    clips = np.concatenate([pipe({"filename": os.path.join(root, n),
                                  "start_index": 0})["imgs"]
                            for n in names]).astype(np.float32)
    jm = jax_model(cfg)
    want = np.asarray(jm.apply(variables, jnp.asarray(clips)))
    want = np.asarray(jax.nn.softmax(want, -1)).reshape(
        len(names), 2, -1).mean(1)
    got = np.load(out)["scores"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= SCORE_TOL


@pytest.mark.parametrize("name,backbone,extra", [
    ("trn", TSM, TRN_HEAD), ("tpn", SLOWONLY, TPN_NECK), ("c3d", C3D, "")])
def test_recognition_train_one_epoch(name, backbone, extra, clips_dir,
                                     tmp_path, capsys):
    cfg = with_model(clips_dir, f"rec_{name}", backbone, extra)
    work = str(tmp_path / name)
    history = trt.main([cfg, "--work_dir", work, "--total_epochs", "1",
                        "--device", "cpu"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    ckpt = os.path.join(work, "model_best")
    variables, _, _ = jax_load_checkpoint(ckpt)
    assert ("batch_stats" in variables) == (name != "c3d")
    model = trtest.load_recognizer(Config.fromfile(cfg), ckpt, "cpu")
    assert isinstance(model, {"trn": trec.Recognizer2D,
                              "tpn": trec.TPNRecognizer,
                              "c3d": trec.BackboneClassifier}[name])
    clip = fixed_clips(4)
    want = np.asarray(jax_model(cfg).apply(variables, jnp.asarray(clip)))
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    assert np.abs(to_np(got) - want).max() <= SCORE_TOL
    if name == "tpn":
        two = open(cfg).read().replace("num_clips=1", "num_clips=2")
        cfg2 = str(clips_dir / "test_tpn.py")
        open(cfg2, "w").write(two)
        _check_recognition_test(cfg2, ckpt, variables, tmp_path)
    capsys.readouterr()


def test_caption_train_tsm_relseq_served(clips_dir, tmp_path, capsys):
    cfg = write_config(clips_dir, "cap_tsm", TSM, feat_dim=128)
    work = str(tmp_path / "work")
    history = tct.main([cfg, "--work_dir", work, "--device", "cpu"])
    assert [h["epoch"] for h in history] == [0, 1]
    best = os.path.join(work, "model_best")
    model, cfg_d = api.init_recognizer(best, device="cpu")
    assert isinstance(model, trec.RecognizerRelseq)
    assert isinstance(model.backbone, trt._TemporalMean)
    jm, jvars, _ = japi.init_recognizer(best)
    clips = fixed_clips(5)
    with torch.no_grad():
        got = model.forward_test(torch.from_numpy(clips), num_segs=1)
    want = np.asarray(jm.apply(jvars, jnp.asarray(clips),
                               method="forward_test"))
    assert np.abs(to_np(got) - want).max() <= SCORE_TOL

    from cross_modal_video_engine_tpu_torch.cli import caption_inference
    old = caption_inference.DEFAULT_PIPELINE
    caption_inference.DEFAULT_PIPELINE = Config.fromfile(cfg)[
        "data.pipeline"]
    pipe = build_pipeline(Config.fromfile(cfg)["data.pipeline"])
    try:
        handler = serve.build_caption_handler(argparse.Namespace(
            caption_checkpoint=best, device="cpu"))
        try:
            for i in range(2):
                path = str(clips_dir / f"v{i}.mp4")
                answer = handler({"video": path})
                clip = pipe({"filename": path, "start_index": 0})["imgs"]
                steps, _ = api.caption_clips(handler.model, torch.from_numpy(
                    np.asarray(clip, np.float32)))
                assert answer["steps"] == steps[0]
        finally:
            handler.batcher.close()
    finally:
        caption_inference.DEFAULT_PIPELINE = old
    capsys.readouterr()


def test_temporal_mean_branch_on_a_real_tsm():
    kw = dict(stage_blocks=(1, 1, 1, 1), base_channels=4)
    pooled = trt.build_caption_backbone("TSM", kw, "cpu")
    assert isinstance(pooled, trt._TemporalMean)
    sd = random_conv_state_dict(pooled, 3)
    pooled.load_state_dict(sd)
    jm = jcli.build_caption_backbone("TSM", dict(kw))
    variables = tconv.conv_recognizer_variables_to_jax(sd, pooled)
    assert set(variables["params"]) == {"inner"}
    clip = fixed_clips(6)
    want = np.asarray(jm.apply(variables, jnp.asarray(clip)))
    with torch.no_grad():
        got = pooled(torch.from_numpy(clip)).numpy()
    assert got.shape == want.shape == (2, pooled.feat_dim)
    assert np.abs(got - want).max() <= SCORE_TOL * np.abs(want).max()


SHIPPED = ["recognition/tsm_r50_1x1x8_k400",
           "recognition/tsn_r50_1x1x3_k400",
           "recognition/tin_r50_1x1x8_sthv2",
           "recognition/trn_r50_1x1x8_sthv1", "recognition/tanet_r50_k400",
           "recognition/tpn_slowonly_r50_8x8_k400",
           "recognition/c3d_sports1m_16x1_ucf101",
           "recognition/r2plus1d_r34_8x8_k400", "seq_generate/tsm_relseq"]


def _clip_shape(cfg):
    """(T, size) of a config's clips: the sampler's frames (times the
    segments MergeClips folds in) at the crop size."""
    ops = {op["type"]: op for op in cfg["data.pipeline"]}
    sample = ops.get("SampleFrames") or ops["DenseSampleFrames"]
    t = sample["clip_len"] * (sample["num_clips"] if "MergeClips" in ops
                              else 1)
    return t, ops["CenterCrop"]["crop_size"]


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_configs_build_at_their_widths(name):
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        name + ".py")
    cfg = Config.fromfile(path)
    if name.startswith("seq_generate"):
        model, _, _ = tct.build_caption_model(cfg, "cpu")
        again, _ = api.init_recognizer(
            {"backbone": dict(cfg["model.backbone"]),
             "decoder": dict(cfg["model.decoder"])},
            model.state_dict(), device="cpu")
        assert isinstance(again, trec.RecognizerRelseq)
        from cross_modal_video_engine_tpu.models.decoder_head import (
            RNNDecoderConfig)
        from cross_modal_video_engine_tpu.models.recognizer import (
            RecognizerRelseq)
        bkw = {k: v for k, v in cfg["model.backbone"].items() if k != "type"}
        jm = RecognizerRelseq(jcli.build_caption_backbone(
            cfg["model.backbone"]["type"], bkw),
            RNNDecoderConfig(**cfg["model.decoder"]))
        kw = {"mode": "inference"}
    else:
        model = trt.build_recognition_model(cfg, "cpu")
        jm = jcli.build_recognition_model(JConfig.fromfile(path))
        kw = {}
    t, size = _clip_shape(cfg)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, **kw),
                            jax.random.key(0),
                            jax.ShapeDtypeStruct((1, t, size, size, 3),
                                                 jnp.float32))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == want
    n_stats = sum(int(np.prod(s.shape))
                  for s in jax.tree.leaves(shapes.get("batch_stats", {})))
    assert sum(b.numel() for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var"))) == n_stats

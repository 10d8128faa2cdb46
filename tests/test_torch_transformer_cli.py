"""The transformer and CLIP arms of the port's training, test and serving
entry points, on the CPU on the tiny OpenCV-written fixture of
tests/test_torch_recognition_cli.py (8-frame 32² clips whose brightness
encodes their class; widths 8-16).

* `recognition_train.main` on Swin3D: two epochs, the tables sized by the
  first batch's windows, `model_best` read by the JAX BackboneClassifier
  (scores within SCORE_TOL, 1e-5), a run resumed from `epoch_0` ending
  with the uninterrupted run's parameters, and `recognition_test` with
  two clips a video equal to the JAX model's forward_test.
* One epoch each of MViT, VideoMAEViT, VideoCLIP (`VideoCLIPPooled`
  under a BackboneClassifier) and CLIP (a Recognizer3DCLIP): `model_best`
  read by the JAX package's model of the config, scores within SCORE_TOL;
  `recognition_test` rebuilds the classifiers, and refuses the CLIP
  checkpoint (the JAX class has no forward_test; the JAX CLI fails on it
  too).
* `caption_train.main` on a small videomae_relseq config: `model_best`
  read by the port's and the JAX package's `init_recognizer`,
  forward_test within SCORE_TOL, served by `/caption` with the answers of
  `caption_clips`.
* `api.init_recognizer` on JAX-written caption checkpoints: a Swin3D
  (its tables at the checkpoint's size) within SCORE_TOL of JAX's, and a
  VideoMAE configured in bfloat16 (the JAX loader's bf16 cast) within
  BF16_TOL (2e-2) and at cosine >= 0.999.
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
from cross_modal_video_engine_tpu.cli import recognition_train as jcli
from cross_modal_video_engine_tpu.models import decoder_head as jdh
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.cli import caption_train as tct
from cross_modal_video_engine_tpu_torch.cli import recognition_test as trtest
from cross_modal_video_engine_tpu_torch.cli import recognition_train as trt
from cross_modal_video_engine_tpu_torch.cli import serve
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.data.pipelines import build_pipeline
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import swin3d as ts
from test_torch_recognition_cli import clips_dir, write_config  # noqa: F401
from test_torch_recognizer2d_cli import (_check_recognition_test,
                                         fixed_clips, jax_model)
from torch_parity import min_cosine, random_variables, to_np

SCORE_TOL, BF16_TOL = 1e-5, 2e-2
SWIN = ("dict(type='Swin3D', embed_dim=8, depths=[2, 2], num_heads=[1, 2], "
        "window_size=[2, 3, 3], patch_size=[2, 4, 4])")
MVIT = "dict(type='MViT', embed_dim=8, depths=[1, 1], num_heads=[1, 2])"
VIDEOMAE = ("dict(type='VideoMAEViT', num_frames=8, img_size=32, "
            "patch_size=16, tubelet_size=2, embed_dims=16, num_heads=2, "
            "num_layers=2)")
VIDEOCLIP = ("dict(type='VideoCLIP', fps=4, s3d_channels=4, width=16, "
             "layers=1, heads=2)")
CLIP = ("dict(type='CLIP', embed_dim=8, image_resolution=32, "
        "vision_width=16, vision_layers=2, vision_heads=2, patch_size=16)")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_recognition_train_swin_end_to_end(clips_dir, tmp_path, capsys):
    cfg = write_config(clips_dir, "rec_swin", SWIN)
    work = str(tmp_path / "work")
    state, history = trt.train_from_config(Config.fromfile(cfg), work,
                                           device="cpu")
    assert [h["epoch"] for h in history] == [0, 1]
    model = state.model
    assert isinstance(model.backbone, ts.Swin3D)
    # 8x32x32 clips: a 4x8x8 grid, windows (2, 3, 3) in both stages
    assert model.backbone.layers[1].blocks[0].attn \
        .relative_position_bias_table.shape == (3 * 5 * 5, 2)
    variables, cfg_d, _ = jax_load_checkpoint(os.path.join(work,
                                                           "model_best"))
    assert set(variables) == {"params"} and cfg_d["backbone"]["type"] == \
        "Swin3D"
    clip = fixed_clips()
    want = np.asarray(jax.jit(jax_model(cfg).apply)(variables,
                                                    jnp.asarray(clip)))
    with torch.no_grad():
        got = trtest.load_recognizer(Config.fromfile(cfg), os.path.join(
            work, "model_best"), "cpu")(torch.from_numpy(clip))
    assert np.abs(to_np(got) - want).max() <= SCORE_TOL

    final = _state(model)
    resumed, history2 = trt.train_from_config(
        Config.fromfile(cfg), str(tmp_path / "again"),
        resume=os.path.join(work, "epoch_0"), device="cpu")
    assert [h["epoch"] for h in history2] == [1]
    assert history2[0]["loss"] == history[1]["loss"]
    for k, v in _state(resumed.model).items():
        assert torch.equal(v, final[k]), k

    two = open(cfg).read().replace("num_clips=1", "num_clips=2")
    cfg2 = str(clips_dir / "test_swin.py")
    open(cfg2, "w").write(two)
    _check_recognition_test(cfg2, os.path.join(work, "model_best"),
                            variables, tmp_path)
    capsys.readouterr()


@pytest.mark.parametrize("name,backbone,cls", [
    ("mvit", MVIT, trec.BackboneClassifier),
    ("videomae", VIDEOMAE, trec.BackboneClassifier),
    ("videoclip", VIDEOCLIP, trec.BackboneClassifier),
    ("clip", CLIP, trec.Recognizer3DCLIP)],
    ids=["mvit", "videomae", "videoclip", "clip"])
def test_recognition_train_one_epoch(name, backbone, cls, clips_dir,
                                     tmp_path, capsys):
    cfg = write_config(clips_dir, f"rec_{name}", backbone)
    work = str(tmp_path / name)
    history = trt.main([cfg, "--work_dir", work, "--total_epochs", "1",
                        "--device", "cpu"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    ckpt = os.path.join(work, "model_best")
    variables, _, _ = jax_load_checkpoint(ckpt)
    assert set(variables) == {"params"}
    clip = fixed_clips(4)
    want = np.asarray(jax.jit(jax_model(cfg).apply)(variables,
                                                    jnp.asarray(clip)))
    if name == "clip":
        with pytest.raises(ValueError, match="no forward_test"):
            trtest.load_recognizer(Config.fromfile(cfg), ckpt, "cpu")
        with pytest.raises(Exception):
            jrtest.main([cfg, "--checkpoint", ckpt])
        model = trt.build_recognition_model(Config.fromfile(cfg), "cpu")
        model.load_state_dict(tconv.conv_recognizer_state_dict_from_jax(
            variables, model))
    else:
        model = trtest.load_recognizer(Config.fromfile(cfg), ckpt, "cpu")
    assert isinstance(model, cls)
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    assert np.abs(to_np(got) - want).max() <= SCORE_TOL
    capsys.readouterr()


def test_caption_train_videomae_relseq_served(clips_dir, tmp_path, capsys):
    cfg = write_config(clips_dir, "cap_videomae", VIDEOMAE, feat_dim=16)
    work = str(tmp_path / "work")
    history = tct.main([cfg, "--work_dir", work, "--device", "cpu"])
    assert [h["epoch"] for h in history] == [0, 1]
    best = os.path.join(work, "model_best")
    model, cfg_d = api.init_recognizer(best, device="cpu")
    assert isinstance(model, trec.RecognizerRelseq)
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


@pytest.mark.parametrize("name", ["swin", "videomae_bf16"])
def test_init_recognizer_reads_jax_caption_checkpoints(name, tmp_path):
    text = {"swin": SWIN, "videomae_bf16": VIDEOMAE[:-1] +
            ", dtype='bfloat16')"}[name]
    backbone = eval(text)                      # the config's dict literal
    btype = backbone.pop("type")
    dec = dict(num_classes=4, in_channels=16, max_len=3)
    jm = jrec.RecognizerRelseq(
        jcli.build_caption_backbone(btype, {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in backbone.items()}), jdh.RNNDecoderConfig(**dec))
    clips = fixed_clips(6)
    variables = random_variables(jax.jit(jm.init)(jax.random.key(0),
                                                  jnp.asarray(clips)), 21)
    ckpt = str(tmp_path / name)
    jax_save_checkpoint(ckpt, variables, {"backbone": dict(backbone,
                                                           type=btype),
                                          "decoder": dec})
    model, _ = api.init_recognizer(ckpt, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    jm2, jvars, _ = japi.init_recognizer(ckpt)
    want = np.asarray(jax.jit(lambda v, x: jm2.apply(
        v, x, method="forward_test"))(jvars, jnp.asarray(clips)))
    with torch.no_grad():
        got = to_np(model.forward_test(torch.from_numpy(clips)))
    if name == "swin":
        assert np.abs(got - want).max() <= SCORE_TOL
    else:
        assert np.abs(got - want).max() <= BF16_TOL
        assert min_cosine(got.reshape(2, -1), want.reshape(2, -1)) >= 0.999

"""The AVA detection CLIs of the PyTorch port (detection_train,
detection_test, ava_proposals) against the JAX package's, end to end on
the CPU over a small seeded corpus (4 videos of 12 frames at 32², one
keyframe each, SlowOnly stage_blocks (1, 1, 1, 1) base 8, 4 classes,
max_boxes 2).

The JAX AVAFastRCNN's `init` is patched to the port's training init (the
full and the bare detector alike); the train pipeline's SampleAVAFrames
jitters with a seed, so both CLIs see the same clips.  The FBO's fixed
dropouts keep every element in both packages (`jax.random.bernoulli`
patched to ones, the port's Dropout to its keep-all mask): the CLIs run
"at dropout 0".  Tolerances: each history value within 1e-4 relative,
each weight after training within 1e-4 of its tensor's largest (1e-2 for
the LFB and ACRN recipes, see RECIPE_REL; the
BatchNorm biases and the non-local key bias, whose updates at the init
are cancellation noise in either package, within 1e-4 of the model's
largest weight); each
package reads the other's `epoch_N` and `model_best`; the results csv
of one checkpoint is the same bytes from either package.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import ava_proposals as jprop
from cross_modal_video_engine_tpu.cli import detection_test as jtest
from cross_modal_video_engine_tpu.cli import detection_train as jcli
from cross_modal_video_engine_tpu.data import datasets_extra as jds
from cross_modal_video_engine_tpu.io.video_decode import write_test_video
from cross_modal_video_engine_tpu.models import lfb as jlfb
from cross_modal_video_engine_tpu.train import detection_trainer as jdt
from cross_modal_video_engine_tpu_torch.bench.serve import SeededVideo
from cross_modal_video_engine_tpu_torch.cli import ava_proposals as tprop
from cross_modal_video_engine_tpu_torch.cli import detection_test as ttest
from cross_modal_video_engine_tpu_torch.cli import detection_train as tcli
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.convert import from_jax as cv
from cross_modal_video_engine_tpu_torch.data import datasets_extra as tds
from cross_modal_video_engine_tpu_torch.models import layers as tlayers
from cross_modal_video_engine_tpu_torch.models import lfb as tlfb
from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
from cross_modal_video_engine_tpu_torch.train.checkpoint import (
    save_checkpoint)
from cross_modal_video_engine_tpu_torch.train.resume import load_train_state
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)

from torch_parity import max_rel, to_np

CLI_REL = 1e-4
# the recipes' weights after their epoch: the backbone's f32 gradients at
# the init are cancellation-dominated in either package (train-mode
# BatchNorm over two clips of a 2x2 map), so the two packages' weights
# drift up to 3e-3 of a tensor apart over two steps; one step is held to
# 1e-5 from random weights in tests/test_torch_ava.py
RECIPE_REL = 1e-2


@pytest.fixture(autouse=True)
def _torch_rng():
    with torch.random.fork_rng():
        yield


def write_corpus(root, n=4):
    """n videos whose keyframe box is bright (action 1) or dark (action 2)
    over seeded noise, and their AVA csv (keyframe at 0.6 s, two persons
    in the first video)."""
    rng = np.random.default_rng(7)
    vdir = root / "videos"
    vdir.mkdir()
    rows = []
    for i in range(n):
        action = 1 + i % 2
        frames = np.full((12, 32, 32, 3), 128, np.uint8)
        frames[:, 2:14, 2:14] = 230 if action == 1 else 20
        frames = np.clip(frames + rng.integers(-8, 8, frames.shape), 0,
                         255).astype(np.uint8)
        write_test_video(str(vdir / f"v{i}.mp4"), frames, fps=10)
        rows.append(f"v{i}.mp4,0.6,0.0625,0.0625,0.4375,0.4375,{action},0")
        if i == 0:
            rows.append("v0.mp4,0.6,0.5,0.5,0.9,0.95,3,1")
    ann = root / "ann.csv"
    ann.write_text("\n".join(rows))
    labels = root / "labels.pbtxt"
    labels.write_text("".join(f'item {{\n  name: "act{i}"\n  id: {i}\n}}\n'
                              for i in (1, 2, 3)))
    return str(ann), str(vdir), str(labels)


def write_config(root, ann, vdir, extra_model="", epochs=2, bs=3):
    cfg = root / "config.py"
    cfg.write_text(f"""
model = dict(
    backbone=dict(type='SlowOnly', stage_blocks=[1, 1, 1, 1],
                  base_channels=8, conv1_kernel_t=1,
                  stage_temporal_kernels=[1, 1, 3, 3],
                  stage_spatial_strides=[1, 2, 2, 1]),
    roi_head=dict(num_classes=4, roi_size=2, sampling_ratio=1,
                  dropout=0.0),
    train_cfg=dict(pos_iou_thr=0.9, max_boxes=2),
    test_cfg=dict(action_thr=0.002),
    {extra_model})
data = dict(
    train=dict(ann_file=r'{ann}', data_prefix=r'{vdir}'),
    val=dict(ann_file=r'{ann}', data_prefix=r'{vdir}'),
    fps=10, timestamp_start=0,
    pipeline=[
        dict(type='DecordInit'),
        dict(type='SampleAVAFrames', clip_len=4, frame_interval=2, seed=3),
        dict(type='DecordDecode'),
        dict(type='Resize', scale=(32, 32), keep_ratio=False),
        dict(type='Normalize', mean=[127.5]*3, std=[127.5]*3),
        dict(type='FormatShape', input_format='NTHWC'),
    ],
    videos_per_gpu={bs})
optimizer = dict(optimizer='sgd', learning_rate=0.05, momentum=0.9,
                 weight_decay=1e-4, grad_clip=1.0)
total_epochs = {epochs}
eval_interval = 1
""")
    return str(cfg)


def same_init(monkeypatch, cfg_path):
    """The JAX AVAFastRCNN.init returns the port's training init of the
    same structure (with or without its shared head)."""
    cfg = Config.fromfile(cfg_path)
    inits = {}
    for bare in (False, True):
        m = tcli.build_detection_model(cfg, "cpu", bare=bare)
        inits[bare] = jax.tree.map(jnp.asarray, cv.ava_detector_variables_to_jax(
            m.state_dict(), m))
    monkeypatch.setattr(jdt.AVAFastRCNN, "init", lambda self, *a, **k:
                        inits[self.shared_head is None])


def keep_all(monkeypatch):
    """Every dropout keeps every element, in both packages."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))

    def forward(self, x):
        return x / (1.0 - self.p) if self.training and self.p else x

    monkeypatch.setattr(tlayers.Dropout, "forward", forward)


def same_history(got, want):
    assert [set(h) for h in got] == [set(h) for h in want]
    for t, j in zip(got, want):
        for k, v in j.items():
            assert abs(t[k] - v) <= CLI_REL * max(abs(v), 1e-3), (k, t, j)


def read_epoch(cfg_path, path):
    """A trainer's epoch directory read by the port into a fresh detector."""
    model = tcli.build_detection_model(Config.fromfile(cfg_path), "cpu")
    state = trt.init_rec_state(model, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(optimizer="sgd", grad_clip=1.0)))
    load_train_state(path, {"state": state, "batch_stats": model})
    return model


def noise_prone(model) -> set:
    """The tensors whose updates are cancellation noise at the init: the
    BatchNorm biases (train-mode BatchNorm's backward cancels) and the
    non-local key projection's bias (the softmax ignores a shift shared by
    all keys, so its gradient is zero but for rounding)."""
    out = {f"{n}.bias" for n, m in model.named_modules()
           if isinstance(m, tlayers.FlaxBatchNorm)}
    return out | {k for k in model.state_dict()
                  if k.endswith("non_local_layer_1.lt_feat_conv.bias")}


def same_weights(a, b, rel=CLI_REL):
    """Each tensor within rel of its largest; the noise-prone ones within
    rel of the model's largest weight."""
    sa, sb = a.state_dict(), b.state_dict()
    noisy = noise_prone(a)
    top = max(float(v.abs().max()) for k, v in sb.items()
              if v.is_floating_point())
    for k in sa:
        if k.endswith("num_batches_tracked"):
            continue
        if k in noisy:
            assert float((sa[k] - sb[k]).abs().max()) <= rel * top, k
        else:
            assert max_rel(to_np(sa[k]), to_np(sb[k])) <= rel, k


def test_detection_cli_train_test_and_resume_match_jax(tmp_path, monkeypatch,
                                                      capsys):
    """Two epochs of each CLI with eval (the tail batch padded), then each
    package resumes the other's epoch_1 for a third, and each scores the
    other's model_best through detection_test and ava_eval."""
    ann, vdir, labels = write_corpus(tmp_path)
    cfg = write_config(tmp_path, ann, vdir)
    same_init(monkeypatch, cfg)
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    thist = tcli.main([cfg, "--work_dir", port, "--device", "cpu"])
    jhist = jcli.main([cfg, "--work_dir", jax_dir])
    same_history(thist, jhist)
    assert all(np.isfinite(h["loss"]) for h in thist)
    same_weights(read_epoch(cfg, os.path.join(port, "epoch_1")),
                 read_epoch(cfg, os.path.join(jax_dir, "epoch_1")))

    # each resumes the other's epoch_1
    t3 = tcli.main([cfg, "--work_dir", port, "--resume",
                    os.path.join(jax_dir, "epoch_1"), "--total_epochs", "3",
                    "--device", "cpu"])
    j3 = jcli.main([cfg, "--work_dir", jax_dir, "--resume",
                    os.path.join(port, "epoch_1"), "--total_epochs", "3"])
    assert [h["epoch"] for h in t3] == [h["epoch"] for h in j3] == [2]
    same_history(t3, j3)

    # each package scores the other's model_best: the same csv bytes
    outs = {}
    for name, run, best in (
            ("t", lambda a: ttest.main(a + ["--device", "cpu"]), jax_dir),
            ("j", jtest.main, port)):
        for src in (port, jax_dir):
            out = str(tmp_path / f"{name}_{os.path.basename(src)}.csv")
            report = run([cfg, "--checkpoint", os.path.join(src, "model_best"),
                          "--out", out, "--label_file", labels])
            outs[name, src] = (open(out, "rb").read(), report)
    for src in (port, jax_dir):
        (tb, tr), (jb, jr) = outs["t", src], outs["j", src]
        assert tb == jb and tb
        assert tr.keys() == jr.keys()
        for k, v in jr.items():
            assert k == "out" or tr[k] == v, k
    capsys.readouterr()


@pytest.mark.parametrize("kind", ["lfb", "acrn"])
def test_lfb_and_acrn_recipes_match_jax(kind, tmp_path, monkeypatch, capsys):
    """One epoch of each package's CLI: the LFB recipe builds its bank over
    both splits from the bare detector and saves it (each package loads
    the other's), the ACRN recipe trains its BatchNorm head; an FBO
    checkpoint without its bank is refused by both detection_tests."""
    ann, vdir, _ = write_corpus(tmp_path)
    banks = {n: str(tmp_path / f"{n}_lfb.npz") for n in ("t", "j")}
    extra = {"lfb": "shared_head=dict(type='FBO', fbo_type='non_local', "
                    "latent_channels=8, num_non_local_layers=1), "
                    "lfb=dict(window_size=4, capacity=2)",
             "acrn": "shared_head=dict(type='ACRN', out_channels=8)"}[kind]
    cfg = write_config(tmp_path, ann, vdir, extra, epochs=1, bs=2)
    same_init(monkeypatch, cfg)
    keep_all(monkeypatch)
    runs = {}
    for name in ("t", "j"):
        opts = ["--cfg-options", f"model.lfb.path={banks[name]}"] \
            if kind == "lfb" else []
        work = str(tmp_path / name)
        runs[name] = (tcli.main([cfg, "--work_dir", work, "--device", "cpu"]
                                + opts) if name == "t" else
                      jcli.main([cfg, "--work_dir", work] + opts))
    same_history(runs["t"], runs["j"])
    same_weights(read_epoch(cfg, str(tmp_path / "t" / "epoch_0")),
                 read_epoch(cfg, str(tmp_path / "j" / "epoch_0")), RECIPE_REL)
    if kind == "lfb":
        tb = tlfb.LongTermFeatureBank.load(banks["j"], device="cpu")
        jb = jlfb.LongTermFeatureBank.load(banks["t"])
        np.testing.assert_array_equal(tb.step_table.numpy(),
                                      np.asarray(jb.step_table))
        assert max_rel(tb.features.numpy(), np.asarray(jb.features)) <= 1e-5
        best = str(tmp_path / "t" / "model_best")
        with pytest.raises(ValueError, match="feature bank"):
            ttest.main([cfg, "--checkpoint", best, "--device", "cpu"])
        with pytest.raises(ValueError, match="feature bank"):
            jtest.main([cfg, "--checkpoint", best])
    capsys.readouterr()


# -- ava_proposals --------------------------------------------------------------------

def test_ava_proposals_match_jax(tmp_path, monkeypatch, capsys):
    """A seeded YOLOv5 (person fires on every frame) saved in the JAX
    format, run by each package's CLI over seeded videos: the same
    proposal json within 1e-5, and detection_train's proposal loader
    reads it."""
    yolo = tyolo.YoloConfig(num_classes=3, depth_multiple=0.33,
                            width_multiple=0.125, img_size=64)
    det = tyolo.YoloV5(yolo, device="cpu")
    det.load_state_dict(tyolo.random_state_dict(yolo, seed=5, fire=(0,)))
    ckpt = str(tmp_path / "yolo")
    save_checkpoint(ckpt, cv.yolo_variables_to_jax(det.state_dict(), yolo),
                    yolo)
    videos = {f"v{i}.mp4": SeededVideo(60 + i, frames=30, height=48,
                                       width=80) for i in range(3)}
    ann = tmp_path / "ann.csv"
    ann.write_text("\n".join(f"v{i}.mp4,{0.2 + 0.3 * i:.1f},0.1,0.1,0.5,0.5,1"
                             for i in range(3)) + "\nv9.mp4,0.1,0,0,1,1,1\n")
    videos["v9.mp4"] = SeededVideo(69, frames=0)
    monkeypatch.setattr(jprop, "open_video", videos.__getitem__)
    args = ["--ann_file", str(ann), "--yolo_checkpoint", ckpt, "--img_size",
            "64", "--conf", "0.1", "--fps", "10"]
    want = jprop.main(args + ["--out", str(tmp_path / "j.json")])
    got = tprop.main(args + ["--out", str(tmp_path / "t.json"), "--device",
                             "cpu"], reader=videos.__getitem__)
    assert got.keys() == want.keys()
    assert sum(len(v) for v in want.values()) > 0
    for k in want:
        assert len(got[k]) == len(want[k]), k
        if want[k]:
            assert np.abs(np.asarray(got[k]) - np.asarray(want[k])).max() \
                <= 1e-5, k
    assert want["v9.mp4,0000"] == []
    loaded = tcli._load_proposals(str(tmp_path / "t.json"))
    assert set(loaded) == set(want)
    # the dataset path: each keyframe's centre frame
    ds = tds.AVADataset(str(ann))
    jd = jds.AVADataset(str(ann))
    for i in range(3):
        kf = ds[i]
        a = tprop.keyframe_frame(kf["filename"], kf["timestamp"], 10, 0,
                                 videos.__getitem__)
        b = jprop.keyframe_frame(jd[i]["filename"], jd[i]["timestamp"], 10)
        np.testing.assert_array_equal(a, b)
    capsys.readouterr()

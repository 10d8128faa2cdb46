"""The port's skeleton trainer CLI against the JAX CLI, on the CPU on
tests/test_skeleton_train_cli.py's fixtures (8 clips of 12 frames on a
16x16 canvas, two classes; channels (8, 8) and a PoseC3D of stage blocks
(1, 1) at base 8).

Each recipe (ST-GCN with one and two persons, AGCN's joint and bone
streams, PoseC3D over 16x16 heatmaps) trains two epochs in both packages
from the same init (the JAX modules' `init` patched to the port's
training init); every dropout keeps every element in both packages
(`jax.random.bernoulli` patched to ones, the port's Dropout to its
keep-all mask), so the CLIs run the same arithmetic.  Both start from
seeded weights (`patch_init`: at the training init the f32 gradients of
AGCN's 1e-6 paths cancel in either package).  Tolerances: each history
value within 1e-4 relative; each weight after the two steps within 1e-3
of its tensor's largest (WEIGHT_REL), the biases whose gradient is zero
by structure (tests/test_torch_stgcn.ZERO_BY_STRUCTURE: their updates
are rounding noise in either package) within 1e-3 of the model's largest
weight.  The recipes train with the shipped configs' SGD.  Each package
reads the other's `epoch_0` and resumes to the same second epoch, and the
other's `model_best` loads.  NTU-25's bone stream is refused by both, by
the same numpy broadcast error.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import skeleton_train as jcli
from cross_modal_video_engine_tpu.config import Config as JConfig
from cross_modal_video_engine_tpu.data.datasets_extra import (
    PoseDataset as JPoseDataset)
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import stgcn as jst
from cross_modal_video_engine_tpu.train import resume as jresume
from cross_modal_video_engine_tpu.train.checkpoint import (
    load_checkpoint as jload_checkpoint)
from cross_modal_video_engine_tpu_torch.cli import skeleton_train as tcli
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.convert import (
    conv_recognizer_state_dict_from_jax, conv_recognizer_variables_to_jax)
from cross_modal_video_engine_tpu_torch.data.datasets_extra import (
    PoseDataset)
from cross_modal_video_engine_tpu_torch.models import layers as tlayers
from cross_modal_video_engine_tpu_torch.train import recognition_trainer as trt
from cross_modal_video_engine_tpu_torch.train.checkpoint import (
    load_checkpoint)
from cross_modal_video_engine_tpu_torch.train.resume import load_train_state
from test_skeleton_train_cli import _cfg, _pose_fixture
from test_torch_stgcn import ZERO_BY_STRUCTURE, seeded_state_dict

CLI_REL = 1e-4
# the weights after the two SGD steps, of each tensor's largest: the
# packages' f32 gradients of train-mode BatchNorm over 8 clips differ by
# up to some 1e-3 of a tensor's largest update (AGCN's first temporal
# conv, PoseC3D's stem), and 1e-4 of the weight is about that
WEIGHT_REL = 1e-3
EPOCHS = 2
SGD = ("optimizer = dict(optimizer='sgd', learning_rate=0.01, momentum=0.9, "
       "weight_decay=1e-4, grad_clip=40.0)")
GCN = ("dict(backbone=dict(type='{}', num_joints=17, channels=[8, 8], "
       "temporal_strides=[1, 2]), num_classes=2)")
POSEC3D = ("dict(backbone=dict(type='PoseC3D', stage_blocks=[1, 1], "
           "base_channels=8, conv1_kernel_t=1, stage_temporal_kernels=[1, 3],"
           " stage_spatial_strides=[1, 2]), num_classes=2)")
RECIPES = {
    "stgcn": (GCN.format("STGCN"), ""),
    "stgcn_two_persons": (GCN.format("STGCN"), ", num_persons=2"),
    "agcn_joint": (GCN.format("AGCN"), ""),
    "agcn_bone": (GCN.format("AGCN"), ", stream='bone'"),
    "posec3d": (POSEC3D, ", heatmap=dict(sigma=1.0, img_shape=[16, 16], "
                         "with_limb=True)"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def two_person_fixture(tmp_path):
    """test_skeleton_train_cli.test_multi_person_stgcn's clips: two
    persons, some with one visible, and an img_shape."""
    annos, rng = [], np.random.default_rng(31)
    for i in range(8):
        kp = rng.normal(0.0, 0.6, (2, 12, 17, 3)).astype(np.float32)
        kp[..., :2] += 8.0
        kp[..., 2] = 1.0
        kp[:, :, 9:11, 1] += -4.0 if i % 2 == 0 else 4.0
        annos.append({"keypoint": kp[:1] if i % 3 == 0 else kp,
                      "label": i % 2, "img_shape": (16, 16)})
    path = tmp_path / "poses2.pkl"
    with open(path, "wb") as f:
        pickle.dump(annos, f)
    return str(path)


def keep_all(monkeypatch):
    """Every dropout keeps every element, in both packages."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.ones(shape, bool))

    def forward(self, x):
        return x / (1.0 - self.p) if self.training and self.p else x

    monkeypatch.setattr(tlayers.Dropout, "forward", forward)


def recipe(tmp_path, name, optimizer=SGD):
    """The fixture's config of the recipe, trained by the shipped configs'
    SGD (configs/skeleton/*: momentum 0.9, weight decay 1e-4, clip 40) at
    a tenth of their learning rate (0.01, for 8 clips: at 0.1 a step from
    the seeded weights moves them so far that f32 rounding in step 1
    shows in step 2's weights at 1e-3)."""
    model, extra = RECIPES[name]
    ann = (two_person_fixture(tmp_path) if "persons" in extra
           else _pose_fixture(tmp_path))
    path = _cfg(tmp_path, ann, model, data_extra=extra, epochs=EPOCHS)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write("\n".join(optimizer if line.startswith("optimizer =")
                          else line for line in text.split("\n")))
    return path


def patch_init(monkeypatch, cfg):
    """Both CLIs start from seeded weights: the port's init patched to
    test_torch_stgcn.seeded_state_dict (well-conditioned gradients: at the
    training init AGCN's PA and gcn BatchNorm scale are 1e-6 and every
    bias 0, and the f32 gradients of what learns through them are
    cancellation noise in either package), the JAX modules' init to the
    same weights."""
    monkeypatch.setattr(tcli, "conv_init_state_dict",
                        lambda model, seed: seeded_state_dict(model, seed))
    model = tcli.build_skeleton_model(cfg, "cpu")
    init = conv_recognizer_variables_to_jax(model.state_dict(), model)
    for cls in (jrec.BackboneClassifier, jst.SkeletonClassifier):
        monkeypatch.setattr(cls, "init", lambda self, *a, **k:
                            jax.tree.map(jnp.asarray, init))
    return model


def same_history(got, want):
    assert [set(h) for h in got] == [set(h) for h in want]
    for t, j in zip(got, want):
        for k, v in j.items():
            assert abs(t[k] - v) <= CLI_REL * max(abs(v), 1e-3), (k, t, j)


def jax_template(state, stats):
    return {"state": state, "batch_stats": stats}


@pytest.mark.parametrize("name", list(RECIPES))
def test_cli_matches_jax_and_resumes_across(tmp_path, monkeypatch, capsys,
                                            name):
    path = recipe(tmp_path, name)
    cfg, jcfg = Config.fromfile(path), JConfig.fromfile(path)
    keep_all(monkeypatch)
    patch_init(monkeypatch, cfg)
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    os.makedirs(port)
    os.makedirs(jax_dir)
    tstate, thist = tcli.train_from_config(cfg, port, device="cpu")
    jstate, jhist = jcli.train_from_config(jcfg, jax_dir)
    same_history(thist, jhist)
    model = tstate.model
    want = conv_recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.params)}, model)
    largest = max(float(w.abs().max()) for w in want.values())
    for n, p in model.named_parameters():
        got, w = p.detach().numpy(), want[n].numpy()
        scale = largest if ZERO_BY_STRUCTURE.search(n) else np.abs(w).max()
        assert np.abs(got - w).max() <= WEIGHT_REL * scale, n

    # the port resumes the JAX epoch_0 to the JAX CLI's second epoch
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    _, rhist = tcli.train_from_config(cfg, resumed,
                                      os.path.join(jax_dir, "epoch_0"),
                                      device="cpu")
    same_history(rhist, jhist[1:])
    # the JAX package reads the port's epoch and best checkpoint
    payload, loop = jresume.load_train_state(
        os.path.join(port, "epoch_1"), jax_template(jstate, None))
    assert loop == {"epoch": 1}
    jflat = jax.tree.leaves(payload["state"].params)
    assert all(np.isfinite(np.asarray(a)).all() for a in jflat)
    variables, config, meta = jload_checkpoint(
        os.path.join(port, "model_best"))
    assert config["stream"] == cfg.get("data.stream", "joint")
    assert set(variables) == {"params", "batch_stats"}
    # and the port reads the JAX package's best checkpoint
    tvars, tconfig, _ = load_checkpoint(os.path.join(jax_dir, "model_best"))
    assert tconfig == config
    model.load_state_dict(conv_recognizer_state_dict_from_jax(tvars, model),
                          strict=False)
    capsys.readouterr()


def test_resume_reads_its_own_epoch(tmp_path, capsys):
    """`--resume` with no directory continues from the newest epoch,
    through `main(argv, device=)`."""
    path = recipe(tmp_path, "agcn_joint")
    work = str(tmp_path / "w")
    tcli.main([path, "--work_dir", work, "--total_epochs", "1"],
              device="cpu")
    history = tcli.main([path, "--work_dir", work, "--resume",
                         "--total_epochs", "2", "--device", "cpu"])
    assert [h["epoch"] for h in history] == [1]
    state = trt.init_rec_state(tcli.build_skeleton_model(
        Config.fromfile(path), "cpu"), trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(optimizer="sgd", learning_rate=0.1,
                                   grad_clip=40.0)))
    payload, loop = load_train_state(os.path.join(work, "epoch_1"),
                                     {"state": state,
                                      "batch_stats": state.model})
    assert loop["epoch"] == 1 and payload["state"].step == 2
    capsys.readouterr()


def test_ntu_bone_stream_is_refused_by_both(tmp_path):
    """The shipped 2s-AGCN recipe is NTU-25; its bone stream indexes the
    17 COCO parents, which numpy refuses to broadcast, in both
    packages."""
    rng = np.random.default_rng(12)
    annos = [{"keypoint": rng.random((2, 6, 25, 3)).astype(np.float32),
              "label": 0}]
    path = tmp_path / "ntu.pkl"
    with open(path, "wb") as f:
        pickle.dump(annos, f)
    errors = []
    for batches, ds in (
            (tcli.skeleton_arrays, PoseDataset(str(path), 4, 25, 2)),
            (jcli.skeleton_batches, JPoseDataset(str(path), 4, 25, 2))):
        with pytest.raises(ValueError) as info:
            next(batches(ds, 1, "bone"))
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "broadcast" in errors[0]
    kp = annos[0]["keypoint"][0]
    with pytest.raises(ValueError) as a:
        tcli.to_bone_stream(kp)
    with pytest.raises(ValueError) as b:
        jcli.to_bone_stream(kp)
    assert str(a.value) == str(b.value)

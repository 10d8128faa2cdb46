"""The port's recognition training (the TimeSformer arm) against the JAX
package's, on the CPU at a small size (4 frames of 16², patch 8, width
32, 2 heads, 2 layers, 6 classes; dropouts 0 where the packages are
compared).

* Three steps of `make_cls_train_step` against JAX's, each from JAX's
  state, for a divided and a joint flash model (the JAX kernel in
  interpret mode), with SGD (momentum, weight decay, the clip engaged, a
  warmup: the first update has a learning rate of 0) and AdamW: the
  bounds of tests/torch_parity.check_step (loss 1e-5 relative, gradients
  and parameters 1e-5 of their tensor's largest magnitude, AdamW's noise
  elements 2 lr); top-1 equal.
* `bf16=True` against JAX's bf16 step on a backbone configured in
  bfloat16, f32 masters in both: the loss within 2e-2 relative, each
  gradient's cosine to JAX's >= 0.99, gradients and masters f32.
* `evaluate_classification`, `ShardedSampler` and the datasets'
  annotations equal to JAX's.
* `rec_train_state_to_jax` lays each chain's state out as flax
  serializes optax's `tx.init` of it.
* The train state (`{"state": RecTrainState, "batch_stats": None}`) of
  each optimizer chain (SGD with and without clip, schedule and
  momentum; AdamW with and without clip and schedule) written by each
  package and read by the other: the same bytes, and the state the
  other package wrote loads leaf for leaf.
* `recognition_train.main` end to end on a tiny OpenCV-written fixture,
  in f32 and with `optimizer.bf16=True`: the loss falls, model_best loads
  through `api.init_recognizer` (and the JAX package's, equal scores
  within 1e-5) and `explain_demo.load_explain_model`, `--resume`
  continues at the next epoch.
* The slice-5 recipes (mixup, cutmix, OmniSource, multigrid) through
  `train_from_config` against the JAX CLI; an unknown blending and a
  model cast whole to bf16 are refused.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from cross_modal_video_engine_tpu import api as japi
from cross_modal_video_engine_tpu.data import datasets as jds
from cross_modal_video_engine_tpu.io.video_decode import write_test_video
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu.train import resume as jres
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.cli import recognition_train as trt_cli
from cross_modal_video_engine_tpu_torch.cli.explain_demo import (
    load_explain_model)
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.convert import (
    rec_train_state_to_jax, recognizer_state_dict_from_jax)
from cross_modal_video_engine_tpu_torch.data import datasets as tds
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from cross_modal_video_engine_tpu_torch.train import resume as tres
from torch_parity import (capturing, check_step, interpret_pallas,
                          key_bias_mask, load_jax_state, max_rel,
                          min_cosine, random_variables, to_np)

SMALL = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
             num_heads=2, num_layers=2, drop_path_max=0.0)
BACKBONES = {
    "divided": dict(SMALL, attention_type="divided_space_time"),
    "joint+flash": dict(SMALL, attention_type="joint_space_time",
                        use_flash_attention=True),
}
CLASSES, BATCH, STEPS, TOTAL_STEPS = 6, 4, 3, 5
CHAINS = {
    "sgd": dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
                weight_decay=1e-2, grad_clip=0.5, warmup_steps=2),
    "adamw": dict(optimizer="adamw", learning_rate=1e-3, weight_decay=1e-2,
                  grad_clip=0.0),
}
BF16_LOSS_REL, BF16_GRAD_COS = 2e-2, 0.99


@pytest.fixture(autouse=True, scope="module")
def _interpret():
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread, and torch's global RNG and thread count left as
    found (tests/test_stgcn_conversion.py draws from the global RNG)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _pair(backbone, seed=13, port_dtype=None):
    """The JAX classifier with random variables and the port's loaded
    from them (port_dtype: the port backbone's dtype, default the
    config's)."""
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**backbone),
                           num_classes=CLASSES)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3), jnp.float32)), seed)
    cfg = tts.TimeSformerConfig(**dict(backbone,
                                       dtype=port_dtype or backbone.get(
                                           "dtype", "float32")))
    tm = trec.Recognizer3D(cfg, CLASSES, device="cpu")
    tm.load_state_dict(recognizer_state_dict_from_jax(variables, cfg))
    return jm, variables, tm


def _cls_batch(seed):
    rng = np.random.default_rng(200 + seed)
    videos = rng.standard_normal((BATCH, 4, 16, 16, 3)).astype(np.float32)
    return videos, rng.integers(0, CLASSES, BATCH)


def _jax_state(variables, tx):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jrt.RecTrainState(params, tx.init(params),
                             jnp.zeros((), jnp.int32))


# -- train steps ---------------------------------------------------------------------

@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_cls_train_steps_match_jax(backbone, chain):
    jm, variables, tm = _pair(BACKBONES[backbone])
    jtx = capturing(jrt.make_rec_optimizer(
        jrt.RecognitionTrainConfig(**CHAINS[chain]), total_steps=TOTAL_STEPS))
    jstate = _jax_state(variables, jtx)
    jstep = jrt.make_cls_train_step(jm, jtx)
    tcfg = trt.RecognitionTrainConfig(**CHAINS[chain])
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        tcfg, total_steps=TOTAL_STEPS))
    tstep = trt.make_cls_train_step(tm, device="cpu")
    for i in range(STEPS):
        v, lab = _cls_batch(i)
        tstate = load_jax_state(tstate, jstate, tstate.optimizer.kind,
                                tcfg.grad_clip > 0)
        jstate, jlogs = jstep(jstate, jnp.asarray(v),
                              jnp.asarray(lab, jnp.int32), jax.random.key(i))
        tstate, tlogs = tstep(tstate, torch.from_numpy(v),
                              torch.from_numpy(lab))
        check_step(tm, tm.backbone.cfg, jstate, tlogs, jlogs,
                   tcfg.learning_rate, chain)
        assert float(tlogs["top1_acc"]) == float(jlogs["top1_acc"])
    assert tstate.step == STEPS and tm.training


@pytest.mark.parametrize("config_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_bf16_step_matches_jax(backbone, config_dtype):
    """The port's bf16 step on f32 masters against JAX's bf16=True step on
    a backbone configured in bfloat16 (where both compute in bfloat16)
    and on one configured in float32 (where both compute in f32 with the
    parameters and videos rounded to bf16; tests/test_torch_timesformer_
    bf16.py holds that case tighter)."""
    bb = dict(BACKBONES[backbone], dtype=config_dtype)
    jm, variables, tm = _pair(bb, port_dtype="float32")
    jtx = capturing(jrt.make_rec_optimizer(
        jrt.RecognitionTrainConfig(**CHAINS["sgd"]), total_steps=TOTAL_STEPS))
    jstate = _jax_state(variables, jtx)
    jstep = jrt.make_cls_train_step(jm, jtx, bf16=True)
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**CHAINS["sgd"]), total_steps=TOTAL_STEPS))
    tstep = trt.make_cls_train_step(tm, bf16=True, device="cpu")
    v, lab = _cls_batch(0)
    jstate, jlogs = jstep(jstate, jnp.asarray(v), jnp.asarray(lab, jnp.int32),
                          jax.random.key(0))
    tstate, tlogs = tstep(tstate, torch.from_numpy(v), torch.from_numpy(lab))
    jloss = float(jlogs["loss"])
    assert abs(float(tlogs["loss"]) - jloss) <= BF16_LOSS_REL * abs(jloss)
    jgrads = recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.opt_state[0])},
        tm.backbone.cfg)
    for name, p in tm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert min_cosine(to_np(p.grad).reshape(1, -1),
                          jgrads[name].numpy().reshape(1, -1)) \
            >= BF16_GRAD_COS, name


def test_evaluate_classification_matches_jax():
    jm, variables, tm = _pair(BACKBONES["divided"])
    batches = [_cls_batch(i) for i in range(2)]
    want = jrt.evaluate_classification(
        jm, variables["params"],
        [(jnp.asarray(v), jnp.asarray(lab), 3) for v, lab in batches])
    got = trt.evaluate_classification(
        tm, [(torch.from_numpy(v), torch.from_numpy(lab), 3)
             for v, lab in batches])
    assert got == pytest.approx(want, abs=1e-9)
    assert not tm.training


@pytest.mark.parametrize("n,world,rank,shuffle,seed",
                         [(10, 1, 0, True, 0), (10, 3, 2, True, 5),
                          (2, 4, 3, True, 1), (7, 2, 1, False, 0)])
def test_sharded_sampler_matches_jax(n, world, rank, shuffle, seed):
    j = jds.ShardedSampler(n, world, rank, shuffle, seed)
    t = tds.ShardedSampler(n, world, rank, shuffle, seed)
    for epoch in range(3):
        assert t.indices(epoch) == [int(i) for i in j.indices(epoch)]


def test_datasets_read_annotations_as_jax_does(tmp_path):
    """VideoDataset and RawframeDataset (start_index 1) against JAX's on
    the same split files."""
    (tmp_path / "v.txt").write_text("a.mp4 3\n\nb.mp4 0\n")
    (tmp_path / "r.txt").write_text("dir_a 30 2\ndir_b 12 5\n")
    for cls, ann in (("VideoDataset", "v.txt"), ("RawframeDataset", "r.txt")):
        j = getattr(jds, cls)(str(tmp_path / ann), None, "root")
        t = getattr(tds, cls)(str(tmp_path / ann), None, "root")
        assert t.video_infos == j.video_infos and len(t) == len(j) == 2
        assert t.start_index == j.start_index == (cls == "RawframeDataset")


# -- train states across packages ------------------------------------------------------

STATE_CHAINS = {
    "sgd clip+schedule": dict(CHAINS["sgd"]),
    "sgd no clip, no schedule": dict(CHAINS["sgd"], grad_clip=0.0,
                                     warmup_steps=0),
    "sgd no momentum": dict(CHAINS["sgd"], momentum=None),
    "adamw clip+schedule": dict(CHAINS["adamw"], grad_clip=0.5,
                                warmup_steps=1),
    "adamw": dict(CHAINS["adamw"]),
}


@pytest.mark.parametrize("chain", list(STATE_CHAINS))
def test_rec_train_state_layout_is_optax_init(chain):
    """rec_train_state_to_jax lays the optimizer state out as flax
    serializes optax's `tx.init` of make_rec_optimizer's chain: the same
    paths, shapes and dtypes."""
    kw = STATE_CHAINS[chain]
    _, variables, tm = _pair(BACKBONES["divided"])
    jtx = jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**kw),
                                 total_steps=TOTAL_STEPS)
    want = serialization.to_state_dict(jax.tree.map(
        np.asarray, _jax_state(variables, jtx)._asdict()))
    state = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**kw), total_steps=TOTAL_STEPS))
    opt = state.optimizer
    got = rec_train_state_to_jax(
        tm.state_dict(), opt.named_state(), 0, tm.backbone.cfg, opt.kind,
        opt.max_norm is not None, opt.scheduled)

    def leaves(tree):
        return [(jax.tree_util.keystr(p), np.shape(x), np.asarray(x).dtype)
                for p, x in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, dict) and not x)[0]]

    assert leaves(got) == leaves(want)


def _bytes(path):
    with open(os.path.join(path, "train_state.msgpack"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("chain", list(STATE_CHAINS))
def test_train_state_crosses_packages_byte_for_byte(tmp_path, chain):
    """JAX writes its state after two steps: the port reads it and writes
    the same bytes; the port writes its state after two more steps: JAX
    reads it (its own template) and writes the same bytes, and the port
    reads it back leaf for leaf."""
    kw = STATE_CHAINS[chain]
    jm, variables, tm = _pair(BACKBONES["divided"])
    jtx = jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**kw),
                                 total_steps=TOTAL_STEPS)
    jstate = _jax_state(variables, jtx)
    jstep = jrt.make_cls_train_step(jm, jtx)
    for i in range(2):
        v, lab = _cls_batch(i)
        jstate, _ = jstep(jstate, jnp.asarray(v), jnp.asarray(lab, jnp.int32),
                          jax.random.key(i))
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jres.save_train_state(jax_dir, {"state": jstate, "batch_stats": None},
                          {"epoch": 3})
    tx = trt.make_rec_optimizer(trt.RecognitionTrainConfig(**kw),
                                total_steps=TOTAL_STEPS)
    tstate = trt.init_rec_state(tm, tx)
    payload, loop = tres.load_train_state(jax_dir, {"state": tstate,
                                                    "batch_stats": None})
    assert loop == {"epoch": 3} and payload["batch_stats"] is None
    tstate = payload["state"]
    assert tstate.step == 2
    tres.save_train_state(port_dir, payload, loop)
    assert _bytes(port_dir) == _bytes(jax_dir)

    # two port steps, then the other way round
    step = trt.make_cls_train_step(tm, device="cpu")
    for i in range(2, 4):
        v, lab = _cls_batch(i)
        tstate, _ = step(tstate, torch.from_numpy(v), torch.from_numpy(lab))
    tres.save_train_state(port_dir, {"state": tstate, "batch_stats": None},
                          {"epoch": 4})
    template = {"state": _jax_state(variables, jtx), "batch_stats": None}
    jpayload, jloop = jres.load_train_state(port_dir, template)
    assert jloop == {"epoch": 4} and int(jpayload["state"].step) == 4
    again = str(tmp_path / "again")
    jres.save_train_state(again, jpayload, jloop)
    assert _bytes(again) == _bytes(port_dir)
    sd = recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jpayload["state"].params)},
        tm.backbone.cfg)
    for k, t in tm.state_dict().items():
        assert torch.equal(t, sd[k]), k


# -- the CLI -------------------------------------------------------------------------

def write_fixture(tmp_path, n=8, seed=78, optimizer="dict(optimizer='adamw', "
                  "learning_rate=3e-3, grad_clip=1.0)"):
    """Eight 10-frame 32² videos whose brightness encodes their class (0
    dark, 1 bright), their split, and a tiny config."""
    rng = np.random.default_rng(seed)
    vdir = tmp_path / "videos"
    vdir.mkdir(exist_ok=True)
    lines = []
    for i in range(n):
        cls = i % 2
        frames = np.clip((40 if cls == 0 else 215)
                         + rng.integers(-20, 20, (10, 32, 32, 3)),
                         0, 255).astype(np.uint8)
        write_test_video(str(vdir / f"v{i}.mp4"), frames)
        lines.append(f"v{i}.mp4 {cls}")
    ann = tmp_path / "ann.txt"
    ann.write_text("\n".join(lines))
    cfg = tmp_path / "config.py"
    cfg.write_text(f"""
model = dict(
    backbone=dict(type='TimeSformer', num_frames=4, img_size=16,
                  patch_size=8, embed_dims=16, num_heads=2, num_layers=1,
                  drop_path_max=0.0),
    num_classes=2)
data = dict(
    train=dict(ann_file=r'{ann}', data_prefix=r'{vdir}'),
    val=dict(ann_file=r'{ann}', data_prefix=r'{vdir}'),
    pipeline=[
        dict(type='DecordInit'),
        dict(type='SampleFrames', clip_len=4, frame_interval=2,
             num_clips=1, test_mode=True),
        dict(type='DecordDecode'),
        dict(type='Resize', scale=(16, 16), keep_ratio=False),
        dict(type='Normalize', mean=[127.5]*3, std=[127.5]*3),
        dict(type='FormatShape', input_format='NTHWC'),
    ],
    videos_per_gpu=4)
optimizer = {optimizer}
total_epochs = 4
eval_interval = 2
""")
    return str(cfg)


@pytest.mark.parametrize("bf16", [False, True])
def test_recognition_train_main_end_to_end(tmp_path, capsys, bf16):
    cfg = write_fixture(tmp_path)
    work = str(tmp_path / "work")
    opts = ["--cfg-options", "optimizer.bf16=True"] if bf16 else []
    history = trt_cli.main([cfg, "--work_dir", work, "--device", "cpu"]
                           + opts)
    assert [h["epoch"] for h in history] == [0, 1, 2, 3]
    assert history[-1]["loss"] < history[0]["loss"]
    assert "top1_acc" in history[1] and "top1_acc" not in history[0]

    best = os.path.join(work, "model_best")
    model, cfg_d = load_explain_model(best, device="cpu")
    assert cfg_d["num_classes"] == 2
    assert cfg_d["backbone"]["type"] == "TimeSformer"
    jm, jvars, _ = japi.init_recognizer(best)
    clip = np.random.default_rng(3).standard_normal(
        (2, 4, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    assert np.abs(to_np(got) - np.asarray(
        jm.apply(jvars, jnp.asarray(clip)))).max() <= 1e-5
    m2, _ = api.init_recognizer(best, device="cpu")
    assert isinstance(m2, trec.Recognizer3D)

    history2 = trt_cli.main([cfg, "--work_dir", work, "--resume",
                             "--total_epochs", "5", "--device", "cpu"]
                            + opts)
    assert [h["epoch"] for h in history2] == [4]
    capsys.readouterr()


# -- what the port refuses -------------------------------------------------------------

def _jax_blend_draws(kind, alpha, steps, batch, size):
    """The draws the JAX CLI's blended steps make: its step keys split
    from key(1), each step's blending key split from its key
    (recognition_trainer.py:91-105), then blending.py's splits."""
    rng, out = jax.random.key(1), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        _, brng = jax.random.split(sub)
        if kind == "MixupBlending":
            k_lam, k_perm = jax.random.split(brng)
        else:
            k_lam, k_perm, k_cx, k_cy = jax.random.split(brng, 4)
        d = {"lam": np.float32(jax.random.beta(k_lam, alpha, alpha)),
             "perm": np.asarray(jax.random.permutation(k_perm, batch))}
        if kind == "CutmixBlending":
            d["cx"] = int(jax.random.randint(k_cx, (), 0, size))
            d["cy"] = int(jax.random.randint(k_cy, (), 0, size))
        out.append(d)
    return out


CLI_REL = 1e-4


@pytest.mark.parametrize("option,value", [
    ("train_cfg", dict(blending=dict(type="CutmixBlending", alpha=1.0))),
    ("omnisource", dict(train_ratio=[2, 1])),
    ("multigrid", dict(base_batch=8, buckets=[[2, 4, 16], [4, 4, 16]],
                       long_cycle_epochs=1, final_epochs=1)),
    ("train_cfg", dict(blending=dict(type="MixupBlending", alpha=0.2))),
])
def test_slice5_options_raise(tmp_path, monkeypatch, capsys, option, value):
    """The slice-5 recipes this test once saw refused, now ported: each
    arm of `train_from_config` against the JAX CLI for two epochs from the
    same init (the JAX Recognizer3D.init patched to the port's), the
    blended steps given the JAX CLI's own draws: the same history keys,
    values within 1e-4 relative, final weights within 1e-4 of their
    largest, the attention key biases (rounding noise that AdamW turns
    into steps of +-lr) within 2 lr a step.  OmniSource trains on the
    split as its aux source too."""
    from cross_modal_video_engine_tpu.cli import recognition_train as jcli
    from cross_modal_video_engine_tpu.config import Config as JConfig
    from cross_modal_video_engine_tpu_torch.convert import (
        recognizer_variables_to_jax)
    from cross_modal_video_engine_tpu_torch.data import blending as tbl
    path = write_fixture(tmp_path)
    cfg, jcfg = Config.fromfile(path), JConfig.fromfile(path)
    if option == "omnisource":
        value = dict(value, aux=[dict(ann_file=cfg["data.train.ann_file"],
                                      data_prefix=cfg[
                                          "data.train.data_prefix"])])
    cfg.set(option, value)
    jcfg.set(option, value)
    bb = tts.TimeSformerConfig(**{k: v for k, v in cfg[
        "model.backbone"].items() if k != "type"})
    init = recognizer_variables_to_jax(trec.init_state_dict(
        bb, 0, num_classes=2), bb)
    monkeypatch.setattr(jrec.Recognizer3D, "init", lambda self, *a, **k:
                        jax.tree.map(jnp.asarray, init))
    if option == "train_cfg":
        kind, alpha = value["blending"]["type"], value["blending"]["alpha"]
        draws = _jax_blend_draws(kind, alpha, 4, 4, 16)
        monkeypatch.setattr(tbl.Blending, "draw",
                            lambda self, *a: draws.pop(0))
    tstate, thist = trt_cli.train_from_config(cfg, str(tmp_path / "port"),
                                              num_epochs=2, device="cpu")
    jout, jhist = jcli.train_from_config(jcfg, str(tmp_path / "jax"),
                                         num_epochs=2)
    capsys.readouterr()
    assert [set(h) for h in thist] == [set(h) for h in jhist]
    for t, j in zip(thist, jhist):
        for k, v in j.items():
            if isinstance(v, float):
                assert abs(t[k] - v) <= CLI_REL * max(abs(v), 1e-3), k
            else:
                assert t[k] == (list(v) if isinstance(v, tuple) else v) \
                    or tuple(t[k]) == tuple(v), k
    jparams = jout.params if option == "train_cfg" else jout["params"]
    want = recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jparams)}, bb)
    lr, steps = cfg["optimizer.learning_rate"], tstate.optimizer.count
    noise = key_bias_mask(tstate.model)
    for name, p in tstate.model.named_parameters():
        got, w = p.detach(), want[name]
        if name in noise:       # AdamW turns their noise into +-lr steps
            m = noise[name]
            assert float((got[m] - w[m]).abs().max()) <= 2 * lr * steps
            got, w = got[~m], w[~m]
        assert max_rel(to_np(got), w.numpy()) <= CLI_REL, name
    if option == "train_cfg":
        assert not draws                    # every step blended
    final = {"omnisource": "omnisource_final",
             "multigrid": "multigrid_final"}.get(option)
    if final:
        assert os.path.isdir(tmp_path / "port" / final)


def test_blending_and_bf16_configs_raise():
    """An unknown blending is refused by name; a model cast whole to bf16
    (the serving cast) is refused by the training steps, which keep f32
    masters; a TimeSformer configured in bfloat16 trains (item 14)."""
    from cross_modal_video_engine_tpu_torch.data.blending import (
        make_blending)
    with pytest.raises(KeyError, match="available"):
        make_blending("MosaicBlending", CLASSES)
    bf = trec.Recognizer3D(tts.TimeSformerConfig(
        **dict(BACKBONES["divided"], dtype="bfloat16")), CLASSES,
        device="cpu")
    trt.make_cls_train_step(bf, device="cpu")
    trt.make_cls_train_step(bf, bf16=True, device="cpu")
    bf.to(torch.bfloat16)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="float32 masters"):
            trt.make_cls_train_step(bf, bf16=bf16, device="cpu")


def test_optimizer_refuses_a_warmup_longer_than_the_run():
    """optax's cosine schedule refuses decay_steps <= 0; so does the
    port's."""
    cfg = jrt.RecognitionTrainConfig(warmup_steps=4)
    with pytest.raises(ValueError):
        jrt.make_rec_optimizer(cfg, total_steps=4)
    _, _, tm = _pair(BACKBONES["divided"])
    with pytest.raises(ValueError, match="warmup"):
        trt.make_rec_optimizer(trt.RecognitionTrainConfig(warmup_steps=4),
                               total_steps=4)(list(tm.named_parameters()))


def test_schedule_matches_optax():
    from cross_modal_video_engine_tpu_torch.train.optim import warmup_cosine
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.05, 3, 11)
    for count in range(14):
        assert warmup_cosine(count, 0.05, 3, 11) == pytest.approx(
            float(sched(jnp.asarray(count, jnp.int32))), rel=1e-6, abs=0)

"""The port's caption (label-sequence) training against the JAX package's,
on the CPU at a small size (4 frames of 16², patch 8, width 32, 2 heads,
2 layers; the decoder 5 classes x 3 steps; dropouts 0 where the packages
are compared, since they draw from different streams by design).

* `multilabel_categorical_crossentropy` and `seq_mll_loss` (values and
  gradients) against JAX on seeded inputs, within 1e-6 relative.
* Three steps of `make_seq_train_step` against JAX's from the same
  weights (random JAX variables carried over by convert/from_jax.py),
  for a divided model and a joint one with flash attention (the JAX
  kernel in interpret mode, the port's plain version), each with SGD
  (momentum, weight decay, the clip engaged, a 2-step warmup: the first
  update has a learning rate of 0) and with AdamW (no clip, constant
  rate).  Each step starts both packages from JAX's state (parameters,
  moments and count carried into the port by
  `rec_train_state_from_jax`), since Adam turns a gradient that is
  rounding noise into a step of +-lr whose sign the noise picks; JAX's
  gradients come out of its own step (an optax transformation wrapped
  around its optimizer keeps them).  The loss within 1e-5 relative; each
  gradient and each parameter after the step within 1e-5 of its tensor's
  largest magnitude, except under AdamW the elements whose gradient is
  below 1e-6 (100 eps) and the attention key biases (softmax does not
  see them: their gradient is rounding noise): held to 2 lr.
* remat against no remat with DropPath on: the same loss and gradients,
  the generator advanced alike.
* `caption_train.main` end to end on a tiny OpenCV-written fixture (the
  JAX test's): the loss falls, model_best loads through the port's and
  the JAX package's `init_recognizer` (equal outputs within 1e-5),
  `--resume` continues at the next epoch; an epoch state the JAX CLI
  wrote resumes in the port's CLI, its next epoch's loss and seq_mAP
  within 1e-5 of the JAX CLI's own resumed epoch.
* seq_generate/mvit_relseq.py's model (small): an epoch state the JAX
  CLI wrote resumes in both CLIs with the same loss and seq_mAP.
* 'CLIP' and 'VideoCLIP' build no caption backbone (both packages raise);
  the bf16-configured TimeSformer raises.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu import api as japi
from cross_modal_video_engine_tpu.cli import caption_train as jct
from cross_modal_video_engine_tpu.io.video_decode import write_test_video
from cross_modal_video_engine_tpu.losses import seqmll as jloss
from cross_modal_video_engine_tpu.models import decoder_head as jdec
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.cli import caption_train as tct
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.convert import (
    recognizer_state_dict_from_jax)
from cross_modal_video_engine_tpu_torch.losses import seqmll as tloss
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from torch_parity import (capturing, check_step, interpret_pallas,
                          load_jax_state, max_rel, random_variables, to_np)

SMALL = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
             num_heads=2, num_layers=2, drop_path_max=0.0)
BACKBONES = {
    "divided": dict(SMALL, attention_type="divided_space_time"),
    "joint+flash": dict(SMALL, attention_type="joint_space_time",
                        use_flash_attention=True),
}
DEC = dict(num_classes=5, in_channels=32, max_len=3, input_dropout_p=0.0)
CHAINS = {
    "sgd": dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
                weight_decay=1e-2, grad_clip=0.05, warmup_steps=2),
    "adamw": dict(optimizer="adamw", learning_rate=1e-3, weight_decay=1e-2,
                  grad_clip=0.0),
}
TOTAL_STEPS, STEPS, BATCH = 5, 3, 4
LOSS_TOL, STEP_TOL = 1e-6, 1e-5


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


# -- the loss -------------------------------------------------------------------

def _loss_inputs(seed=3):
    rng = np.random.default_rng(seed)
    y_true = (rng.random((6, 5, 7)) > 0.6).astype(np.float32)
    scores = (3.0 * rng.standard_normal((6, 4, 7))).astype(np.float32)
    mask = np.ones((6, 5), np.float32)
    mask[:3, 2:] = 0.0
    return y_true, scores, mask


@pytest.mark.parametrize("probabilities", [False, True])
def test_multilabel_ce_matches_jax(probabilities):
    y_true, scores, _ = _loss_inputs()
    y_true = y_true[:, :4]
    if probabilities:       # what forward_train feeds it
        scores = 1.0 / (1.0 + np.exp(-scores))
    want, jgrad = jax.value_and_grad(
        lambda s: jloss.multilabel_categorical_crossentropy(
            jnp.asarray(y_true), s).sum())(jnp.asarray(scores))
    want_rows = jloss.multilabel_categorical_crossentropy(
        jnp.asarray(y_true), jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_(True)
    rows = tloss.multilabel_categorical_crossentropy(torch.from_numpy(y_true),
                                                     s)
    rows.sum().backward()
    assert max_rel(to_np(rows), want_rows) <= LOSS_TOL
    assert max_rel(to_np(s.grad), jgrad) <= LOSS_TOL


def test_seq_mll_loss_matches_jax():
    """Labels and mask longer than the decoder's steps are truncated; the
    masked sum is divided by the batch size."""
    y_true, scores, mask = _loss_inputs()
    probs = 1.0 / (1.0 + np.exp(-scores))
    want, jgrad = jax.value_and_grad(
        lambda p: jloss.seq_mll_loss(p, jnp.asarray(y_true),
                                     jnp.asarray(mask), 0.5))(
        jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_(True)
    got = tloss.seq_mll_loss(p, torch.from_numpy(y_true),
                             torch.from_numpy(mask), 0.5)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL * abs(
        float(want))
    assert max_rel(to_np(p.grad), jgrad) <= LOSS_TOL
    per_row = tloss.multilabel_categorical_crossentropy(
        torch.from_numpy(y_true[:, :4]), torch.from_numpy(probs))
    by_hand = 0.5 * float((per_row * torch.from_numpy(mask[:, :4])).sum()) / 6
    assert abs(float(got) - by_hand) <= 1e-6 * abs(by_hand)


# -- three train steps against JAX's ----------------------------------------------

def _pair(backbone, seed=11):
    """The JAX caption model with random variables and the port's loaded
    from them."""
    jm = jrec.Recognizer3DRelseq(jts.TimeSformerConfig(**backbone),
                                 jdec.RNNDecoderConfig(**DEC))
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3), jnp.float32),
        jnp.zeros((1, 3, 5), jnp.float32), mode="train"), seed)
    cfg = tts.TimeSformerConfig(**backbone)
    tm = trec.Recognizer3DRelseq(cfg, RNNDecoderConfig(**DEC), device="cpu")
    tm.load_state_dict(recognizer_state_dict_from_jax(variables, cfg))
    return jm, variables, tm


def _seq_batch(seed):
    rng = np.random.default_rng(100 + seed)
    videos = rng.standard_normal((BATCH, 4, 16, 16, 3)).astype(np.float32)
    targets = (rng.random((BATCH, 3, 5)) > 0.6).astype(np.float32)
    mask = np.ones((BATCH, 3), np.float32)
    mask[0, 2] = 0.0
    return videos, targets, mask


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_seq_train_steps_match_jax(backbone, chain):
    jm, variables, tm = _pair(BACKBONES[backbone])
    cfg = tm.backbone.cfg
    jtx = capturing(jrt.make_rec_optimizer(
        jrt.RecognitionTrainConfig(**CHAINS[chain]), total_steps=TOTAL_STEPS))
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jrt.RecTrainState(params, jtx.init(params),
                               jnp.zeros((), jnp.int32))
    jstep = jrt.make_seq_train_step(jm, jtx)
    tcfg = trt.RecognitionTrainConfig(**CHAINS[chain])
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        tcfg, total_steps=TOTAL_STEPS))
    tstep = trt.make_seq_train_step(tm, device="cpu")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    clip = tcfg.grad_clip > 0
    for i in range(STEPS):
        v, t, m = _seq_batch(i)
        tstate = load_jax_state(tstate, jstate, tstate.optimizer.kind, clip)
        jstate, jlogs = jstep(jstate, jnp.asarray(v), jnp.asarray(t),
                              jnp.asarray(m), jax.random.key(i))
        tstate, tlogs = tstep(tstate, torch.from_numpy(v),
                              torch.from_numpy(t), torch.from_numpy(m))
        check_step(tm, cfg, jstate, tlogs, jlogs, tcfg.learning_rate, chain)
        if chain == "sgd" and i == 0:
            # the warmup's first learning rate is 0: nothing moves, but
            # the momentum trace holds the step's (clipped, decayed) grad
            for k, p in tm.state_dict().items():
                assert torch.equal(p, before[k]), k
            trace = tstate.optimizer.named_state()["trace"]
            assert all(float(x.abs().max()) > 0 for x in trace.values())
    assert tstate.step == int(jstate.step) == STEPS
    assert tstate.optimizer.count == STEPS
    assert tm.training


def test_forward_train_is_the_seq_mll_of_train_mode_probabilities():
    """forward_train switches to train mode and feeds the decoder's
    sigmoid probabilities (not logits) to the loss, as JAX's does."""
    jm, variables, tm = _pair(BACKBONES["divided"])
    v, t, m = _seq_batch(0)
    want = jm.apply(variables, jnp.asarray(v), jnp.asarray(t), jnp.asarray(m),
                    method="forward_train")
    tm.eval()
    with torch.no_grad():
        got = tm.forward_train(torch.from_numpy(v), torch.from_numpy(t),
                               torch.from_numpy(m))
        probs = tm(torch.from_numpy(v), torch.from_numpy(t), mode="train")
    assert tm.training
    assert abs(float(got) - float(want)) <= STEP_TOL * abs(float(want))
    assert float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0
    assert float(got) == float(tloss.seq_mll_loss(
        probs, torch.from_numpy(t), torch.from_numpy(m)))


# -- remat -------------------------------------------------------------------------

@pytest.mark.parametrize("attention", ["divided_space_time",
                                       "joint_space_time"])
def test_remat_gradients_equal_no_remat_with_drop_path(attention):
    """With DropPath at 0.5 and the decoder's input dropout on, a step
    with remat draws the same masks as one without: the same loss and
    gradients, and the generator advanced alike."""
    base = dict(SMALL, attention_type=attention, drop_path_max=0.5,
                dropout_ratio=0.2)
    dec = RNNDecoderConfig(**dict(DEC, input_dropout_p=0.3))
    sd = trec.random_state_dict(tts.TimeSformerConfig(**base), 5,
                                decoder_cfg=dec)
    v, t, m = (torch.from_numpy(a) for a in _seq_batch(1))
    runs = {}
    for remat in (False, True):
        cfg = tts.TimeSformerConfig(**base, remat=remat)
        model = trec.Recognizer3DRelseq(cfg, dec, device="cpu")
        model.load_state_dict(sd)
        gen = torch.Generator().manual_seed(7)
        trt.set_generator(model, gen)
        loss = model.forward_train(v, t, m)
        loss.backward()
        runs[remat] = (float(loss), {n: p.grad for n, p in
                                     model.named_parameters()},
                       torch.rand(4, generator=gen))
    (l0, g0, next0), (l1, g1, next1) = runs[False], runs[True]
    assert l0 == l1
    assert torch.equal(next0, next1)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=0)
    # DropPath acted: the same step without it differs
    cfg = tts.TimeSformerConfig(**dict(base, drop_path_max=0.0))
    model = trec.Recognizer3DRelseq(cfg, dec, device="cpu")
    model.load_state_dict(sd)
    trt.set_generator(model, torch.Generator().manual_seed(7))
    with torch.no_grad():
        assert float(model.forward_train(v, t, m)) != l0


# -- the CLI -----------------------------------------------------------------------

def write_fixture(tmp_path, n=6, seed=77, body_extra=""):
    """Six 10-frame 32² videos whose brightness encodes their label
    sequence, their split, and a tiny config (the JAX CLI test's)."""
    rng = np.random.default_rng(seed)
    vdir = tmp_path / "videos"
    vdir.mkdir(exist_ok=True)
    lines = []
    for i in range(n):
        cls = i % 2
        base = 40 if cls == 0 else 215
        frames = np.clip(base + rng.integers(-20, 20, (10, 32, 32, 3)),
                         0, 255).astype(np.uint8)
        write_test_video(str(vdir / f"v{i}.mp4"), frames)
        lines.append(f"v{i}.mp4 {'1->2' if cls == 0 else '3->4'}")
    ann = tmp_path / "ann_relseq.txt"
    ann.write_text("\n".join(lines))
    cfg = tmp_path / "config.py"
    cfg.write_text(f"""
model = dict(
    backbone=dict(num_frames=4, img_size=16, patch_size=8, embed_dims=16,
                  num_heads=2, num_layers=1, drop_path_max=0.0),
    decoder=dict(num_classes=6, in_channels=16, max_len=3,
                 input_dropout_p=0.0))
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
    videos_per_gpu=6)
optimizer = dict(optimizer='adamw', learning_rate=3e-3, grad_clip=1.0)
total_epochs = 6
eval_interval = 2
{body_extra}""")
    return str(cfg)


def test_caption_train_main_end_to_end(tmp_path, capsys):
    cfg = write_fixture(tmp_path)
    work = str(tmp_path / "work")
    history = tct.main([cfg, "--work_dir", work, "--device", "cpu"])
    assert [h["epoch"] for h in history] == list(range(6))
    assert history[-1]["loss"] < history[0]["loss"]
    assert "seq_mAP" in history[-1] and "seq_mAP" not in history[0]
    assert sorted(d for d in os.listdir(work) if d.startswith("epoch_")) \
        == [f"epoch_{i}" for i in range(6)]

    best = os.path.join(work, "model_best")
    model, cfg_d = api.init_recognizer(best, device="cpu")
    assert cfg_d["decoder"]["num_classes"] == 6 and not model.training
    jm, jvars, _ = japi.init_recognizer(best)
    clip = np.random.default_rng(2).standard_normal(
        (2, 4, 16, 16, 3)).astype(np.float32)
    want = jm.apply(jvars, jnp.asarray(clip), method="forward_test")
    with torch.no_grad():
        got = model.forward_test(torch.from_numpy(clip))
    assert np.abs(to_np(got) - np.asarray(want)).max() <= 1e-5

    history2 = tct.main([cfg, "--work_dir", work, "--resume",
                         "--total_epochs", "7", "--device", "cpu"])
    assert [h["epoch"] for h in history2] == [6]
    capsys.readouterr()


def test_jax_epoch_state_resumes_in_the_port_cli(tmp_path, capsys):
    """The JAX CLI trains 2 epochs; its epoch_1 resumes in the JAX CLI and
    in the port's for epoch 2, with the same loss and seq_mAP."""
    cfg = write_fixture(tmp_path)
    first = str(tmp_path / "first")
    jct.main([cfg, "--work_dir", first, "--total_epochs", "2"])
    runs = {}
    for name, main, extra in (("jax", jct.main, []),
                              ("port", tct.main, ["--device", "cpu"])):
        work = str(tmp_path / name)
        os.makedirs(work)
        shutil.copytree(os.path.join(first, "epoch_1"),
                        os.path.join(work, "epoch_1"))
        runs[name] = main([cfg, "--work_dir", work, "--resume",
                           "--total_epochs", "4"] + extra)
    assert [h["epoch"] for h in runs["port"]] == [2, 3]
    assert [h["epoch"] for h in runs["jax"]] == [2, 3]
    j, t = runs["jax"][0], runs["port"][0]
    assert abs(t["loss"] - j["loss"]) <= STEP_TOL * abs(j["loss"])
    assert abs(runs["port"][1]["seq_mAP"] - runs["jax"][1]["seq_mAP"]) \
        <= 1e-5
    capsys.readouterr()


# -- what the port refuses ----------------------------------------------------------

MVIT_CAPTION = """
model = dict(
    backbone=dict(type='MViT', embed_dim=8, depths=[1, 1],
                  num_heads=[1, 2], patch_size=[2, 4, 4]),
    decoder=dict(num_classes=6, in_channels=16, max_len=3,
                 input_dropout_p=0.0))
"""


def test_mvit_caption_train_matches_jax(tmp_path, capsys):
    """seq_generate/mvit_relseq.py's model at a small size (MViT into the
    RNN decoder, trained by make_seq_train_step): the JAX CLI trains one
    epoch; its epoch_0 resumes in the JAX CLI and in the port's for epoch
    1, with the same loss (STEP_TOL relative) and seq_mAP (1e-5)."""
    cfg = write_fixture(tmp_path, body_extra=MVIT_CAPTION)
    first = str(tmp_path / "first")
    jct.main([cfg, "--work_dir", first, "--total_epochs", "1"])
    runs = {}
    for name, main, extra in (("jax", jct.main, []),
                              ("port", tct.main, ["--device", "cpu"])):
        work = str(tmp_path / name)
        os.makedirs(work)
        shutil.copytree(os.path.join(first, "epoch_0"),
                        os.path.join(work, "epoch_0"))
        runs[name] = main([cfg, "--work_dir", work, "--resume",
                           "--total_epochs", "2"] + extra)
    j, t = runs["jax"][0], runs["port"][0]
    assert j["epoch"] == t["epoch"] == 1
    assert abs(t["loss"] - j["loss"]) <= STEP_TOL * abs(j["loss"])
    assert abs(t["seq_mAP"] - j["seq_mAP"]) <= 1e-5
    capsys.readouterr()


def test_other_caption_backbones_raise(tmp_path):
    """'CLIP' and 'VideoCLIP' are recognizers, not caption backbones: both
    packages' CLIs raise "unknown backbone type" (the CNNs and
    transformers train: tests/test_torch_recognition_cli.py,
    test_torch_recognizer2d_cli.py, test_torch_transformer_cli.py)."""
    for btype in ("CLIP", "VideoCLIP"):
        cfg = write_fixture(tmp_path, body_extra=(
            f"model = dict(backbone=dict(type='{btype}'), "
            f"decoder=dict(num_classes=6, in_channels=16, max_len=3))"))
        with pytest.raises(ValueError, match="unknown backbone type"):
            tct.main([cfg, "--work_dir", str(tmp_path / "w"),
                      "--device", "cpu"])
        with pytest.raises(ValueError, match="unknown backbone type"):
            jct.main([cfg, "--work_dir", str(tmp_path / "wj")])


@pytest.mark.parametrize("name", ["make_seq_train_step_stats",
                                  "make_cls_train_step_stats"])
def test_slice5_steps_raise(name):
    with pytest.raises(NotImplementedError, match="item 8"):
        getattr(trt, name)(None, None)


def test_train_steps_refuse_a_model_on_another_device():
    _, _, tm = _pair(BACKBONES["divided"])
    with pytest.raises(ValueError, match="device='cpu'"):
        trt.make_seq_train_step(tm, device="meta")
    with pytest.raises(NotImplementedError, match="item 8"):
        trt.make_cls_train_step(tm, device="cpu")


def test_training_init_follows_flax_init_schemes():
    """init_state_dict draws what the JAX modules' init draws: per leaf the
    same zeros and ones, and the same spread (within 15% where a leaf has
    500 elements or more)."""
    cfg = dict(BACKBONES["divided"], embed_dims=64, num_heads=4)
    dec = dict(DEC, in_channels=64)
    jm = jrec.Recognizer3DRelseq(jts.TimeSformerConfig(**cfg),
                                 jdec.RNNDecoderConfig(**dec))
    jvars = jm.init(jax.random.key(3), jnp.zeros((1, 4, 16, 16, 3)),
                    jnp.zeros((1, 3, 5)), mode="train")
    tcfg = tts.TimeSformerConfig(**cfg)
    want = recognizer_state_dict_from_jax(jax.tree.map(np.asarray, jvars),
                                          tcfg)
    got = trec.init_state_dict(tcfg, 0, decoder_cfg=RNNDecoderConfig(**dec))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == torch.float32, name
        if float(w.std()) == 0.0:
            assert torch.equal(g, w), name
        elif w.numel() >= 500:
            assert abs(float(g.std()) / float(w.std()) - 1.0) < 0.15, name
        else:
            assert float(g.std()) > 0.0, name
    hh = got["cls_head.rnn.weight_hh_l0"]
    torch.testing.assert_close(hh.T @ hh, torch.eye(64), atol=1e-5, rtol=0)
    assert dataclasses.asdict(tcfg)["remat"] is False

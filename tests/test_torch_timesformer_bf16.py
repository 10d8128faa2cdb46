"""A TimeSformer configured with dtype='bfloat16' on f32 masters (the
JAX package's init and training without bf16=True) in the port against
the JAX package, on the CPU at a small size (4 frames of 16², patch 8,
width 32, 2 heads, 2 layers; the JAX flash kernel in interpret mode).

* The logits of a Recognizer3D within 1e-5, divided and joint with
  flash: the videos and the three embeddings rounded to bf16, f32 from
  the patch embedding on, in both packages.
* One `make_cls_train_step` and one `make_seq_train_step` from the same
  state (SGD without the clip, so each parameter's update is its own):
  the loss within 1e-5 relative, gradients and parameters within 1e-5 of
  their tensor's largest, but for `cls_token`: its bf16 copy is
  broadcast over the B·T frames, and the gradient sums their bf16
  cotangents, which XLA's CPU reduction accumulates in bf16 and torch in
  f32 (one bf16 step apart here, 2e-3 to 4e-3 of the largest): held to
  1e-2.
* `bf16=True` on an f32-configured backbone computes in f32 on the
  bf16-rounded masters and videos, as JAX does: loss within 1e-5
  relative, each gradient's cosine to JAX's >= 0.9999 (the gradients
  pass through the bf16 copy, so an f32 difference may flip one
  rounding).
* The serving path: `api.init_recognizer` casts the whole model to bf16;
  a trainer refuses such a model; a bf16-configured JAX train state
  loads into f32 masters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.models import decoder_head as jdec
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu.train import resume as jres
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.convert import (
    recognizer_state_dict_from_jax)
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from cross_modal_video_engine_tpu_torch.train import resume as tres
from torch_parity import (TRAIN_STEP_TOL, capturing, interpret_pallas,
                          load_jax_state, max_rel, min_cosine,
                          random_variables, to_np)

SMALL = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
             num_heads=2, num_layers=2, drop_path_max=0.0)
BACKBONES = {
    "divided": dict(SMALL, attention_type="divided_space_time",
                    dtype="bfloat16"),
    "joint+flash": dict(SMALL, attention_type="joint_space_time",
                        use_flash_attention=True, dtype="bfloat16"),
}
DEC = dict(num_classes=5, in_channels=32, max_len=3, input_dropout_p=0.0)
SGD = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
           weight_decay=1e-2, grad_clip=0.0)
BROADCAST = {"backbone.cls_token": 1e-2}
CLASSES, BATCH = 6, 4
LOGIT_TOL, LOSS_REL, GRAD_COS = 1e-5, 1e-5, 0.9999


@pytest.fixture(autouse=True, scope="module")
def _interpret():
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _videos(seed=0, n=BATCH):
    return np.random.default_rng(300 + seed).standard_normal(
        (n, 4, 16, 16, 3)).astype(np.float32)


def _cls_pair(backbone, seed=13):
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**backbone),
                           num_classes=CLASSES)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3))), seed)
    cfg = tts.TimeSformerConfig(**backbone)
    tm = trec.Recognizer3D(cfg, CLASSES, device="cpu")
    tm.load_state_dict(recognizer_state_dict_from_jax(variables, cfg))
    return jm, variables, tm


def _seq_pair(backbone, seed=17):
    jm = jrec.Recognizer3DRelseq(jts.TimeSformerConfig(**backbone),
                                 jdec.RNNDecoderConfig(**DEC))
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3))), seed)
    cfg = tts.TimeSformerConfig(**backbone)
    tm = trec.Recognizer3DRelseq(cfg, RNNDecoderConfig(**DEC), device="cpu")
    tm.load_state_dict(recognizer_state_dict_from_jax(variables, cfg))
    return jm, variables, tm


def _check(tm, jstate, tlogs, jlogs):
    jloss = float(jlogs["loss"])
    assert abs(float(tlogs["loss"]) - jloss) <= LOSS_REL * abs(jloss)
    cfg = tm.backbone.cfg
    jgrads = recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.opt_state[0])}, cfg)
    jparams = recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.params)}, cfg)
    for name, p in tm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        tol = BROADCAST.get(name, TRAIN_STEP_TOL)
        assert max_rel(to_np(p.grad), jgrads[name]) <= tol, name
        assert max_rel(to_np(p.detach()), jparams[name]) <= tol, name


def _jax_state(variables, tx):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jrt.RecTrainState(params, tx.init(params),
                             jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_f32_masters_logits_match_jax(backbone):
    jm, variables, tm = _cls_pair(BACKBONES[backbone])
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    v = _videos()
    want = np.asarray(jm.apply(variables, jnp.asarray(v)))
    with torch.no_grad():
        got = tm(torch.from_numpy(v))
        tokens = tm.backbone.embed_tokens(torch.from_numpy(v))
    assert got.dtype == tokens.dtype == torch.float32
    assert np.abs(to_np(got) - want).max() <= LOGIT_TOL
    # the bf16 rounding of the input shows: the f32 config differs
    f32 = trec.Recognizer3D(tts.TimeSformerConfig(
        **dict(BACKBONES[backbone], dtype="float32")), CLASSES, device="cpu")
    f32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        assert np.abs(to_np(f32(torch.from_numpy(v))) - want).max() > 1e-4


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_cls_step_matches_jax(backbone):
    jm, variables, tm = _cls_pair(BACKBONES[backbone])
    jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**SGD)))
    jstate = _jax_state(variables, jtx)
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**SGD)))
    tstate = load_jax_state(tstate, jstate, "sgd", False)
    v = _videos(1)
    lab = np.arange(BATCH) % CLASSES
    jstate, jlogs = jrt.make_cls_train_step(jm, jtx)(
        jstate, jnp.asarray(v), jnp.asarray(lab, jnp.int32),
        jax.random.key(0))
    tstate, tlogs = trt.make_cls_train_step(tm, device="cpu")(
        tstate, torch.from_numpy(v), torch.from_numpy(lab))
    _check(tm, jstate, tlogs, jlogs)
    assert float(tlogs["top1_acc"]) == float(jlogs["top1_acc"])


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_seq_step_matches_jax(backbone):
    jm, variables, tm = _seq_pair(BACKBONES[backbone])
    jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**SGD)))
    jstate = _jax_state(variables, jtx)
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**SGD)))
    tstate = load_jax_state(tstate, jstate, "sgd", False)
    rng = np.random.default_rng(5)
    v = _videos(2)
    targets = (rng.random((BATCH, 3, 5)) > 0.6).astype(np.float32)
    mask = np.ones((BATCH, 3), np.float32)
    jstate, jlogs = jrt.make_seq_train_step(jm, jtx)(
        jstate, jnp.asarray(v), jnp.asarray(targets), jnp.asarray(mask),
        jax.random.key(0))
    tstate, tlogs = trt.make_seq_train_step(tm, device="cpu")(
        tstate, torch.from_numpy(v), torch.from_numpy(targets),
        torch.from_numpy(mask))
    _check(tm, jstate, tlogs, jlogs)


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_bf16_step_on_an_f32_config_computes_in_f32(backbone):
    """JAX's bf16=True casts the masters and videos to bf16, and an
    f32-configured TimeSformer's embed_tokens casts the videos back to
    f32: f32 products on bf16-rounded values.  The port does the same."""
    bb = dict(BACKBONES[backbone], dtype="float32")
    jm, variables, tm = _cls_pair(bb)
    jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**SGD)))
    jstate = _jax_state(variables, jtx)
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**SGD)))
    v = _videos(3)
    lab = np.arange(BATCH) % CLASSES
    jstate, jlogs = jrt.make_cls_train_step(jm, jtx, bf16=True)(
        jstate, jnp.asarray(v), jnp.asarray(lab, jnp.int32),
        jax.random.key(0))
    tstate, tlogs = trt.make_cls_train_step(tm, bf16=True, device="cpu")(
        tstate, torch.from_numpy(v), torch.from_numpy(lab))
    jloss = float(jlogs["loss"])
    assert abs(float(tlogs["loss"]) - jloss) <= LOSS_REL * abs(jloss)
    jgrads = recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.opt_state[0])},
        tm.backbone.cfg)
    for name, p in tm.named_parameters():
        g = to_np(p.grad).reshape(1, -1)
        if np.abs(g).max() == 0:
            assert np.abs(jgrads[name].numpy()).max() == 0, name
            continue
        assert min_cosine(g, jgrads[name].numpy().reshape(1, -1)) \
            >= GRAD_COS, name


def test_serving_cast_and_training_refusal():
    """init_recognizer casts a bf16-configured model whole (parameters
    and head in bf16, the JAX loader's maybe_cast_bf16), and the trainers
    refuse such a model: they keep f32 masters."""
    jm, variables, tm = _cls_pair(BACKBONES["divided"])
    cfg_d = {"backbone": BACKBONES["divided"], "num_classes": CLASSES}
    model, _ = api.init_recognizer(cfg_d, tm.state_dict(), device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    v = _videos(4)
    with torch.no_grad():
        got = model(torch.from_numpy(v))
    want = np.asarray(jm.apply(jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16), variables), jnp.asarray(v)))
    assert min_cosine(to_np(got), want) >= 0.999
    with pytest.raises(ValueError, match="float32 masters"):
        trt.make_cls_train_step(model.requires_grad_(True), device="cpu")


def test_bf16_configured_jax_train_state_loads_into_f32_masters(tmp_path):
    jm, variables, tm = _cls_pair(BACKBONES["joint+flash"], seed=21)
    tx = jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**SGD))
    jstate = _jax_state(variables, tx)
    jres.save_train_state(str(tmp_path / "epoch_0"),
                          {"state": jstate, "batch_stats": None},
                          {"epoch": 0})
    fresh = trec.Recognizer3D(tts.TimeSformerConfig(
        **BACKBONES["joint+flash"]), CLASSES, device="cpu")
    state = trt.init_rec_state(fresh, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**SGD)))
    payload, loop = tres.load_train_state(str(tmp_path / "epoch_0"),
                                          {"state": state,
                                           "batch_stats": None})
    assert loop == {"epoch": 0}
    want = recognizer_state_dict_from_jax(variables, fresh.backbone.cfg)
    for name, p in payload["state"].model.named_parameters():
        assert p.dtype == torch.float32, name
        assert torch.equal(p.detach(), want[name]), name

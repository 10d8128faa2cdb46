"""The port's recognizers, caption head and API (models/recognizer.py,
models/decoder_head.py, api.py, utils/precision.py) against the JAX
package's on the same weights: random JAX variables go through
convert/from_jax.py into the port.  The JAX flash kernel runs in
interpret mode, the port's flash attention its plain version.

Tolerances: f32 1e-4 absolute on scores and probabilities.  The greedy
caption decode thresholds each step's probabilities at 0.5 and feeds the
result back, so the seeds below are ones where no probability lies
within 1e-3 of the threshold (asserted), where a 1e-4 difference could
not flip a label.  bf16 (after the inference cast): backbone features
by cosine >= 0.999, step-0 probabilities within 2e-2."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.models import decoder_head as jdec
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.utils.precision import (
    maybe_cast_bf16 as jax_maybe_cast_bf16)
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.convert import (
    recognizer_state_dict_from_jax)
from cross_modal_video_engine_tpu_torch.models import decoder_head as tdec
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.utils.precision import (
    cast_inference_state_dict, maybe_cast_bf16)
from torch_parity import interpret_pallas, min_cosine, random_variables, to_np

SMALL = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
             num_heads=2, num_layers=2)
JOINT_FLASH = dict(SMALL, attention_type="joint_space_time",
                   use_flash_attention=True)
DIVIDED = dict(SMALL, attention_type="divided_space_time")
DECODER = dict(num_classes=7, in_channels=32, max_len=4, threshold=0.5)
THRESHOLD_MARGIN = 1e-3


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


def _videos(n, seed=13):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 4, 16, 16, 3)).astype(np.float32)


def _relseq(backbone, seed):
    """JAX Recognizer3DRelseq, its random variables, the port's state
    dict of the same weights."""
    jm = jrec.Recognizer3DRelseq(jts.TimeSformerConfig(**backbone),
                                 jdec.RNNDecoderConfig(**DECODER))
    variables = random_variables(
        jm.init(jax.random.key(0), jnp.asarray(_videos(2))), seed)
    sd = recognizer_state_dict_from_jax(
        variables, tts.TimeSformerConfig(**backbone))
    return jm, variables, sd


def _port_relseq(backbone, sd, dtype="float32"):
    tm = trec.Recognizer3DRelseq(
        tts.TimeSformerConfig(**backbone, dtype=dtype),
        tdec.RNNDecoderConfig(**DECODER), device="cpu")
    tm.load_state_dict(sd)
    return tm


@pytest.fixture(scope="module")
def classifier():
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**JOINT_FLASH),
                           num_classes=6)
    variables = random_variables(
        jm.init(jax.random.key(0), jnp.asarray(_videos(2))), 31)
    tm = trec.Recognizer3D(tts.TimeSformerConfig(**JOINT_FLASH),
                           num_classes=6, device="cpu")
    tm.load_state_dict(recognizer_state_dict_from_jax(
        variables, tm.backbone.cfg))
    return jm, variables, tm


@pytest.mark.parametrize("average_clips", ["prob", "score", None])
def test_recognizer3d_forward_test_matches_jax(classifier, average_clips):
    """4 clips as 2 videos x 2 clips (num_segs=2)."""
    jm, variables, tm = classifier
    v = _videos(4)
    want = jm.apply(variables, jnp.asarray(v), num_segs=2,
                    average_clips=average_clips, method="forward_test")
    with torch.no_grad():
        got = tm.forward_test(torch.from_numpy(v), num_segs=2,
                              average_clips=average_clips)
    assert got.shape == np.shape(want)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_capture_and_score_from_layer_match_jax(classifier):
    jm, variables, tm = classifier
    v = _videos(2)
    want, want_cap = jm.apply(variables, jnp.asarray(v), [0],
                              method="forward_with_capture")
    with torch.no_grad():
        got, got_cap = tm.forward_with_capture(torch.from_numpy(v), [0])
        again = tm.score_from_layer(got_cap[0], 0)
    want_again = jm.apply(variables, jnp.asarray(to_np(got_cap[0])), 0,
                          method="score_from_layer")
    for g, w in ((got, want), (got_cap[0], want_cap[0]),
                 (again, want_again)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=0,
                                   atol=1e-4)
    np.testing.assert_allclose(to_np(again), to_np(got), rtol=0, atol=1e-5)


@pytest.mark.parametrize("backbone,seed", [(DIVIDED, 57),
                                           (JOINT_FLASH, 42)],
                         ids=["divided", "joint+flash"])
def test_relseq_greedy_decode_matches_jax(backbone, seed):
    jm, variables, sd = _relseq(backbone, seed)
    tm = _port_relseq(backbone, sd)
    v = _videos(4)
    want = np.asarray(jm.apply(variables, jnp.asarray(v), num_segs=2,
                               method="forward_test"))
    per_clip = np.asarray(jm.apply(variables, jnp.asarray(v)))
    assert np.abs(per_clip - 0.5).min() > THRESHOLD_MARGIN
    with torch.no_grad():
        got = tm.forward_test(torch.from_numpy(v), num_segs=2)
    assert got.shape == (2, DECODER["max_len"], DECODER["num_classes"])
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=1e-4)


def test_decoder_head_modes_match_jax():
    """Teacher forcing (train mode) and greedy feedback on one head, and
    decode_greedy's labels."""
    cfg = jdec.RNNDecoderConfig(**DECODER)
    head = jdec.RNNDecoderHead(cfg)
    rng = np.random.default_rng(51)
    enc = rng.standard_normal((3, 32)).astype(np.float32)
    tgt = (rng.random((3, 4, 7)) > 0.5).astype(np.float32)
    variables = random_variables(head.init(
        jax.random.key(0), jnp.asarray(enc), jnp.asarray(tgt)), 53)
    th = tdec.RNNDecoderHead(tdec.RNNDecoderConfig(**DECODER))
    p = variables["params"]
    named = {"start_emb.weight": p["start_emb"],
             "rnn.weight_ih_l0": p["rnn_wi"].T, "rnn.bias_ih_l0": p["rnn_bi"],
             "rnn.weight_hh_l0": p["rnn_wh"].T, "rnn.bias_hh_l0": p["rnn_bh"],
             "out.weight": p["out_kernel"].T, "out.bias": p["out_bias"]}
    th.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a))
                        for k, a in named.items()})
    e, t = torch.from_numpy(enc), torch.from_numpy(tgt)
    with torch.no_grad():
        got_train = th(e, t, mode="train")
        got_inf = th(e, mode="inference")
        labels = th.decode_greedy(e)
    want_train = head.apply(variables, jnp.asarray(enc), jnp.asarray(tgt),
                            mode="train")
    want_inf = head.apply(variables, jnp.asarray(enc), mode="inference")
    assert np.abs(np.asarray(want_inf) - 0.5).min() > THRESHOLD_MARGIN
    want_labels = head.apply(variables, jnp.asarray(enc),
                             method="decode_greedy")
    np.testing.assert_allclose(to_np(got_train), np.asarray(want_train),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_np(got_inf), np.asarray(want_inf),
                               rtol=0, atol=1e-4)
    assert labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    with pytest.raises(ValueError, match="targets_emb"):
        th(e, mode="train")


def test_decoder_head_input_dropout_in_train_mode():
    """input_dropout_p acts in train mode only: eval mode (and p = 0 in
    train mode) give the dropout-free result and draw nothing; train mode
    with p > 0 differs from it, repeats under one generator seed, and
    leaves the global RNG alone when given a generator."""
    rng = np.random.default_rng(61)
    enc = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    tgt = torch.from_numpy((rng.random((3, 4, 7)) > 0.5).astype(np.float32))
    cfg = tdec.RNNDecoderConfig(**dict(DECODER, input_dropout_p=0.5))
    th = tdec.RNNDecoderHead(cfg)
    g = torch.Generator().manual_seed(62)
    for prm in th.parameters():
        with torch.no_grad():
            prm.copy_(torch.randn(prm.shape, generator=g))
    th0 = tdec.RNNDecoderHead(tdec.RNNDecoderConfig(
        **dict(DECODER, input_dropout_p=0.0)))
    th0.load_state_dict(th.state_dict())
    state = torch.random.get_rng_state()     # construction draws; calls don't
    with torch.no_grad():
        ref = th.eval()(enc, tgt, mode="train")
        torch.testing.assert_close(th0.train()(enc, tgt, mode="train"), ref,
                                   rtol=0, atol=0)
        th.train()
        th.generator = torch.Generator().manual_seed(63)
        a = th(enc, tgt, mode="train")
        th.generator = torch.Generator().manual_seed(63)
        b = th(enc, tgt, mode="train")
    assert torch.equal(torch.random.get_rng_state(), state)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - ref).abs().max() > 1e-3


def test_init_recognizer_bf16_cast_matches_jax():
    """A bf16 caption config: the port's init_recognizer casts and loads,
    the JAX side runs its maybe_cast_bf16 tree, and both compute bf16."""
    jm, variables, sd = _relseq(JOINT_FLASH, 61)
    cfg_d = {"backbone": dict(JOINT_FLASH, dtype="bfloat16"),
             "decoder": dict(DECODER)}
    model, got_cfg = api.init_recognizer(cfg_d, sd, device="cpu")
    assert got_cfg is cfg_d and not model.training
    assert isinstance(model, trec.Recognizer3DRelseq)
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and not p.requires_grad, name
    jmb = jrec.Recognizer3DRelseq(
        jts.TimeSformerConfig(**cfg_d["backbone"]),
        jdec.RNNDecoderConfig(**DECODER))
    jvars = jax_maybe_cast_bf16(variables, cfg_d)
    v = _videos(2)
    want_feat = jmb.apply(jvars, jnp.asarray(v), method="extract_feat")
    want = np.asarray(jmb.apply(jvars, jnp.asarray(v)))
    with torch.no_grad():
        got_feat = model.extract_feat(torch.from_numpy(v))
    steps, got = api.caption_clips(model, torch.from_numpy(v), num_segs=1)
    assert min_cosine(to_np(got_feat), want_feat) >= 0.999
    np.testing.assert_allclose(to_np(got[:, 0]), want[:, 0], rtol=0,
                               atol=2e-2)
    assert len(steps) == 2 and len(steps[0]) == DECODER["max_len"]


def test_init_recognizer_classifier_f32(classifier):
    jm, variables, tm = classifier
    cfg_d = {"backbone": dict(JOINT_FLASH, type="TimeSformer"),
             "num_classes": 6}
    model, _ = api.init_recognizer(cfg_d, tm.state_dict(), device="cpu")
    assert isinstance(model, trec.Recognizer3D)
    assert model.cls_head.fc_cls.weight.dtype == torch.float32
    v = _videos(2)
    with torch.no_grad():
        got = model(torch.from_numpy(v))
    np.testing.assert_allclose(to_np(got),
                               np.asarray(jm.apply(variables, jnp.asarray(v))),
                               rtol=0, atol=1e-4)
    # 'CLIP' is a recognizer, no caption backbone (as in the JAX CLI)
    with pytest.raises(ValueError, match="unknown backbone type CLIP"):
        api.init_recognizer({"backbone": {"type": "CLIP"},
                             "decoder": DECODER}, {}, device="cpu")


def test_caption_clips_matches_caption_video():
    """caption_video's model half: all clips are one video, probabilities
    averaged over them, labels where they pass the threshold."""
    jm, variables, sd = _relseq(DIVIDED, 47)
    cfg_d = {"backbone": DIVIDED, "decoder": DECODER}
    model, _ = api.init_recognizer(cfg_d, sd, device="cpu")
    v = _videos(3)
    want = np.asarray(jm.apply(variables, jnp.asarray(v), num_segs=3,
                               method="forward_test"))[0]
    want_steps = [list(np.nonzero(p > 0.5)[0]) for p in want]
    steps, probs = api.caption_clips(model, torch.from_numpy(v))
    assert probs.shape == (1, DECODER["max_len"], DECODER["num_classes"])
    np.testing.assert_allclose(to_np(probs[0]), want, rtol=0, atol=1e-4)
    assert np.abs(want - 0.5).min() > THRESHOLD_MARGIN
    assert steps[0] == [[int(i) for i in s] for s in want_steps]


def test_precision_rule():
    sd = {"w": torch.ones(2), "n": torch.arange(3)}
    out = maybe_cast_bf16(sd, {"backbone": {"dtype": "bfloat16"}})
    assert out["w"].dtype == torch.bfloat16 and out["n"].dtype == torch.int64
    assert maybe_cast_bf16(sd, {"backbone": {"dtype": "float32"}}) is sd
    assert maybe_cast_bf16(sd, {}) is sd
    assert cast_inference_state_dict(sd, torch.float32) is sd


def test_random_state_dict_takes_one_head():
    cfg = tts.TimeSformerConfig(**SMALL)
    with pytest.raises(ValueError):
        trec.random_state_dict(cfg, 0)
    with pytest.raises(ValueError):
        trec.random_state_dict(cfg, 0, num_classes=3,
                               decoder_cfg=tdec.RNNDecoderConfig())


def test_port_modules_import_no_jax():
    code = ("import sys, cross_modal_video_engine_tpu_torch.api, "
            "cross_modal_video_engine_tpu_torch.models, "
            "cross_modal_video_engine_tpu_torch.ops.flash_attention, "
            "cross_modal_video_engine_tpu_torch.convert; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules; "
            "assert 'cross_modal_video_engine_tpu' not in sys.modules")
    root = __file__.rsplit("/tests/", 1)[0]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)

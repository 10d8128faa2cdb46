"""The port's word-level caption transformer and Recognizer3DCaption against
the JAX package's, on the CPU at the JAX test's size (vocab 40, width 32,
4 heads, 2 layers, max_len 6, encoder width 16).  Weights are drawn with
numpy (models/caption_transformer.random_state_dict) and handed to JAX
through convert's caption pair; the same numpy inputs go through both.

Tolerances: teacher-forcing logits within 1e-5; greedy and beam ids equal
and their log-probabilities within 1e-4.  Recognizer3DCaption runs on a
2-layer joint TimeSformer with flash attention (weights from the port's
seeded state dicts, handed to JAX through the converters): the JAX flash
kernel in interpret mode, the port's plain version on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.models import caption_transformer as jct
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu_torch.convert import (
    caption_transformer_state_dict_from_jax,
    caption_transformer_variables_to_jax,
    recognizer_caption_state_dict_from_jax,
    recognizer_caption_variables_to_jax)
from cross_modal_video_engine_tpu_torch.models import caption_transformer as tct
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.utils.registry import RECOGNIZERS
from torch_parity import interpret_pallas

KW = dict(vocab_size=40, d_model=32, heads=4, layers=2, max_len=6,
          enc_dim=16, bos_id=1, eos_id=2)
LOGIT_TOL, LOGP_TOL = 1e-5, 1e-4
BACKBONE = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
                num_heads=2, num_layers=2, drop_path_max=0.0,
                attention_type="joint_space_time", use_flash_attention=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread, and torch's global RNG and thread count left as
    found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _pair(seed, **over):
    cfg = dict(KW, **over)
    tm = tct.CaptionTransformer(tct.CaptionConfig(**cfg), device="cpu")
    tm.load_state_dict(tct.random_state_dict(tm.cfg, seed))
    jm = jct.CaptionTransformer(jct.CaptionConfig(**cfg))
    variables = _jnp(caption_transformer_variables_to_jax(tm.state_dict()))
    return jm, variables, tm.requires_grad_(False)


def _jnp(tree):
    """jnp leaves: the JAX decode indexes its parameters with traced
    ids."""
    return jax.tree.map(jnp.asarray, tree)


def _enc(seed, b=3, le=5, width=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, le, width)).astype(np.float32)


def test_converters_round_trip():
    _, variables, tm = _pair(0)
    back = caption_transformer_state_dict_from_jax(
        jax.tree.map(np.asarray, variables))
    assert back.keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("seed", [1, 2])
def test_teacher_forcing_logits_match_jax(seed):
    jm, variables, tm = _pair(seed)
    enc = _enc(seed)
    ids = np.random.default_rng(seed).integers(3, 40, (3, 6))
    want = np.asarray(jm.apply(variables, jnp.asarray(enc),
                               jnp.asarray(ids, jnp.int32), mode="train"))
    got = tm(torch.from_numpy(enc), torch.from_numpy(ids), mode="train")
    assert got.shape == (3, 6, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("mode,width,seed", [("greedy", 1, 3),
                                              ("beam", 2, 4),
                                              ("beam", 4, 5),
                                              ("beam", 4, 6)])
def test_decode_matches_jax(mode, width, seed):
    jm, variables, tm = _pair(seed)
    enc = _enc(seed)
    want_ids, want_lp = jm.apply(variables, jnp.asarray(enc), None,
                                 mode=mode, beam_width=width)
    got_ids, got_lp = tm(torch.from_numpy(enc), None, mode=mode,
                         beam_width=width)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0,
                               atol=LOGP_TOL)


def test_beam_finishes_with_eos_at_no_cost():
    """An EOS-heavy output layer: beams finish early, extend only with
    EOS at no cost, and the port keeps JAX's ids and scores."""
    jm, variables, tm = _pair(7)
    with torch.no_grad():
        tm.lnf_b.fill_(0.3)
        tm.out[:, KW["eos_id"]] += 0.03
    variables = _jnp(caption_transformer_variables_to_jax(tm.state_dict()))
    enc = _enc(7)
    want_ids, want_lp = jm.apply(variables, jnp.asarray(enc), None,
                                 mode="beam", beam_width=3)
    got_ids, got_lp = tm(torch.from_numpy(enc), None, mode="beam",
                         beam_width=3)
    finished = (got_ids.numpy() == KW["eos_id"]).all(1)
    assert finished.any() and not finished.all()
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0,
                               atol=LOGP_TOL)


def test_top_k_breaks_ties_by_the_lower_index():
    x = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0]])
    vals, idx = tct._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def recognizer():
    """The port's Recognizer3DCaption from seeded weights (backbone:
    models/recognizer.random_state_dict; head: random_state_dict), the
    same weights in JAX through the caption converters, and JAX's logits,
    greedy and beam outputs."""
    ccfg = dict(KW, enc_dim=BACKBONE["embed_dims"])
    bcfg = tts.TimeSformerConfig(**BACKBONE)
    tm = RECOGNIZERS.get("Recognizer3DCaption")(
        bcfg, tct.CaptionConfig(**ccfg), device="cpu")
    sd = {k: v for k, v in trec.random_state_dict(
        bcfg, 19, num_classes=1).items() if k.startswith("backbone.")}
    sd.update({f"caption_head.{k}": v for k, v in tct.random_state_dict(
        tm.caption_head.cfg, 20).items()})
    tm.load_state_dict(sd)
    variables = _jnp(recognizer_caption_variables_to_jax(sd, bcfg))
    jm = jrec.Recognizer3DCaption(jts.TimeSformerConfig(**BACKBONE),
                                  jct.CaptionConfig(**ccfg))
    videos = np.random.default_rng(17).standard_normal(
        (2, 4, 16, 16, 3)).astype(np.float32)
    ids = np.random.default_rng(18).integers(3, 40, (2, 6))
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        want = {"train": np.asarray(jm.apply(variables, jnp.asarray(videos),
                                             jnp.asarray(ids, jnp.int32)))}
        for mode, width in (("greedy", 1), ("beam", 3)):
            out = jm.apply(variables, jnp.asarray(videos), mode=mode,
                           beam_width=width,
                           method=jrec.Recognizer3DCaption.generate)
            want[mode] = tuple(np.asarray(o) for o in out)
    return sd, tm.requires_grad_(False), videos, ids, want


def test_recognizer_caption_matches_jax(recognizer):
    _, tm, videos, ids, want = recognizer
    got = tm(torch.from_numpy(videos), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want["train"], rtol=0,
                               atol=LOGIT_TOL)
    for mode, width in (("greedy", 1), ("beam", 3)):
        g_ids, g_lp = tm.generate(torch.from_numpy(videos), mode, width)
        np.testing.assert_array_equal(g_ids.numpy(), want[mode][0])
        np.testing.assert_allclose(g_lp.numpy(), want[mode][1], rtol=0,
                                   atol=LOGP_TOL)


def test_recognizer_caption_variables_round_trip(recognizer):
    sd, tm, *_ = recognizer
    back = recognizer_caption_state_dict_from_jax(
        recognizer_caption_variables_to_jax(sd, tm.backbone.cfg),
        tm.backbone.cfg)
    assert back.keys() == tm.state_dict().keys()
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v), k

"""Mixup and cutmix (data/blending.py) and the blended classification
steps of the port against the JAX package's, on the CPU, with the random
draws (lam, the permutation, the box's centre) handed to both:
`jax.random.beta`, `permutation` and `randint` patched in the test, the
port given the same draws.

* The blends alone: f32 clips and soft labels within 1e-6; bf16 clips
  within one bf16 step of the value (XLA may fuse the two products and
  the sum, torch rounds each), soft labels within 1e-6; cutmix's box and
  recomputed lam over boxes clipped at every edge.
* One blended step on a plain model (a TimeSformer Recognizer3D,
  `make_cls_train_step`) and on a BatchNorm model (TSM with its TSNHead,
  `make_cls_train_step_stats`), mixup and cutmix: in f32 the loss within
  1e-5 relative and each gradient within 1e-5 (TimeSformer: of its
  tensor's largest) or 1e-4 (TSM, tests/test_torch_recognizer2d.py's
  bounds); through `bf16=True` (the blend after the bf16 cast of the
  videos) the loss within 2e-2 relative and each gradient's cosine to
  JAX's >= 0.99.  Top-1 is taken against the hard labels in both.
* The config key: an unknown blending is refused, as the JAX registry
  refuses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.data import blending as jbl
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.data import blending as tbl
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from test_torch_recognizer2d import (BATCH, CLASSES, _jax_state,
                                     _optimizers, check_step, clips, labels,
                                     pair)
from torch_parity import max_rel, min_cosine, random_variables, to_np

KINDS = ("MixupBlending", "CutmixBlending")
TS = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
          num_heads=2, num_layers=2, drop_path_max=0.0)
TS_TOL, BF16_LOSS_REL, BF16_COS = 1e-5, 2e-2, 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


@pytest.fixture
def handed(monkeypatch):
    """handed(draws): the JAX package's next beta, permutation and
    randint draws are these."""
    def install(draws):
        centre = [draws.get("cx", 0), draws.get("cy", 0)]
        monkeypatch.setattr(jax.random, "beta", lambda *a, **k: jnp.asarray(
            draws["lam"], jnp.float32))
        monkeypatch.setattr(jax.random, "permutation",
                            lambda *a, **k: jnp.asarray(draws["perm"]))
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(centre.pop(0)))
    return install


def _draws(kind, b, h, w, lam, seed):
    rng = np.random.default_rng(seed)
    d = {"lam": np.float32(lam), "perm": rng.permutation(b)}
    if kind == "CutmixBlending":
        d["cx"], d["cy"] = int(rng.integers(0, w)), int(rng.integers(0, h))
    return d


DRAW_CASES = [(0.13, 0), (0.5, 1), (0.87, 2), (0.999, 3), (0.02, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_blend_matches_jax(kind, dtype, handed):
    b, h, w = 5, 12, 20
    rng = np.random.default_rng(7)
    imgs = rng.standard_normal((b, 3, h, w, 3)).astype(np.float32)
    lab = rng.integers(0, CLASSES, b)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    blend = tbl.make_blending(kind, CLASSES, alpha=0.4)
    for lam, seed in DRAW_CASES:
        d = _draws(kind, b, h, w, lam, seed)
        handed(d)
        jmixed, jsoft = jbl.make_blending(kind, CLASSES, 0.4)(
            jax.random.key(0), jnp.asarray(imgs, jdt), jnp.asarray(lab))
        mixed, soft = blend(torch.from_numpy(imgs).to(tdt),
                            torch.from_numpy(lab), d)
        assert mixed.dtype == tdt and soft.dtype == torch.float32
        want = np.asarray(jmixed, np.float32)
        got = to_np(mixed)
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-6
        else:
            assert np.all(np.abs(got - want)
                          <= 2.0 ** -7 * np.abs(want) + 1e-30)
        assert np.abs(to_np(soft) - np.asarray(jsoft)).max() <= 1e-6
        np.testing.assert_allclose(to_np(soft).sum(-1), 1.0, atol=1e-6)


def test_cutmix_box_clips_at_the_edges():
    """A centre at each corner: the box is clipped and lam recomputed from
    its area."""
    imgs = torch.zeros(2, 1, 6, 10, 1)
    imgs[1] = 1.0
    blend = tbl.make_blending("CutmixBlending", 2)
    lab = torch.tensor([0, 1])
    for cx, cy in ((0, 0), (9, 5), (0, 5), (9, 0)):
        mixed, soft = blend(imgs, lab, {"lam": np.float32(0.36),
                                        "perm": np.array([1, 0]),
                                        "cx": cx, "cy": cy})
        cut_w, cut_h = int(10 * np.float32(0.8)), int(6 * np.float32(0.8))
        x1, x2 = max(cx - cut_w // 2, 0), min(cx + cut_w // 2, 10)
        y1, y2 = max(cy - cut_h // 2, 0), min(cy + cut_h // 2, 6)
        area = (x2 - x1) * (y2 - y1)
        assert float(mixed[0].sum()) == area
        assert float(soft[0, 1]) == pytest.approx(area / 60, abs=1e-6)


def test_draws_come_from_the_blending_generator():
    a = tbl.make_blending("CutmixBlending", 3, alpha=0.2, seed=4)
    b = tbl.make_blending("CutmixBlending", 3, alpha=0.2, seed=4)
    da, db = a.draw(6, 8, 8), b.draw(6, 8, 8)
    assert da["lam"] == db["lam"] and da["lam"].dtype == np.float32
    np.testing.assert_array_equal(da["perm"], db["perm"])
    assert sorted(da["perm"]) == list(range(6))
    a.reseed(5)
    assert a.draw(6, 8, 8)["lam"] != db["lam"]
    with pytest.raises(KeyError, match="available"):
        tbl.make_blending("MosaicBlending", 3)


def _ts_pair(seed=13):
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**TS), num_classes=CLASSES)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3))), seed)
    cfg = tts.TimeSformerConfig(**TS)
    tm = trec.Recognizer3D(cfg, CLASSES, device="cpu")
    tm.load_state_dict(tconv.recognizer_state_dict_from_jax(variables, cfg))
    return jm, variables, tm


def _grads_cos(named, jgrads):
    for name, p in named:
        g = to_np(p.grad).reshape(1, -1)
        if np.abs(g).max() == 0 and np.abs(jgrads[name].numpy()).max() == 0:
            continue
        assert min_cosine(g, jgrads[name].numpy().reshape(1, -1)) \
            >= BF16_COS, name


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_blended_timesformer_step_matches_jax(kind, bf16, handed):
    jm, variables, tm = _ts_pair()
    jtx, ttx = _optimizers()
    x = np.random.default_rng(21).standard_normal(
        (BATCH, 4, 16, 16, 3)).astype(np.float32)
    lab = labels(302)
    d = _draws(kind, BATCH, 16, 16, 0.62, 8)
    handed(d)
    jstate, jlogs = jrt.make_cls_train_step(
        jm, jtx, blending=jbl.make_blending(kind, CLASSES, 0.2), bf16=bf16)(
        _jax_state(variables, jtx), jnp.asarray(x),
        jnp.asarray(lab, jnp.int32), jax.random.key(0))
    tstate, tlogs = trt.make_cls_train_step(
        tm, blending=tbl.make_blending(kind, CLASSES, 0.2), bf16=bf16,
        device="cpu")(trt.init_rec_state(tm, ttx), torch.from_numpy(x),
                      torch.from_numpy(lab), d)
    jloss = float(jlogs["loss"])
    assert float(tlogs["top1_acc"]) == float(jlogs["top1_acc"])
    jgrads = tconv.recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.opt_state[0])},
        tm.backbone.cfg)
    if bf16:
        assert abs(float(tlogs["loss"]) - jloss) <= BF16_LOSS_REL * abs(jloss)
        _grads_cos(tm.named_parameters(), jgrads)
        return
    assert abs(float(tlogs["loss"]) - jloss) <= TS_TOL * abs(jloss)
    for name, p in tm.named_parameters():
        assert max_rel(to_np(p.grad), jgrads[name]) <= TS_TOL, name


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_blended_stats_step_matches_jax(kind, bf16, handed):
    tm, _, jm, variables = pair("tsm", "tsn", dropout=0.0)
    jtx, ttx = _optimizers()
    x, lab = clips("tsm", batch=BATCH, seed=43), labels(303)
    d = _draws(kind, BATCH, x.shape[2], x.shape[3], 0.41, 9)
    handed(d)
    jstate, jstats, jlogs = jrt.make_cls_train_step_stats(
        jm, jtx, blending=jbl.make_blending(kind, CLASSES, 0.2), bf16=bf16)(
        _jax_state(variables, jtx), variables["batch_stats"],
        jnp.asarray(x), jnp.asarray(lab, jnp.int32), jax.random.key(0))
    tstate, tlogs = trt.make_cls_train_step_stats(
        tm, blending=tbl.make_blending(kind, CLASSES, 0.2), bf16=bf16,
        device="cpu")(trt.init_rec_state(tm, ttx), torch.from_numpy(x),
                      torch.from_numpy(lab), d)
    assert float(tlogs["top1_acc"]) == float(jlogs["top1_acc"])
    if bf16:
        jloss = float(jlogs["loss"])
        assert abs(float(tlogs["loss"]) - jloss) <= BF16_LOSS_REL * abs(jloss)
        return
    check_step(tm, jstate, jstats, tlogs, jlogs)

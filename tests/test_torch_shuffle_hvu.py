"""The shuffle recognizers (models/recognizer.py, losses/shuffle.py) and
the HVU loss (losses/hvu.py) of the port against the JAX package's, on
the CPU at a small size (4 frames of 16², patch 8, width 32, 2 heads,
2 layers, 6 classes; the joint model's flash kernel interpreted in JAX).

* `forward_train(videos, shuffle_videos, labels)` of
  Recognizer3DShuffleEmb, Soft and Extra: each loss term within 1e-5
  relative, each gradient within 1e-5 of its tensor's largest; Extra
  labels the shuffled clips num_classes - 1; their state dicts carry the
  Recognizer3D's keys, both ways through the converters.
* The shuffle losses alone, and `hvu_loss` over a 6-category vocabulary
  in every mode ('all' and 'individual', with and without masks, mean
  and sum, category weights, a category no clip has labels for): every
  entry within 1e-6, gradients within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.losses import hvu as jhvu
from cross_modal_video_engine_tpu.losses import shuffle as jsh
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.losses import hvu as thvu
from cross_modal_video_engine_tpu_torch.losses import shuffle as tsh
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.utils.registry import RECOGNIZERS
from torch_parity import (interpret_pallas, max_rel, random_variables,
                          to_np)

SMALL = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
             num_heads=2, num_layers=2, drop_path_max=0.0)
BACKBONES = {
    "divided": dict(SMALL, attention_type="divided_space_time"),
    "joint+flash": dict(SMALL, attention_type="joint_space_time",
                        use_flash_attention=True),
}
KINDS = ("Recognizer3DShuffleEmb", "Recognizer3DShuffleSoft",
         "Recognizer3DShuffleExtra")
CLASSES, BATCH, TOL = 6, 3, 1e-5
CATS = ("action", "attribute", "concept", "event", "object", "scene")
NUMS = (7, 3, 5, 2, 9, 4)


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


def _pair(kind, backbone, seed=23):
    jcls = getattr(jrec, kind)
    jm = jcls(jts.TimeSformerConfig(**backbone), CLASSES)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3))), seed)
    cfg = tts.TimeSformerConfig(**backbone)
    tm = RECOGNIZERS.get(kind)(cfg, CLASSES, device="cpu")
    tm.load_state_dict(tconv.shuffle_recognizer_state_dict_from_jax(
        variables, cfg))
    return jm, variables, tm


@pytest.mark.parametrize("backbone", list(BACKBONES))
@pytest.mark.parametrize("kind", KINDS)
def test_forward_train_losses_and_gradients_match_jax(kind, backbone):
    jm, variables, tm = _pair(kind, BACKBONES[backbone])
    rng = np.random.default_rng(31)
    v = rng.standard_normal((BATCH, 4, 16, 16, 3)).astype(np.float32)
    sv = v[:, rng.permutation(4)]
    lab = rng.integers(0, CLASSES - 1, BATCH)

    def jloss(params):
        out = jm.apply({"params": params}, jnp.asarray(v), jnp.asarray(sv),
                       jnp.asarray(lab, jnp.int32), method="forward_train")
        return out["loss"], out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, variables["params"]))
    got = tm.forward_train(torch.from_numpy(v), torch.from_numpy(sv),
                           torch.from_numpy(lab))
    assert tm.training and set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) \
            <= TOL * max(abs(float(want[k])), 1e-3), k
    got["loss"].backward()
    jg = tconv.recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jgrads)}, tm.backbone.cfg)
    for name, p in tm.named_parameters():
        assert max_rel(to_np(p.grad), jg[name]) <= TOL, name


def test_shuffle_extra_labels_shuffled_clips_last():
    _, _, tm = _pair("Recognizer3DShuffleExtra", BACKBONES["divided"])
    v = torch.zeros(2, 4, 16, 16, 3)
    with torch.no_grad():
        scores = tm.cls_head(tm.backbone(v))
        out = tm.forward_train(v, v, torch.tensor([0, 1]))
    want = torch.nn.functional.cross_entropy(
        torch.cat([scores, scores]), torch.tensor([0, 1, 5, 5]))
    assert float(out["loss"]) == pytest.approx(float(want), rel=1e-6)


def test_converters_and_registry():
    _, variables, tm = _pair("Recognizer3DShuffleSoft", BACKBONES["divided"])
    plain = trec.Recognizer3D(tm.backbone.cfg, CLASSES, device="cpu")
    assert tm.state_dict().keys() == plain.state_dict().keys()
    back = tconv.shuffle_recognizer_variables_to_jax(tm.state_dict(),
                                                      tm.backbone.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(
        {"params": variables["params"]})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": variables["params"]})):
        np.testing.assert_array_equal(a, b)
    for kind in KINDS:
        assert issubclass(RECOGNIZERS.get(kind), trec.Recognizer3D)
    with pytest.raises(KeyError, match="fc_cls"):
        tconv.shuffle_recognizer_variables_to_jax(
            {"cls_head.out.weight": torch.zeros(1)}, tm.backbone.cfg)


def test_shuffle_losses_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 8)).astype(np.float32)
    y = rng.standard_normal((5, 8)).astype(np.float32)
    y[0] = x[0]                                      # cos 1: above margin
    x[1] = 0.0                                       # the 1e-12 floor
    for margin in (0.0, 0.5, -0.2):
        want = jsh.cosine_away_loss(jnp.asarray(x), jnp.asarray(y), margin)
        got = tsh.cosine_away_loss(torch.from_numpy(x), torch.from_numpy(y),
                                   margin)
        assert abs(float(got) - float(want)) <= 1e-6
    lab = rng.integers(0, 7, 5)
    soft_j = jsh.soft_label_smooth(jnp.asarray(lab), 7, 0.3)
    soft_t = tsh.soft_label_smooth(torch.from_numpy(lab), 7, 0.3)
    assert soft_t.dtype == torch.float32
    np.testing.assert_array_equal(to_np(soft_t), np.asarray(soft_j))
    s = rng.standard_normal((5, 7)).astype(np.float32)
    assert abs(float(tsh.soft_cross_entropy(torch.from_numpy(s), soft_t))
               - float(jsh.soft_cross_entropy(jnp.asarray(s), soft_j))) \
        <= 1e-6


HVU_CASES = [("all", False, "mean", None), ("all", False, "sum", None),
             ("all", True, "mean", None), ("all", True, "sum", None),
             ("individual", False, "mean", None),
             ("individual", False, "sum", (1.0, 2.0, 0.5, 1.0, 3.0, 1.0)),
             ("individual", True, "mean", None),
             ("individual", True, "sum", (1.0, 2.0, 0.5, 1.0, 3.0, 1.0))]


@pytest.mark.parametrize("loss_type,with_mask,reduction,weights", HVU_CASES)
def test_hvu_loss_matches_jax(loss_type, with_mask, reduction, weights):
    rng = np.random.default_rng(12)
    total = sum(NUMS)
    score = (2 * rng.standard_normal((4, total))).astype(np.float32)
    label = (rng.random((4, total)) > 0.7).astype(np.float32)
    mask = (rng.random((4, total)) > 0.2).astype(np.float32)
    cmask = (rng.random((4, len(CATS))) > 0.3).astype(np.float32)
    cmask[:, 3] = 0.0                # a category no clip has labels for
    kw = dict(categories=CATS, category_nums=NUMS,
              category_loss_weights=weights, loss_type=loss_type,
              with_mask=with_mask, reduction=reduction)

    def jloss(s):
        out = jhvu.hvu_loss(s, jnp.asarray(label), jnp.asarray(mask),
                            jnp.asarray(cmask), **kw)
        return out["loss_cls"], out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(score))
    s = torch.from_numpy(score).requires_grad_(True)
    got = thvu.hvu_loss(s, torch.from_numpy(label), torch.from_numpy(mask),
                        torch.from_numpy(cmask), **kw)
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6 * max(
            1.0, abs(float(want[k]))), k
    got["loss_cls"].backward()
    assert np.abs(to_np(s.grad) - np.asarray(jgrad)).max() <= 1e-6


def test_hvu_loss_default_vocabulary_and_refusals():
    total = sum(thvu.DEFAULT_CATEGORY_NUMS)
    assert total == 3142
    z = torch.zeros(2, total)
    out = thvu.hvu_loss(z, z)
    assert float(out["loss_cls"]) == pytest.approx(np.log(2.0), rel=1e-6)
    with pytest.raises(ValueError, match="loss_type"):
        thvu.hvu_loss(z, z, loss_type="mixed")
    with pytest.raises(ValueError, match="mask"):
        thvu.hvu_loss(z, z, with_mask=True)

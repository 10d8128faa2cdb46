"""The port's MViT (models/mvit.py) against the JAX package's, on the CPU
at a small size: embed 8, depths (1, 2), heads (1, 2), patch (2, 4, 4),
videos of 6x26x22 (flax's 'SAME' pad; batch 3).  Stage 1's first block is
the transition: q pooled at (1, 2, 2), channels 8 -> 16 through
`shortcut_proj`, the shortcut max-pooled to the q grid.

* The pooling helpers equal the JAX ones (the max pool pads with -inf).
* The port's parameters, through the converter, are the JAX init's tree
  leaf for leaf in shape (`pool_q` only at the transition), and
  `mvit_state_dict_from_jax` inverts `mvit_variables_to_jax`.
* Forward (a BackboneClassifier's eval logits) within FWD_TOL (1e-5) of
  the largest, f32.
* One `make_cls_train_step` against JAX's, f32 and bf16=True, and one
  `make_seq_train_step` of seq_generate/mvit_relseq.py's model
  (RecognizerRelseq, decoder input dropout 0) in f32 (the bounds of
  tests/torch_transformer_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.models import decoder_head as jdh
from cross_modal_video_engine_tpu.models import mvit as jmv
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import mvit as tmv
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
import torch_transformer_parity as P
from torch_parity import max_rel

FWD_TOL, CLASSES = 1e-5, 5
CFG = dict(embed_dim=8, depths=(1, 2), num_heads=(1, 2))
SHAPE = (6, 26, 22)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def videos(batch=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, *SHAPE, 3)).astype(np.float32)


def pair(seed=5):
    tm = trec.BackboneClassifier(tmv.MViT(tmv.MViTConfig(**CFG), "cpu"),
                                 CLASSES, dropout_ratio=0.0)
    tm.load_state_dict(P.seeded_state_dict(tm, seed))
    jm = jrec.BackboneClassifier(jmv.MViT(jmv.MViTConfig(**CFG)), CLASSES,
                                 dropout_ratio=0.0)
    return tm, jm


def test_pooling_helpers_match_jax():
    x = np.random.default_rng(2).standard_normal((2, 3 * 7 * 6, 4)).astype(
        np.float32) - 3.0            # all negative: a zero pad would show
    for stride in ((1, 2, 2), (2, 2, 2), (1, 1, 1)):
        got, grid = tmv._pool_skip(torch.from_numpy(x), (3, 7, 6), stride)
        want, jgrid = jmv._pool_skip(jnp.asarray(x), (3, 7, 6), stride)
        assert tuple(grid) == tuple(jgrid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tmv._pooled_grid((3, 7, 6), (1, 2, 2)) == (3, 4, 3)


def test_parameters_are_the_jax_tree():
    tm, _ = pair()
    ours = jax.tree.map(np.shape, P.jax_variables(tm)["params"])
    jinit = jax.eval_shape(
        jrec.BackboneClassifier(jmv.MViT(jmv.MViTConfig(**CFG)),
                                CLASSES).init,
        jax.random.key(0), jnp.zeros((1, *SHAPE, 3)))["params"]
    assert ours == jax.tree.map(lambda a: a.shape, jinit)
    bb = ours["backbone"]
    assert "pool_q" in bb["stage1_block0"]["attn"]
    assert "shortcut_proj" in bb["stage1_block0"]
    assert "pool_q" not in bb["stage1_block1"]["attn"]
    assert "pool_q" not in bb["stage0_block0"]["attn"]
    sd = {k[len("backbone."):]: v for k, v in tm.state_dict().items()
          if k.startswith("backbone.")}
    cfg = tmv.MViTConfig(**CFG)
    back = tconv.mvit_state_dict_from_jax(
        tconv.mvit_variables_to_jax(sd, cfg), cfg)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_forward_matches_jax():
    tm, jm = pair()
    x = videos()
    want = np.asarray(jax.jit(jm.apply)(P.jax_variables(tm),
                                        jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert max_rel(got, want) <= FWD_TOL


@pytest.fixture(scope="module")
def runs():
    tm, jm = pair(seed=7)
    x, lab = videos(seed=8), np.array([0, 2, 4])
    return (P.steps(tm, jm, x, lab, bf16=False),
            P.steps(tm, jm, x, lab, bf16=True))


def test_f32_step_matches_jax(runs):
    P.check_f32_step(runs[0])


def test_bf16_step_matches_jax(runs):
    P.check_bf16_step(runs[1], runs[0])


def test_relseq_caption_step_matches_jax():
    dec = dict(num_classes=5, in_channels=16, max_len=3, input_dropout_p=0.0)
    tm = trec.RecognizerRelseq(tmv.MViT(tmv.MViTConfig(**CFG), "cpu"),
                               RNNDecoderConfig(**dec))
    tm.load_state_dict(P.seeded_state_dict(tm, 9))
    jm = jrec.RecognizerRelseq(jmv.MViT(jmv.MViTConfig(**CFG)),
                               jdh.RNNDecoderConfig(**dec))
    rng = np.random.default_rng(400)
    targets = (rng.random((3, 3, 5)) < 0.4).astype(np.float32)
    mask = np.ones((3, 3), np.float32)
    mask[0, 2] = 0.0
    P.check_f32_step(P.seq_steps(tm, jm, videos(seed=10), targets, mask))

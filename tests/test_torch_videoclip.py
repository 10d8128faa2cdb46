"""The port's VideoCLIP (models/videoclip.py) against the JAX package's,
on the CPU at a small size: fps 4, S3D channels 4, width 16, 2 layers, 2
heads, vocab 50, text length 8 (batch 3).

* The port's parameters, through the converter, are the JAX init's tree
  leaf for leaf in shape, and `videoclip_state_dict_from_jax` inverts
  `videoclip_variables_to_jax`.
* `encode_video` with T = 6 and 9 frames (not multiples of fps: one and
  two second tokens), `encode_text` with padded rows (an additive -1e9
  (B, 1, 1, S) mask on the pad keys, the mean over the other tokens) and
  the contrastive logits, within FWD_TOL (1e-5) of the largest, f32.
* One `make_cls_train_step` of the recipe's classifier
  (BackboneClassifier over `VideoCLIPPooled`) against JAX's: f32 and
  bf16=True with the head's dropout off, and f32 with I3DHead's dropout
  0.5, the same mask handed to both packages (flax's Dropout through
  `jax.random.bernoulli`, the port's `layers.Dropout`); the bounds of
  tests/torch_transformer_parity.py.  The text tower, unused, gets zero
  gradients in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import recognition_train as jcli
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import videoclip as jc
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import layers as tlayers
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import videoclip as tc
import torch_transformer_parity as P
from torch_parity import max_rel

FWD_TOL, CLASSES = 1e-5, 5
CFG = dict(fps=4, s3d_channels=4, width=16, layers=2, heads=2,
           vocab_size=50, max_text_len=8)
IDS = np.array([[5, 3, 7, 0, 0, 0, 0, 0], [1, 2, 3, 4, 5, 6, 7, 9],
                [8, 0, 0, 0, 0, 0, 0, 0]], np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def videos(frames=6, batch=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, frames, 24, 20, 3)).astype(np.float32)


def model(seed=5):
    tm = tc.VideoCLIP(tc.VideoCLIPConfig(**CFG), "cpu")
    tm.load_state_dict(P.seeded_state_dict(tm, seed))
    return tm, jc.VideoCLIP(jc.VideoCLIPConfig(**CFG))


def test_parameters_are_the_jax_tree():
    tm, jm = model()
    cfg = tc.VideoCLIPConfig(**CFG)
    tree = tconv.videoclip_variables_to_jax(tm.state_dict(), cfg)
    jinit = jax.eval_shape(jm.init, jax.random.key(0),
                           jnp.zeros((1, 4, 24, 20, 3)),
                           jnp.ones((1, 8), jnp.int32))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda a: a.shape,
                                                        jinit)
    back = tconv.videoclip_state_dict_from_jax(tree, cfg)
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())


@pytest.mark.parametrize("frames", [6, 9])
def test_forward_matches_jax(frames):
    tm, jm = model()
    variables = tconv.videoclip_variables_to_jax(
        tm.state_dict(), tc.VideoCLIPConfig(**CFG))
    x = videos(frames)
    jvid = jax.jit(lambda v, a: jm.apply(v, a, method="encode_video"))
    jtxt = jax.jit(lambda v, a: jm.apply(v, a, method="encode_text"))
    jboth = jax.jit(jm.apply)
    with torch.no_grad():
        assert max_rel(tm(torch.from_numpy(x)).numpy(),
                       np.asarray(jvid(variables, x))) <= FWD_TOL
        ids = torch.from_numpy(IDS).long()
        assert max_rel(tm.encode_text(ids).numpy(),
                       np.asarray(jtxt(variables, IDS))) <= FWD_TOL
        logits, per_text = tm(torch.from_numpy(x), ids)
        want = np.asarray(jboth(variables, x, IDS)[0])
        assert max_rel(logits.numpy(), want) <= FWD_TOL
        assert torch.equal(per_text, logits.t())


def pair(seed=7, dropout=0.0):
    tm = trec.BackboneClassifier(
        tc.VideoCLIPPooled(tc.VideoCLIPConfig(**CFG), "cpu"), CLASSES,
        dropout_ratio=dropout)
    tm.load_state_dict(P.seeded_state_dict(tm, seed))
    jm = jrec.BackboneClassifier(
        jcli._VideoCLIPPooled(jc.VideoCLIPConfig(**CFG)), CLASSES,
        dropout_ratio=dropout)
    return tm, jm


@pytest.fixture(scope="module")
def runs():
    tm, jm = pair()
    x, lab = videos(seed=8), np.array([0, 2, 4])
    return (P.steps(tm, jm, x, lab, bf16=False),
            P.steps(tm, jm, x, lab, bf16=True))


def test_f32_step_matches_jax(runs):
    P.check_f32_step(runs[0])
    text = [n for n in runs[0][2] if "text" in n or "token" in n]
    assert text and all(not runs[0][2][n].any() for n in text)


def test_bf16_step_matches_jax(runs):
    P.check_bf16_step(runs[1], runs[0])


def test_f32_step_with_head_dropout_matches_jax(monkeypatch):
    keep = np.random.default_rng(9).random((3, 16)) >= 0.5
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(keep))

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        return torch.where(torch.from_numpy(keep), x / (1.0 - self.p), 0.0)

    monkeypatch.setattr(tlayers.Dropout, "forward", forward)
    tm, jm = pair(seed=11, dropout=0.5)
    P.check_f32_step(P.steps(tm, jm, videos(seed=12), np.array([1, 3, 0]),
                             bf16=False))

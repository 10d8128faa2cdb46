"""The port's VideoMAE ViT (models/videomae_vit.py) against the JAX
package's, on the CPU at a small size: 6 frames of 16², patch 8,
tubelet 2, width 16, 2 heads, 2 layers, layer-scale init_values 0.1
(batch 3).

* `sinusoid_table` and `videomae_config_from_sd` equal the JAX ones; the
  position table is no parameter.
* The converter is the importer: the port's state dict through
  `conv_recognizer_variables_to_jax` is exactly `convert_videomae`'s tree
  (the k bias pinned to zero: no key), and `videomae_state_dict_from_jax`
  inverts it.
* Forward within FWD_TOL (1e-5) of the largest with dtype='float32';
  with dtype='bfloat16' (the blocks in bf16, the norms and the output in
  f32) within BF16_FWD (2e-2) of the largest and at cosine >= 0.999.
* One `make_cls_train_step` against JAX's: f32, bf16=True on the f32
  config (every layer in f32 on bf16-rounded weights), and the bf16
  config trained on f32 masters without bf16=True (no refusal, as in
  JAX), the last two by the bf16 bounds of tests/torch_transformer_
  parity.py; one `make_seq_train_step` of seq_generate/videomae_relseq.
  py's model (RecognizerRelseq) in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.convert import torch_import as ti
from cross_modal_video_engine_tpu.models import decoder_head as jdh
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import videomae_vit as jv
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import videomae_vit as tv
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
import torch_transformer_parity as P
from torch_parity import max_rel, min_cosine

FWD_TOL, BF16_FWD, CLASSES = 1e-5, 2e-2, 5
CFG = dict(num_frames=6, img_size=16, patch_size=8, tubelet_size=2,
           embed_dims=16, num_heads=2, num_layers=2, init_values=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def videos(batch=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, 6, 16, 16, 3)).astype(np.float32)


def pair(seed=5, **over):
    cfg = dict(CFG, **over)
    tm = trec.BackboneClassifier(tv.VideoMAEViT(tv.VideoMAEConfig(**cfg),
                                                "cpu"),
                                 CLASSES, dropout_ratio=0.0)
    tm.load_state_dict(P.seeded_state_dict(tm, seed))
    jm = jrec.BackboneClassifier(jv.VideoMAEViT(jv.VideoMAEConfig(**cfg)),
                                 CLASSES, dropout_ratio=0.0)
    return tm, jm


def test_sinusoid_table_and_config_from_sd():
    for n, d in ((12, 16), (1568, 768), (7, 5)):
        np.testing.assert_array_equal(tv.sinusoid_table(n, d),
                                      jv.sinusoid_table(n, d))
    tm, _ = pair()
    assert not any("pos" in k for k in tm.state_dict())
    bb = {k[len("backbone."):]: v.numpy() for k, v in tm.state_dict().items()
          if k.startswith("backbone.")}
    for sd in (bb, {f"backbone.{k}": v for k, v in bb.items()},
               {k: v for k, v in bb.items() if "gamma" not in k}):
        assert tv.videomae_config_from_sd(sd, 6, 16) == \
            jv.videomae_config_from_sd(sd, 6, 16)
    assert tv.videomae_config_from_sd(bb, 6, 16)["init_values"] == 0.1


def test_converter_is_the_importer():
    tm, _ = pair(seed=6)
    sd = tm.state_dict()
    ours = P.jax_variables(tm)
    theirs = ti.convert_videomae({k: v.numpy() for k, v in sd.items()})
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, ours, theirs)))
    back = tconv.conv_recognizer_state_dict_from_jax(theirs, tm)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    bb = {k[len("backbone."):]: v for k, v in sd.items()
          if k.startswith("backbone.")}
    cfg = tv.VideoMAEConfig(**CFG)
    back = tconv.videomae_state_dict_from_jax(
        tconv.videomae_variables_to_jax(bb, cfg), cfg)
    assert all(torch.equal(back[k], v) for k, v in bb.items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    tm, jm = pair(dtype=dtype)
    x = videos()
    want = np.asarray(jax.jit(jm.apply)(P.jax_variables(tm),
                                        jnp.asarray(x)))
    with torch.no_grad():
        feat = tm.backbone(torch.from_numpy(x))
        got = tm.cls_head(feat).numpy()
    assert feat.dtype == torch.float32
    if dtype == "float32":
        assert max_rel(got, want) <= FWD_TOL
    else:
        assert max_rel(got, want) <= BF16_FWD
        assert min_cosine(got, want) >= 0.999


@pytest.fixture(scope="module")
def runs():
    tm, jm = pair(seed=7)
    x, lab = videos(seed=8), np.array([0, 2, 4])
    f32 = P.steps(tm, jm, x, lab, bf16=False)
    bf16 = P.steps(tm, jm, x, lab, bf16=True)
    tm_b, jm_b = pair(seed=7, dtype="bfloat16")
    return f32, bf16, P.steps(tm_b, jm_b, x, lab, bf16=False)


def test_f32_step_matches_jax(runs):
    P.check_f32_step(runs[0])


def test_bf16_step_matches_jax(runs):
    P.check_bf16_step(runs[1], runs[0])


def test_bf16_config_trains_on_f32_masters(runs):
    P.check_bf16_step(runs[2])


def test_relseq_caption_step_matches_jax():
    dec = dict(num_classes=5, in_channels=16, max_len=3, input_dropout_p=0.0)
    cfg = tv.VideoMAEConfig(**CFG)
    tm = trec.RecognizerRelseq(tv.VideoMAEViT(cfg, "cpu"),
                               RNNDecoderConfig(**dec))
    tm.load_state_dict(P.seeded_state_dict(tm, 9))
    jm = jrec.RecognizerRelseq(
        jv.VideoMAEViT(jv.VideoMAEConfig(**dataclasses.asdict(cfg))),
        jdh.RNNDecoderConfig(**dec))
    rng = np.random.default_rng(400)
    targets = (rng.random((3, 3, 5)) < 0.4).astype(np.float32)
    mask = np.ones((3, 3), np.float32)
    mask[1, 2] = 0.0
    P.check_f32_step(P.seq_steps(tm, jm, videos(seed=10), targets, mask))

"""The port's Recognizer3DCLIP against the JAX package's, on the CPU at a
small size: CLIP ViT with 32² images, patch 16, width 16, 2 heads, 2
layers, embed 8 (3 videos of 2 frames).

* The converter's `clip_vision` tree is exactly `convert_clip_vit`'s
  `visual` tree for the same OpenAI-layout tower, and
  `clip_recognizer_state_dict_from_jax` inverts
  `clip_recognizer_variables_to_jax`.
* Forward within FWD_TOL (1e-5) of the largest in f32, with the fused
  flags off and on (the JAX side's Pallas sublayers in interpret mode,
  the port's wrappers on their plain versions on the CPU), and with
  dtype='bfloat16' and the fused flags on within BF16_FWD (2e-2) and at
  cosine >= 0.999.
* One `make_cls_train_step` against JAX's: f32 and bf16=True with the
  plain tower; f32 with the fused flags (the sublayers' `_PlainBackward`
  against JAX's `custom_vjp`s); the bf16 config with the fused flags on
  f32 masters (no bf16=True); the bounds of tests/torch_transformer_
  parity.py.  The parameters stay f32 whatever the config's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.convert import torch_import as ti
from cross_modal_video_engine_tpu.models import clip as jclip
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import clip as tclip
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
import torch_transformer_parity as P
from torch_parity import interpret_pallas, max_rel, min_cosine

FWD_TOL, BF16_FWD, CLASSES = 1e-5, 2e-2, 5
CFG = dict(embed_dim=8, image_resolution=32, vision_width=16,
           vision_layers=2, vision_heads=2, patch_size=16, context_length=8,
           vocab_size=50, text_width=16, text_heads=2, text_layers=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]), pytest.MonkeyPatch.context() \
            as mp:
        interpret_pallas(mp)
        yield
    torch.set_num_threads(threads)


def videos(batch=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, 2, 32, 32, 3)).astype(np.float32)


def pair(seed=5, **over):
    cfg = dict(CFG, **over)
    tm = trec.Recognizer3DCLIP(tclip.CLIPConfig(**cfg), CLASSES,
                               device="cpu")
    tm.load_state_dict(P.seeded_state_dict(tm, seed))
    jm = jrec.Recognizer3DCLIP(jclip.VisionTower(jclip.CLIPConfig(**cfg)),
                               CLASSES)
    return tm, jm


def test_converter_is_the_importer():
    cfg = tclip.CLIPConfig(**CFG)
    full = tclip.random_state_dict(cfg, 3)
    sd = {f"clip_vision.{k[len('visual.'):]}": v for k, v in full.items()
          if k.startswith("visual.")}
    rng = np.random.default_rng(4)
    sd["fc_cls.weight"] = torch.tensor(
        rng.standard_normal((CLASSES, 8)).astype(np.float32))
    sd["fc_cls.bias"] = torch.zeros(CLASSES)
    ours = tconv.clip_recognizer_variables_to_jax(sd, cfg, CLASSES)["params"]
    theirs = ti.convert_clip_vit({k: v.numpy() for k, v in full.items()},
                                 cfg)["params"]["visual"]
    assert jax.tree.structure(ours["clip_vision"]) == \
        jax.tree.structure(theirs)
    assert all(jax.tree.leaves(jax.tree.map(
        np.array_equal, ours["clip_vision"], theirs)))
    back = tconv.clip_recognizer_state_dict_from_jax({"params": ours}, cfg,
                                                     CLASSES)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())


@pytest.mark.parametrize("case", ["f32", "f32_fused", "bf16_fused"])
def test_forward_matches_jax(case):
    fused = case.endswith("fused")
    tm, jm = pair(dtype="bfloat16" if case.startswith("bf16") else "float32",
                  fused_attn=fused, fused_mlp=fused)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    x = videos()
    want = np.asarray(jax.jit(jm.apply)(P.jax_variables(tm),
                                        jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    if case.startswith("f32"):
        assert max_rel(got, want) <= FWD_TOL
    else:
        assert max_rel(got, want) <= BF16_FWD
        assert min_cosine(got, want) >= 0.999


@pytest.fixture(scope="module")
def runs():
    x, lab = videos(seed=8), np.array([0, 2, 4])
    tm, jm = pair(seed=7)
    out = {"f32": P.steps(tm, jm, x, lab, bf16=False),
           "bf16": P.steps(tm, jm, x, lab, bf16=True)}
    tm, jm = pair(seed=7, fused_attn=True, fused_mlp=True)
    out["f32_fused"] = P.steps(tm, jm, x, lab, bf16=False)
    tm, jm = pair(seed=7, fused_attn=True, fused_mlp=True, dtype="bfloat16")
    out["bf16_config_fused"] = P.steps(tm, jm, x, lab, bf16=False)
    return out


def test_f32_step_matches_jax(runs):
    P.check_f32_step(runs["f32"])


def test_bf16_step_matches_jax(runs):
    P.check_bf16_step(runs["bf16"], runs["f32"])


def test_fused_f32_step_matches_jax(runs):
    P.check_f32_step(runs["f32_fused"])


def test_fused_bf16_config_step_matches_jax(runs):
    P.check_bf16_step(runs["bf16_config_fused"], runs["f32"])

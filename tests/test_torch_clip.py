"""The port's CLIP towers (cross_modal_video_engine_tpu_torch models/clip.py)
against the JAX CLIPModel with the same weights: one random OpenAI-layout
state dict loads into the port directly and into the JAX package through
convert_clip_vit.

Tolerances: f32 1e-3 absolute on tower outputs (two towers of two
blocks; the sides sum in different orders and flax's LayerNorm computes
its variance as E[x^2] - E[x]^2).  bf16: cosine >= 0.999 per output row,
since roundings that differ by a step in the unfused Dense path or the
bf16 ingest affine move single elements by a step while the direction
stays."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cross_modal_video_engine_tpu.convert import convert_clip_vit
from cross_modal_video_engine_tpu.models import clip as jclip
from cross_modal_video_engine_tpu_torch.convert import clip_state_dict_from_jax
from cross_modal_video_engine_tpu_torch.models import clip as tclip

@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found for the other test files
    this worker runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)

SMALL = dict(embed_dim=32, image_resolution=64, vision_width=48,
             vision_layers=2, vision_heads=4, patch_size=16,
             context_length=12, vocab_size=96, text_width=40, text_heads=4,
             text_layers=2)
SPLIT = 4          # placeholder token of compositional queries


@pytest.fixture(scope="module")
def weights():
    sd = tclip.random_state_dict(tclip.CLIPConfig(**SMALL), seed=5)
    return sd, convert_clip_vit(sd, jclip.CLIPConfig(**SMALL))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((2, 3, 64, 64, 3)).astype(np.float32)
    frames_u8 = rng.integers(0, 256, (2, 3, 64, 64, 3), np.uint8)
    ids = rng.integers(5, 90, (3, 12)).astype(np.int32)
    ids[0, 7], ids[1, 11], ids[2, 3] = 95, 95, 95          # EOT = max id
    ids[2, 5] = 95                       # a repeated EOT: the first counts
    ids[0, 2] = ids[0, 5] = SPLIT        # only the first is spliced
    ids[1, 1] = SPLIT                    # row 2 has no placeholder
    img_tokens = rng.standard_normal((3, 40)).astype(np.float32)
    return dict(frames=frames, frames_u8=frames_u8, ids=ids,
                img_tokens=img_tokens)


def _models(weights, dtype, fused):
    sd, variables = weights
    flags = dict(dtype=dtype, fused_attn=fused, fused_mlp=fused)
    jm = jclip.CLIPModel(jclip.CLIPConfig(**SMALL, **flags))
    tm = tclip.CLIPModel(tclip.CLIPConfig(**SMALL, **flags), device="cpu")
    tm.load_state_dict(sd)
    return jm, variables, tm


def _run(weights, inputs, dtype, fused, method):
    jm, variables, tm = _models(weights, dtype, fused)
    args = {"encode_video": ("frames",), "encode_video_u8": ("frames_u8",),
            "encode_text": ("ids",),
            "encode_text_img_retrieval": ("ids", "img_tokens"),
            "encode_image": ("frames",)}[method]
    jargs = [jnp.asarray(inputs[a]) for a in args]
    targs = [torch.from_numpy(inputs[a]) for a in args]
    if method == "encode_image":
        jargs, targs = [jargs[0][:, 0]], [targs[0][:, 0]]
    if method == "encode_text_img_retrieval":
        jargs.append(SPLIT)
        targs.append(SPLIT)
    want = jm.apply(variables, *jargs, method=method)
    with torch.no_grad():
        got = getattr(tm, method)(*targs)
    as_tuple = (lambda o: o if isinstance(o, tuple) else (o,))
    return ([np.asarray(w, np.float32) for w in as_tuple(want)],
            [g.float().numpy() for g in as_tuple(got)])


def _assert_close(want, got, dtype):
    for w, g in zip(want, got):
        assert w.shape == g.shape
        assert np.isfinite(g).all()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
        else:
            w2, g2 = w.reshape(-1, w.shape[-1]), g.reshape(-1, g.shape[-1])
            cos = (w2 * g2).sum(-1) / (np.linalg.norm(w2, axis=-1)
                                       * np.linalg.norm(g2, axis=-1))
            assert cos.min() >= 0.999, cos.min()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["encode_video", "encode_video_u8",
                                    "encode_text",
                                    "encode_text_img_retrieval"])
def test_fused_slice_matches_jax(weights, inputs, method, dtype):
    """fused_attn=fused_mlp=True on both sides: the JAX Pallas kernels
    (interpreted) against the port's plain versions."""
    want, got = _run(weights, inputs, dtype, True, method)
    _assert_close(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["encode_image", "encode_text"])
def test_unfused_towers_match_jax(weights, inputs, method, dtype):
    want, got = _run(weights, inputs, dtype, False, method)
    _assert_close(want, got, dtype)


def test_contrastive_logits_match_jax(weights, inputs):
    jm, variables, tm = _models(weights, "float32", False)
    images = inputs["frames"][:, 0]
    want = jm.apply(variables, jnp.asarray(images), jnp.asarray(inputs["ids"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(inputs["ids"]))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)


def test_weight_bridge_round_trip(weights):
    """port state dict -> convert_clip_vit -> clip_state_dict_from_jax
    reproduces the state dict exactly, key for key."""
    sd, variables = weights
    back = clip_state_dict_from_jax(variables, jclip.CLIPConfig(**SMALL))
    assert back.keys() == sd.keys()
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k


def test_state_dict_layout_loads_strictly(weights):
    """The port's own parameters are exactly the OpenAI layout the JAX
    importer reads: a strict load neither misses nor leaves a key."""
    sd, _ = weights
    model = tclip.CLIPModel(tclip.CLIPConfig(**SMALL, dtype="bfloat16"),
                            device="cpu")
    model.load_state_dict(sd, strict=True)
    assert model.visual.proj.dtype == torch.bfloat16
    assert model.visual.ln_pre.weight.dtype == torch.float32
    assert model.logit_scale.dtype == torch.float32


def test_jax_config_dict_loads_and_flatten_refused():
    jcfg = jclip.CLIPConfig(dtype="bfloat16", flatten_tokens=True)
    cfg = tclip.CLIPConfig(**dataclasses.asdict(jcfg))
    assert cfg.torch_dtype() == torch.bfloat16 and cfg.grid == 7
    with pytest.raises(ValueError, match="flatten_tokens"):
        tclip.CLIPModel(dataclasses.replace(cfg, **SMALL), device="meta")


def test_enable_fused_inference_cuda_rule():
    cfg = tclip.CLIPConfig(dtype="bfloat16", flatten_tokens=True)
    # no device named: the CUDA device, so the kernels are on
    assert tclip.enable_fused_inference(cfg).fused_attn
    assert tclip.enable_fused_inference(cfg, device="cpu") is cfg
    on = tclip.enable_fused_inference(cfg, device="cuda:0")
    assert on.fused_attn and on.fused_mlp and not on.flatten_tokens
    assert not tclip.enable_fused_inference(
        cfg, enable=False, device="cuda").fused_attn
    assert tclip.enable_fused_inference(cfg, enable=True).fused_mlp


# every module of the port's LINAS retrieval and serving slice
LINAS_MODULES = (
    "utils.vocab", "utils.text2vec", "io.bigfile", "io.flax_msgpack",
    "models.layers", "models.dual_encoding", "train.checkpoint",
    "data.provider", "cli.common", "retrieval.evaluation",
    "metrics.retrieval", "cli.retrieval_inference", "cli.retrieval_tester",
    "service.batching", "service.app", "cli.serve", "bench.serve")
# every module of the port's temporal-localization slice
LOCALIZATION_MODULES = (
    "metrics.proposals", "models.bmn", "models.bsn", "models.ssn",
    "losses.localization", "train.localization_trainer",
    "data.datasets_extra", "data.pipelines_extra",
    "cli.localization_train", "cli.misc_tools", "cli.data_tools")
AVA_MODULES = (
    "metrics.ava", "models.ava_head", "models.lfb",
    "train.detection_trainer", "cli.detection_train", "cli.detection_test",
    "cli.ava_proposals")
# every module of the port's host IO and tools slice
HOST_MODULES = (
    "io._native_build", "io.native", "io.pipeline", "data.prefetch",
    "utils.logging", "utils.concept_tags", "metrics", "metrics.scorers",
    "cli.dump_features", "bench.extra")
# the skeleton models, the checkpoint converter and the exports
SKELETON_MODULES = (
    "models.stgcn", "data.datasets_extra", "data.pipelines_extra",
    "cli.skeleton_train", "cli.convert_checkpoint", "cli.misc_tools")


def test_port_imports_no_jax():
    modules = (("models.clip", "retrieval.index", "convert") + LINAS_MODULES
               + LOCALIZATION_MODULES + AVA_MODULES + HOST_MODULES
               + SKELETON_MODULES)
    code = ("import sys; "
            + "; ".join(f"import cross_modal_video_engine_tpu_torch.{m}"
                        for m in modules) + "; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules; "
            "assert 'msgpack' not in sys.modules; "
            "assert 'cross_modal_video_engine_tpu' not in sys.modules")
    root = __file__.rsplit("/tests/", 1)[0]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def _mha_pair(seed, d=32, heads=4):
    """JAX MHA params and the port's MHA state dict, from one numpy seed."""
    rng = np.random.default_rng(seed)
    p = {name: {"kernel": (rng.standard_normal((d, d)) / np.sqrt(d))
                .astype(np.float32),
                "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
         for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
    sd = {"in_proj_weight": np.concatenate(
              [p[n]["kernel"].T for n in ("q_proj", "k_proj", "v_proj")]),
          "in_proj_bias": np.concatenate(
              [p[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")]),
          "out_proj.weight": p["out_proj"]["kernel"].T,
          "out_proj.bias": p["out_proj"]["bias"]}
    return {"params": p}, {k: torch.from_numpy(np.ascontiguousarray(a))
                           for k, a in sd.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("masked", [False, True])
def test_mha_cross_attention_matches_jax(dtype, tol, masked):
    """MHA(kv=...): q from x, k and v from kv (S != L), against the JAX MHA
    with kv on one set of weights; with an additive (L, S) mask too."""
    d, heads, b, l, s = 32, 4, 2, 5, 7
    variables, sd = _mha_pair(17, d, heads)
    rng = np.random.default_rng(18)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    kv = rng.standard_normal((b, s, d)).astype(np.float32)
    mask = np.where(rng.random((l, s)) < 0.3, -np.inf, 0.0) \
        .astype(np.float32) if masked else None
    if masked:
        mask[:, 0] = 0.0                        # every row sees a key
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jm = jclip.MHA(d, heads, jdt)
    want = jm.apply(variables, jnp.asarray(x, jdt),
                    None if mask is None else jnp.asarray(mask),
                    kv=jnp.asarray(kv, jdt))
    tm = tclip.MHA(d, heads, tdt, device="cpu")
    tm.load_state_dict({k: v.to(tdt) for k, v in sd.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(tdt),
                 None if mask is None else torch.from_numpy(mask),
                 kv=torch.from_numpy(kv).to(tdt))
    assert tuple(got.shape) == (b, l, d) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


def test_mha_cross_attention_skips_flash(monkeypatch):
    """With use_flash, a call with kv keeps the plain path (as in JAX):
    the flash wrapper is never reached, and the result equals the plain
    module's."""
    variables, sd = _mha_pair(19)
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 9, 32)).astype(np.float32))
    plain = tclip.MHA(32, 4, torch.float32, device="cpu")
    flash = tclip.MHA(32, 4, torch.float32, device="cpu", use_flash=True)
    plain.load_state_dict(sd)
    flash.load_state_dict(sd)

    def refuse(*args, **kwargs):
        raise AssertionError("flash path taken with kv")

    monkeypatch.setattr(tclip, "flash_attention", refuse)
    with torch.no_grad():
        torch.testing.assert_close(flash(x, kv=kv), plain(x, kv=kv),
                                   rtol=0, atol=0)

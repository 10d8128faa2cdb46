"""The port's TimeSformer (models/timesformer.py) against the JAX
package's on the same weights: random JAX variables go through
convert/from_jax.py into the port, or a port state dict goes through the
JAX importer convert_timesformer.  With use_flash_attention the JAX side
runs its Pallas flash kernel in interpret mode and the port its plain
version.

Tolerances: f32 1e-4 absolute on LayerNorm-scaled outputs (two blocks;
the packages sum in different orders, and flax's LayerNorm computes its
variance as E[x²] - E[x]²).  bf16: cosine >= 0.999 per token and 0.1
absolute: a bf16 rounding that lands one step apart (flax's Dense rounds
the product and then the bias add, P is rounded before or after
normalising) moves single elements by a step, 1.6e-2 at the tokens'
magnitudes of 2-4, and such steps add up over two blocks and the final
LayerNorm (0.055 and cosine 0.99976 measured on these inputs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.convert.torch_import import (
    convert_rnn_decoder_head, convert_timesformer)
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.utils.precision import (
    cast_inference_variables)
from cross_modal_video_engine_tpu_torch.convert import (
    recognizer_state_dict_from_jax, timesformer_state_dict_from_jax)
from cross_modal_video_engine_tpu_torch.models import decoder_head as tdec
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from torch_parity import interpret_pallas, min_cosine, random_variables, to_np

SMALL = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
             num_heads=2, num_layers=2)
VARIANTS = {
    "divided": dict(attention_type="divided_space_time"),
    "joint": dict(attention_type="joint_space_time"),
    "joint+flash": dict(attention_type="joint_space_time",
                        use_flash_attention=True),
    "space-only+flash": dict(attention_type="space_only",
                             use_flash_attention=True),
    "tubelet-2": dict(attention_type="joint_space_time", tubelet_size=2),
}


@pytest.fixture(autouse=True, scope="module")
def _interpret():
    """Module-wide: the module-scoped models are built with it on."""
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers); torch's
    global RNG and thread count left as found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def videos():
    rng = np.random.default_rng(11)
    return rng.standard_normal((2, 4, 16, 16, 3)).astype(np.float32)


def _pair(variant, videos, dtype="float32", seed=3):
    """(JAX model, its variables, port model) on the same random weights."""
    kw = dict(SMALL, **VARIANTS[variant], dtype=dtype)
    jm = jts.TimeSformer(jts.TimeSformerConfig(**kw))
    params = random_variables(
        jm.init(jax.random.key(0), jnp.asarray(videos)), seed)["params"]
    tm = tts.TimeSformer(tts.TimeSformerConfig(**kw), device="cpu")
    tm.load_state_dict(timesformer_state_dict_from_jax(
        params, tm.cfg, prefix=""))
    variables = {"params": params}
    if dtype == "bfloat16":
        variables = cast_inference_variables(variables)
        tm.to(torch.bfloat16)          # the serving loaders' whole cast
    return jm, variables, tm


@pytest.fixture(scope="module")
def pairs(videos):
    return {v: _pair(v, videos) for v in VARIANTS}


def _close(got, want):
    assert got.shape == np.shape(want) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cls_and_tokens_match_jax(pairs, videos, variant):
    jm, variables, tm = pairs[variant]
    want_cls, want_tok = jm.apply(variables, jnp.asarray(videos),
                                  return_tokens=True)
    with torch.no_grad():
        got_cls, got_tok = tm(torch.from_numpy(videos), return_tokens=True)
    assert got_cls.dtype == got_tok.dtype == torch.float32
    _close(to_np(got_cls), want_cls)
    _close(to_np(got_tok), want_tok)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_capture_layers_match_jax(pairs, videos, variant):
    jm, variables, tm = pairs[variant]
    want_cls, want_cap = jm.apply(variables, jnp.asarray(videos),
                                  capture_layers=(0, 1))
    with torch.no_grad():
        got_cls, got_cap = tm(torch.from_numpy(videos),
                              capture_layers=(0, 1))
    assert sorted(got_cap) == [0, 1]
    _close(to_np(got_cls), want_cls)
    for i in (0, 1):
        _close(to_np(got_cap[i]), want_cap[i])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_from_matches_jax(pairs, videos, variant):
    """The explain stack's entry: from the tokens after block 0 (and,
    with layer -1, from the embedded tokens) to the cls feature."""
    jm, variables, tm = pairs[variant]
    rng = np.random.default_rng(12)
    with torch.no_grad():
        _, cap = tm(torch.from_numpy(videos), capture_layers=(0,))
        tokens = cap[0] + 0.1 * torch.from_numpy(
            rng.standard_normal(cap[0].shape).astype(np.float32))
        embedded = tm.embed_tokens(torch.from_numpy(videos))
        got = tm.forward_from(tokens, 0)
        got_all = tm.forward_from(embedded, -1)
        whole = tm(torch.from_numpy(videos))
    want = jm.apply(variables, jnp.asarray(tokens.numpy()), 0,
                    method="forward_from")
    _close(to_np(got), want)
    _close(to_np(got_all), to_np(whole))


def test_bf16_joint_flash_matches_jax(videos):
    """bf16 after the inference cast on both sides: the JAX Pallas flash
    kernel (interpreted) against the port's plain version."""
    jm, variables, tm = _pair("joint+flash", videos, dtype="bfloat16")
    assert tm.norm.weight.dtype == torch.bfloat16
    want_cls, want_tok = jm.apply(variables, jnp.asarray(videos),
                                  return_tokens=True)
    with torch.no_grad():
        got_cls, got_tok = tm(torch.from_numpy(videos), return_tokens=True)
    for got, want in ((got_cls, want_cls), (got_tok, want_tok)):
        g, w = to_np(got), np.asarray(want, np.float32)
        assert np.isfinite(g).all()
        assert min_cosine(g, w) >= 0.999
        np.testing.assert_allclose(g, w, rtol=0, atol=0.1)


def test_convert_timesformer_state_dict_loads_into_port(videos):
    """One mmaction-layout state dict, made by the port, runs the same in
    the port and, through the JAX importer, in the JAX Recognizer3D."""
    cfg = dict(SMALL, attention_type="divided_space_time")
    sd = trec.random_state_dict(tts.TimeSformerConfig(**cfg), seed=21,
                                num_classes=5)
    jcfg = jts.TimeSformerConfig(**cfg)
    variables = convert_timesformer(sd, jcfg)
    want = jrec.Recognizer3D(jcfg, num_classes=5).apply(
        variables, jnp.asarray(videos))
    tm = trec.Recognizer3D(tts.TimeSformerConfig(**cfg), num_classes=5,
                           device="cpu")
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(videos))
    _close(to_np(got), want)


def test_weight_bridge_round_trip():
    """port state dict -> the JAX importers -> recognizer_state_dict_from_jax
    gives the state dict back exactly, classifier and caption head."""
    cfg = tts.TimeSformerConfig(**SMALL)
    dec = tdec.RNNDecoderConfig(num_classes=7, in_channels=32, max_len=3)
    for kw in (dict(num_classes=5), dict(decoder_cfg=dec)):
        sd = trec.random_state_dict(cfg, seed=22, **kw)
        params = convert_timesformer(sd, cfg, cls_head_key=None)["params"]
        if "num_classes" in kw:
            params = convert_timesformer(sd, cfg)["params"]
        else:
            params["cls_head"] = convert_rnn_decoder_head(sd)
        back = recognizer_state_dict_from_jax(params, cfg)
        assert back.keys() == sd.keys()
        for k in sd:
            assert torch.equal(back[k], sd[k]), k


def test_jax_config_dict_loads_and_errors():
    jcfg = jts.TimeSformerConfig(attention_type="space_only", tubelet_size=2,
                                 dtype="bfloat16", remat=True)
    cfg = tts.TimeSformerConfig(**dataclasses.asdict(jcfg))
    assert (cfg.num_patches, cfg.time_tokens) == (jcfg.num_patches,
                                                  jcfg.time_tokens)
    assert cfg.torch_dtype() == torch.bfloat16
    with pytest.raises(ValueError, match="attention_type"):
        tts.TimeSformer(dataclasses.replace(cfg, attention_type="local"),
                        device="meta")
    model = tts.TimeSformer(tts.TimeSformerConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        model(torch.zeros(1, 3, 16, 16, 3))


def _drop_share(out, x, keep):
    """Per sample: all zeros, or exactly x / keep; returns the share
    dropped."""
    out, x = np.asarray(out), np.asarray(x)
    dropped = np.all(out == 0, axis=(1, 2))
    kept = np.all(out == (x / np.float32(keep)), axis=(1, 2))
    assert np.all(dropped | kept)
    return dropped.mean()


def test_drop_path_port_and_jax_drop_whole_samples():
    """Eval mode and rate 0 are the identity; in train mode each sample
    is all zeros or exactly x/keep, dropped with probability `rate`, in
    the port (seeded generator) and in the JAX DropPath alike."""
    rate, n = 0.3, 4000
    x = np.random.default_rng(31).standard_normal((n, 3, 4)) \
        .astype(np.float32) + 5.0                 # no element is 0
    xt = torch.from_numpy(x)
    dp = tts.DropPath(rate, generator=torch.Generator().manual_seed(32))
    dp.eval()
    assert dp(xt) is xt
    dp0 = tts.DropPath(0.0).train()
    assert dp0(xt) is xt
    dp.train()
    share = _drop_share(dp(xt).numpy(), x, 1.0 - rate)
    assert abs(share - rate) < 0.03, share
    jdp = jts.DropPath(rate)
    want = jdp.apply({}, jnp.asarray(x), train=True,
                     rngs={"dropout": jax.random.key(33)})
    jshare = _drop_share(want, x, 1.0 - rate)
    assert abs(jshare - rate) < 0.03, jshare
    np.testing.assert_array_equal(
        np.asarray(jdp.apply({}, jnp.asarray(x), train=False)), x)


def test_drop_path_generator_repeats_and_leaves_global_rng():
    x = torch.ones(64, 2, 3)
    state = torch.random.get_rng_state()
    a = tts.DropPath(0.5, torch.Generator().manual_seed(7)).train()(x)
    b = tts.DropPath(0.5, torch.Generator().manual_seed(7)).train()(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(torch.random.get_rng_state(), state)


@pytest.mark.parametrize("variant", ["divided", "joint"])
def test_train_mode_dropouts_act_and_eval_is_untouched(pairs, videos,
                                                       variant):
    """The model in eval mode equals the JAX forward and draws nothing from
    the global RNG; in train mode the embedding dropouts and DropPath
    change the output, and with every rate at 0 train mode is eval mode."""
    jm, variables, tm = pairs[variant]
    v = torch.from_numpy(videos)
    want = np.asarray(jm.apply(variables, jnp.asarray(videos)))
    state = torch.random.get_rng_state()
    with torch.no_grad():
        got = tm.eval()(v)
    assert torch.equal(torch.random.get_rng_state(), state)
    _close(to_np(got), want)

    kw = dict(SMALL, **VARIANTS[variant])
    for rates, changes in (
            (dict(dropout_ratio=0.0, drop_path_max=0.0), False),
            (dict(dropout_ratio=0.5, drop_path_max=0.0), True),
            (dict(dropout_ratio=0.0, drop_path_max=0.9), True)):
        m = tts.TimeSformer(tts.TimeSformerConfig(**kw, **rates),
                            device="cpu")
        m.load_state_dict(tm.state_dict())
        with torch.no_grad(), torch.random.fork_rng(devices=[]):
            torch.manual_seed(41)
            trained = m.train()(torch.cat([v] * 8))[:2]
        assert bool((trained - got).abs().max() > 1e-3) == changes, rates

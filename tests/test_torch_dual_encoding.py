"""The port's LINAS layers and DualEncoding against the JAX package's on
the same weights and inputs, drawn with numpy, on the CPU.

Layers: BiGRU packed (text side) and unpacked (video side) with lengths 0,
1 and full; ConvBank1D at T = max_words; MFC and LatentMapping in eval mode
and one train-mode forward with dropout 0 (outputs and the new running
statistics).  f32, at most 1e-5 absolute.  DualEncoding: the forward and
the four embed methods for the styles de+map, map, text+video and GT with
a support set, with the weights carried both ways (the JAX importer
`convert_linas_dual_encoding` on the port's reference sub state dicts, and
the port's `dual_encoding_state_dict_from_jax`), L2-normalized embeddings
within 1e-4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.convert import convert_linas_dual_encoding
from cross_modal_video_engine_tpu.models import dual_encoding as jde
from cross_modal_video_engine_tpu.models import layers as jl
from cross_modal_video_engine_tpu_torch.convert import (
    dual_encoding_state_dict_from_jax, dual_encoding_variables_to_jax,
    reference_state_dicts)
from cross_modal_video_engine_tpu_torch.convert.from_jax import (
    _encoding_from_jax, _gru_from_jax, _mapping_from_jax)
from cross_modal_video_engine_tpu_torch.models import dual_encoding as tde
from cross_modal_video_engine_tpu_torch.models import layers as tl

from torch_parity import random_variables

LAYER_TOL = 1e-5
EMB_TOL = 1e-4
# tiny widths; the caption length is max_words, longer than most captions
SMALL = dict(visual_feat_dim=10, visual_rnn_size=6, visual_kernel_num=4,
             visual_kernel_sizes=(2, 3), vocab_size=25, bow_vocab_size=15,
             word_dim=8, text_rnn_size=6, text_kernel_num=4,
             text_kernel_sizes=(2, 3, 4), hidden_size=16, common_dim=16)
MAX_WORDS, MAX_FRAMES, SUPPORT = 9, 7, 3
# (style, teacher_model, student_model): the four student styles
STYLES = [("distill_from_best_model", "GT", "de+map"),
          ("distill_from_best_model", "GT", "map"),
          ("distill_from_best_model", "GT", "text+video"),
          ("GT", "GT", "de+map")]


@pytest.fixture(autouse=True)
def _torch_state_kept():
    """Each test leaves torch's global RNG and thread count as found."""
    rng, threads = torch.get_rng_state(), torch.get_num_threads()
    yield
    assert torch.equal(torch.get_rng_state(), rng)
    assert torch.get_num_threads() == threads


def _np(t):
    return t.detach().numpy()


def _empty(cls, *args, **kw):
    """A port layer built without random draws (on the meta device, then
    given CPU storage), for a state dict to fill."""
    return cls(*args, device="meta", **kw).to_empty(device="cpu")


def _draw(rng, shape, scale=None):
    scale = int(np.prod(shape[:-1])) ** -0.5 if scale is None else scale
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _init(module, *args, seed, **kw):
    """JAX module variables with every leaf redrawn from a numpy seed and
    the BN variances kept positive."""
    v = module.init(jax.random.key(0), *args, **kw)
    v = random_variables(v, seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.abs(x) + 0.5 if p[-1].key == "var" else x, v)


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("lengths", [(9, 4, 1, 0), (9, 9, 9, 9)])
def test_bigru_matches_jax(packed, lengths):
    rng = np.random.default_rng(11)
    B, T, D, H = len(lengths), MAX_WORDS, 5, 6
    lengths = np.array(lengths)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    params = {}
    for d in ("fwd", "bwd"):
        params.update({f"{d}_wi": _draw(rng, (D, 3 * H)),
                       f"{d}_wh": _draw(rng, (H, 3 * H)),
                       f"{d}_bi": _draw(rng, (3 * H,), 0.1),
                       f"{d}_bh": _draw(rng, (3 * H,), 0.1)})
    want = np.asarray(jl.BiGRU(H, packed=packed).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(mask)))

    tmod = _empty(tl.BiGRU, D, H, packed=packed)
    sd = {}
    _gru_from_jax(sd, "", params)
    tmod.load_state_dict(sd)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == (B, T, 2 * H)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=LAYER_TOL)
    if packed:      # rows of length 0 are zero, steps past the length too
        assert not _np(got)[mask == 0].any()


def test_bigru_packed_pads_to_the_input_length():
    """pad_packed_sequence runs to the input's T, not the longest row's."""
    x = torch.zeros((2, MAX_WORDS, 3))
    out = _empty(tl.BiGRU, 3, 4, packed=True)(x, torch.tensor([2, 3]))
    assert out.shape == (2, MAX_WORDS, 8)


@pytest.mark.parametrize("kernel_sizes", [(2, 3, 4), (2, 3, 4, 5), (1,)])
def test_conv_bank_matches_jax(kernel_sizes):
    rng = np.random.default_rng(12)
    B, T, C, K = 3, MAX_WORDS, 12, 4
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    x[1, 5:] = 0.0                      # zeroed pad steps, as the GRU gives
    params = {f"conv_w{w}": {"kernel": _draw(rng, (w, C, K)),
                             "bias": _draw(rng, (K,), 0.1)}
              for w in kernel_sizes}
    want = np.asarray(jl.ConvBank1D(K, kernel_sizes).apply(
        {"params": params}, jnp.asarray(x)))
    tmod = _empty(tl.ConvBank1D, C, K, kernel_sizes)
    sd = {}
    _encoding_from_jax(sd, "", {"rnn": {f"{d}_{n}": np.zeros(1)
                                        for d in ("fwd", "bwd")
                                        for n in ("wi", "wh", "bi", "bh")},
                                "convs": params}, kernel_sizes)
    tmod.load_state_dict({k[len("convs1."):]: t for k, t in sd.items()
                          if k.startswith("convs1.")})
    # the reference Conv2d layout
    assert tuple(tmod[0].weight.shape) == (K, 1, kernel_sizes[0], C)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=LAYER_TOL)


def _mfc_pair(out_features, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 10)).astype(np.float32)
    dims = (10,) + tuple(out_features)
    mapping = {f"fc{i + 1}": {"kernel": _draw(rng, (dims[i], dims[i + 1])),
                              "bias": _draw(rng, (dims[i + 1],), 0.1)}
               for i in range(len(out_features))}
    mapping["bn_1"] = {"scale": 1 + _draw(rng, (dims[-1],), 0.1),
                       "bias": _draw(rng, (dims[-1],), 0.1)}
    stats = {"mapping": {"bn_1": {
        "mean": _draw(rng, (dims[-1],), 0.3),
        "var": 0.5 + rng.random(dims[-1]).astype(np.float32)}}}
    v = {"params": {"mapping": mapping}, "batch_stats": stats}
    jmod = jl.LatentMapping(out_features, dropout_rate=0.0)
    tmod = _empty(tl.LatentMapping, 10, out_features, dropout_rate=0.0)
    sd = {}
    _mapping_from_jax(sd, "", v["params"], v["batch_stats"])
    tmod.load_state_dict(sd)
    return x, jmod, v, tmod


@pytest.mark.parametrize("out_features", [(16,), (16, 16, 16)])
def test_latent_mapping_eval_matches_jax(out_features):
    x, jmod, v, tmod = _mfc_pair(out_features, 13)
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=LAYER_TOL)
    want_mfc = np.asarray(jl.MFC(out_features, 0.0).apply(
        {"params": v["params"]["mapping"],
         "batch_stats": v["batch_stats"]["mapping"]}, jnp.asarray(x)))
    with torch.no_grad():
        got_mfc = tmod.mapping(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got_mfc), want_mfc, rtol=0,
                               atol=LAYER_TOL)


@pytest.mark.parametrize("out_features", [(16,), (16, 16)])
def test_latent_mapping_train_step_matches_jax(out_features):
    """One train-mode forward with dropout 0: the same outputs (batch
    statistics) and the same new running statistics (flax momentum 0.9,
    biased variance)."""
    x, jmod, v, tmod = _mfc_pair(out_features, 14)
    want, new = jmod.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    tmod.train()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=LAYER_TOL)
    bn = tmod.mapping.bn_1
    stats = new["batch_stats"]["mapping"]["bn_1"]
    np.testing.assert_allclose(_np(bn.running_mean), np.asarray(stats["mean"]),
                               rtol=0, atol=LAYER_TOL)
    np.testing.assert_allclose(_np(bn.running_var), np.asarray(stats["var"]),
                               rtol=0, atol=LAYER_TOL)
    assert int(bn.num_batches_tracked) == 1


# -- the whole model ------------------------------------------------------------

def _inputs(rng, cfg):
    """Videos of 9 (past max_frames), 3, 1 and 5 frames; captions of
    length max_words, 4, 1 and 0; a support set with lengths 0 ..
    max_words."""
    frames = [rng.standard_normal((n, cfg.visual_feat_dim)).astype(np.float32)
              for n in (MAX_FRAMES + 2, 3, 1, 5)]
    ids = [list(rng.integers(4, cfg.vocab_size, MAX_WORDS)),
           [1, 5, 6, 2], [3], []]
    bows = rng.standard_normal((4, cfg.bow_vocab_size)).astype(np.float32)
    slen = np.array([[0, 2, MAX_WORDS], [1, 4, 3], [5, 0, 1], [2, 2, 2]])
    smask = (np.arange(MAX_WORDS)[None, None] < slen[..., None])
    sids = rng.integers(1, cfg.vocab_size, (4, SUPPORT, MAX_WORDS)) * smask
    sbows = rng.standard_normal((4, SUPPORT, cfg.bow_vocab_size)
                                ).astype(np.float32)
    return frames, ids, bows, (sids, sbows, slen, smask.astype(np.float32))


def _batches(pkg, frames, ids, bows, support):
    sids, sbows, slen, smask = support
    if pkg is jde:
        sup = jde.TextBatch(jnp.asarray(sids, jnp.int32), jnp.asarray(sbows),
                            jnp.asarray(slen, jnp.int32), jnp.asarray(smask))
        return (jde.make_video_batch(frames, MAX_FRAMES),
                jde.make_text_batch(ids, bows, MAX_WORDS), sup)
    sup = tde.TextBatch(*(torch.from_numpy(np.asarray(a)) for a in (
        sids.astype(np.int64), sbows, slen.astype(np.int32), smask)))
    return (tde.make_video_batch(frames, MAX_FRAMES, device="cpu"),
            tde.make_text_batch(ids, bows, MAX_WORDS, device="cpu"), sup)


def _methods(cfg):
    out = [("embed_vis", (0,)), ("embed_vis_distill", (0,)),
           ("embed_txt_GT", (1, 2))]
    if cfg.style == "distill_from_best_model":
        out.append(("embed_txt_distill", (1,)))
    return out


def _jax_outputs(model, methods, variables, *batches):
    """Everything the tests compare, in one jitted program: the eval
    forward, the embed methods, and one train-mode forward (dropout is 0)
    with its new running statistics."""
    out = {"forward": model.apply(variables, *batches)}
    for name, which in methods:
        out[name] = model.apply(variables, *[batches[i] for i in which],
                                method=name)
    out["train"], new = model.apply(variables, *batches, train=True,
                                    mutable=["batch_stats"])
    out["stats"] = new["batch_stats"]
    return out


@pytest.fixture(scope="module", params=STYLES,
                ids=["-".join(s) for s in STYLES])
def case(request):
    """Per style: JAX variables drawn with numpy and the port's seeded
    state dict carried into JAX by the reference importer, with the JAX
    outputs of both."""
    style, teacher, student = request.param
    jcfg = jde.DualEncodingConfig(style=style, teacher_model=teacher,
                                  student_model=student, dropout=0.0,
                                  **SMALL)
    tcfg = tde.DualEncodingConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(21)
    frames, ids, bows, support = _inputs(rng, tcfg)
    jb = _batches(jde, frames, ids, bows, support)
    tb = _batches(tde, frames, ids, bows, support)
    model = jde.DualEncoding(jcfg)
    variables = _init(model, *jb, seed=5)
    port_sd = tde.seeded_state_dict(tcfg, seed=9)
    imported = convert_linas_dual_encoding(
        [s if s is None else {k: v.numpy() for k, v in s.items()}
         for s in reference_state_dicts(port_sd)], jcfg)
    run = jax.jit(functools.partial(_jax_outputs, model, _methods(tcfg)))
    return dict(tcfg=tcfg, tb=tb, variables=variables, port_sd=port_sd,
                want={"jax": run(variables, *jb),
                      "imported": run(imported, *jb)})


def _port(tcfg, sd):
    m = tde.DualEncoding(tcfg, device="cpu")
    m.load_state_dict(sd)
    return m


def _check(want, port, tb, cfg):
    with torch.no_grad():
        got = port(*tb)
    assert sorted(got) == sorted(want["forward"])
    for key, w in want["forward"].items():
        np.testing.assert_allclose(_np(got[key]), np.asarray(w), rtol=0,
                                   atol=EMB_TOL, err_msg=key)
    for name, which in _methods(cfg):
        with torch.no_grad():
            g = getattr(port, name)(*[tb[i] for i in which])
        assert g.shape == (4, cfg.common_dim)
        np.testing.assert_allclose(_np(g), np.asarray(want[name]), rtol=0,
                                   atol=EMB_TOL, err_msg=name)


def test_dual_encoding_from_jax_weights(case):
    """JAX variables -> the port's state dict -> the same embeddings."""
    port = _port(case["tcfg"], dual_encoding_state_dict_from_jax(
        case["variables"], case["tcfg"]))
    _check(case["want"]["jax"], port, case["tb"], case["tcfg"])


def test_dual_encoding_through_the_reference_importer(case):
    """The port's weights as the reference checkpoint's list of sub state
    dicts, read by the JAX importer, give the same embeddings."""
    subs = reference_state_dicts(case["port_sd"])
    assert all(s is not None for s in subs[:4])
    port = _port(case["tcfg"], case["port_sd"])
    _check(case["want"]["imported"], port, case["tb"], case["tcfg"])


def test_dual_encoding_variables_round_trip(case):
    """dual_encoding_variables_to_jax inverts the mapping leaf for leaf."""
    variables = case["variables"]
    back = dual_encoding_variables_to_jax(
        dual_encoding_state_dict_from_jax(variables, case["tcfg"]))
    want = jax.tree.map(np.asarray, variables)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_dual_encoding_train_mode_matches_jax(case):
    """With dropout 0 the train-mode forward (BN batch statistics) gives
    the JAX outputs and the JAX running statistics."""
    tcfg, want = case["tcfg"], case["want"]["jax"]
    port = _port(tcfg, dual_encoding_state_dict_from_jax(
        case["variables"], tcfg))
    port.train()
    with torch.no_grad():
        got = port(*case["tb"])
    for key, w in want["train"].items():
        np.testing.assert_allclose(_np(got[key]), np.asarray(w), rtol=0,
                                   atol=EMB_TOL, err_msg=key)
    new_sd = dual_encoding_state_dict_from_jax(
        {"params": case["variables"]["params"],
         "batch_stats": want["stats"]}, tcfg)
    for key, t in port.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(_np(t), _np(new_sd[key]), rtol=0,
                                       atol=LAYER_TOL, err_msg=key)


def test_zero_length_captions_embed_like_jax(case):
    """Every case's text batch holds a caption of length 0 (no word in the
    vocabulary, no framing), which the tests above hold against JAX; a
    wave of nothing but such captions packs without raising and gives
    that row's embedding."""
    tcfg, tb = case["tcfg"], case["tb"]
    port = _port(tcfg, dual_encoding_state_dict_from_jax(
        case["variables"], tcfg))
    text = tb[1]
    assert int(text.lengths[3]) == 0
    empty = tde.TextBatch(text.ids[[3, 3]], text.bows[[3, 3]],
                          text.lengths[[3, 3]], text.mask[[3, 3]])
    with torch.no_grad():
        got = port.embed_txt_GT(empty, tde.TextBatch(
            *(t[[3, 3]] for t in tb[2])))
    np.testing.assert_allclose(
        _np(got), np.repeat(np.asarray(case["want"]["jax"]["embed_txt_GT"])
                            [3:4], 2, 0), rtol=0, atol=EMB_TOL)


def test_config_fields_match_the_jax_config():
    """One config.json configures both packages: same fields, defaults."""
    assert dataclasses.asdict(tde.DualEncodingConfig()) == \
        dataclasses.asdict(jde.DualEncodingConfig())
    assert tde.DualEncodingConfig().text_feature_dim == \
        jde.DualEncodingConfig().text_feature_dim


def test_model_builds_without_random_draws():
    """Construction draws nothing; weights start at zero, BN variances at
    one, in eval mode, until a state dict is loaded."""
    m = tde.DualEncoding(tde.DualEncodingConfig(**SMALL), device="cpu")
    assert not m.training
    for k, t in m.state_dict().items():
        assert bool((t == (1 if k.endswith("running_var") else 0)).all()), k

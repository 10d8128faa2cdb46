"""The port's composed-retrieval models and host code against the JAX
package's, on the CPU: the BPE tokenizer, the preprocessing, the
ModifiedResNet (RN50x4-layout) CLIP tower, AttentionPool2d, the text
tower, the Combiner in both middle mixes, and the weight converters.

Weights are drawn from numpy seeds (the port's `random_state_dict`s) and
reach the JAX models through the JAX package's own importers
(convert_clip_resnet, convert_combiner) or the port's inverse converters.

Tolerances: f32 paths within 1e-5 relative to the largest reference value
(the two sides sum in different orders; observed near 1e-6).  Resizes:
1e-5 absolute against a float64 product with jax.image's weight matrix;
against jax.image.resize itself 1e-5 when shrinking and 2e-4 when
growing, because XLA's CPU product for an upsampling resize is 8e-5 from
float64 on N(0, 1) inputs while the port's is 4e-7.  clip_preprocess
returns bf16: elements may differ by one bf16 step (1/64 at |x| < 4)
where the f32 values round to two sides, in at most 1% of them.  Combiner
logits carry the scale 100, so 1e-5 relative of their largest value."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_modal_video_engine_tpu.convert import (convert_clip_resnet,
                                                  convert_combiner)
from cross_modal_video_engine_tpu.models import clip_resnet as jrn
from cross_modal_video_engine_tpu.models import combiner as jcomb
from cross_modal_video_engine_tpu.ops import preprocess as jpre
from cross_modal_video_engine_tpu.utils import bpe as jbpe
from cross_modal_video_engine_tpu_torch.convert import from_jax as fj
from cross_modal_video_engine_tpu_torch.models import clip_resnet as trn
from cross_modal_video_engine_tpu_torch.models import combiner as tcomb
from cross_modal_video_engine_tpu_torch.ops import preprocess as tpre
from cross_modal_video_engine_tpu_torch.utils import bpe as tbpe

REL = 1e-5


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


def close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


# -- BPE ----------------------------------------------------------------------

CORPUS = ["a dog runs in the park", "the red car drives on the road",
          "make it red", "a person is running with a dog",
          "two dogs play in the snow", "the car is red and fast"]
TEXTS = ["make the dog red", "Two  CARS &amp; a dog's ball!!", "snow_day 42",
         "unseen wörds ünicode", "", "a " * 60]


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    paths = (str(d / "j.txt"), str(d / "t.txt"))
    jbpe.write_toy_merges(paths[0], CORPUS, n_merges=48)
    tbpe.write_toy_merges(paths[1], CORPUS, n_merges=48)
    return paths


def test_toy_merges_file_is_the_same(merges):
    with open(merges[0]) as a, open(merges[1]) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("context_length", [77, 12])
def test_bpe_tokenize_equals_the_original(merges, context_length):
    jt, tt = jbpe.BPETokenizer(merges[0]), tbpe.BPETokenizer(merges[0])
    want = jt.tokenize(TEXTS, context_length)
    got = tt.tokenize(TEXTS, context_length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text)
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    assert (tt.sot, tt.eot, tt.vocab_size) == (jt.sot, jt.eot, jt.vocab_size)


def test_bpe_refuses_a_long_text_without_truncate(merges):
    tt = tbpe.BPETokenizer(merges[0])
    with pytest.raises(RuntimeError, match="too long"):
        tt.tokenize("a " * 60, 12, truncate=False)


# -- preprocessing ------------------------------------------------------------

SHRINK, GROW = (1, 480, 640, 3), (2, 120, 160, 3)


def frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(54, 72), (150, 200)],
                         ids=["shrink", "grow"])
def test_resize_is_jax_image_resize(method, size):
    x = np.random.default_rng(1).standard_normal((2, 96, 128, 3)
                                                 ).astype(np.float32)
    got = tpre.resize(torch.from_numpy(x), size, method).numpy()
    # float64 with jax.image's own weight matrices
    from jax._src.image.scale import (_fill_keys_cubic_kernel,
                                      _fill_triangle_kernel,
                                      compute_weight_mat)
    kernel = (_fill_triangle_kernel if method == "bilinear"
              else _fill_keys_cubic_kernel)
    wh, ww = (np.asarray(compute_weight_mat(n, m, m / n, 0.0, kernel, True),
                         np.float64) for n, m in zip((96, 128), size))
    np.testing.assert_allclose(tpre.resize_weights(96, size[0], method),
                               wh, rtol=0, atol=1e-7)
    f64 = np.einsum("fhwc,hk->fkwc", x.astype(np.float64), wh)
    f64 = np.einsum("fkwc,wl->fklc", f64, ww)
    np.testing.assert_allclose(got, f64, rtol=0, atol=1e-5)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3),
                                       method))
    tol = 1e-5 if size[0] < 96 and size[1] < 128 else 2e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dim", [288, 224])
@pytest.mark.parametrize("pad", ["targetpad", "squarepad", None])
@pytest.mark.parametrize("shape", [SHRINK, GROW], ids=["shrink", "grow"])
def test_clip_preprocess_matches_jax(shape, pad, dim):
    fr = frames(shape)
    want = np.asarray(jpre.clip_preprocess(jnp.asarray(fr), dim=dim,
                                           pad=pad), np.float32)
    out = tpre.clip_preprocess(torch.from_numpy(fr), dim=dim, pad=pad)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    assert got.shape == want.shape == (shape[0], dim, dim, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** -6, diff.max()
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("shape", [SHRINK, GROW], ids=["shrink", "grow"])
def test_preprocess_frames_bilinear_matches_jax(shape):
    fr = frames(shape, 2)
    for unit, mean, std in ((True, tpre.CLIP_MEAN, tpre.CLIP_STD),
                            (False, tpre.TSF_MEAN, tpre.TSF_STD)):
        want = np.asarray(jpre.preprocess_frames(
            jnp.asarray(fr), 128, 112, mean, std, unit, "float32"))
        got = tpre.preprocess_frames(torch.from_numpy(fr), 128, 112, mean,
                                     std, unit, "float32").numpy()
        close(got, want, 2e-5)
    bf = tpre.preprocess_frames(torch.from_numpy(fr), 128, 112)
    assert bf.dtype == torch.bfloat16 and bf.shape == (shape[0], 112, 112, 3)


@pytest.mark.parametrize("shape", [(1, 30, 50, 3), (1, 50, 30, 3),
                                   (1, 40, 44, 3)])
def test_pads_crop_and_short_side_match_jax(shape):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tpre._pad_to_square(t).numpy(),
                                  np.asarray(jpre._pad_to_square(x)))
    np.testing.assert_array_equal(tpre._target_pad(t, 1.25).numpy(),
                                  np.asarray(jpre._target_pad(x, 1.25)))
    np.testing.assert_array_equal(tpre._center_crop(t, 24).numpy(),
                                  np.asarray(jpre._center_crop(x, 24)))
    close(tpre._resize_short_side(t, 36).numpy(),
          np.asarray(jpre._resize_short_side(jnp.asarray(x), 36)), 2e-5)


# -- the ModifiedResNet CLIP tower --------------------------------------------

SMALL_RN = dict(embed_dim=24, vision_layers=(1, 2, 2, 1), vision_width=16,
                image_resolution=64, context_length=12, vocab_size=100,
                text_width=16, text_heads=2, text_layers=1)


@pytest.fixture(scope="module", params=[3, 2], ids=["layer3", "layer2"])
def rn(request):
    kw = dict(SMALL_RN, middle_stage=request.param)
    tcfg = trn.CLIPResNetConfig(**kw)
    sd = trn.random_state_dict(tcfg, seed=11)
    tm = trn.CLIPResNetModel(tcfg, device="cpu")
    tm.load_state_dict(sd)
    jcfg = jrn.CLIPResNetConfig(**kw)
    return tm, jrn.CLIPResNetModel(jcfg), convert_clip_resnet(sd, jcfg), sd


def images(n=2, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (n, 64, 64, 3)).astype(np.float32)


def test_random_state_dict_has_nontrivial_batchnorm_statistics(rn):
    sd = rn[3]
    var = sd["visual.layer1.0.bn1.running_var"]
    mean = sd["visual.layer3.0.downsample.1.running_mean"]
    assert float(var.min()) > 0.5 and float((var - 1).abs().max()) > 0.1
    assert float(mean.abs().max()) > 0.05


def test_encode_image_matches_jax(rn):
    tm, jm, jv, _ = rn
    x = images()
    want_h, want_m = jax.jit(functools.partial(
        jm.apply, method="encode_image"))(jv, jnp.asarray(x))
    with torch.no_grad():
        got_h, got_m = tm.encode_image(torch.from_numpy(x))
    close(got_h.numpy(), want_h)
    close(got_m.numpy(), want_m)


def test_middle_tokens_keep_the_nchw_buffer_order(rn):
    tm = rn[0]
    x = torch.from_numpy(images(1))
    with torch.no_grad():
        _, nchw = tm.visual(x)
        _, tokens = tm.encode_image(x)
    b, c, h, w = nchw.shape
    torch.testing.assert_close(tokens, nchw.reshape(b, h * w, c),
                               rtol=0, atol=0)
    assert not torch.equal(tokens, nchw.flatten(2).transpose(1, 2))


def test_bf16_pixels_widen_to_f32(rn):
    tm = rn[0]
    x = torch.from_numpy(images(1)).to(torch.bfloat16)
    with torch.no_grad():
        h16, m16 = tm.encode_image(x)
        h32, m32 = tm.encode_image(x.float())
    assert h16.dtype == m16.dtype == torch.float32
    torch.testing.assert_close(h16, h32, rtol=0, atol=0)


def test_attention_pool_matches_jax(rn):
    tm, _, jv, _ = rn
    pool = tm.visual.attnpool
    c = pool.q_proj.in_features
    x = np.random.default_rng(5).standard_normal((3, c, 2, 2)
                                                 ).astype(np.float32)
    jpool = jrn.AttentionPool2d(c, pool.heads, pool.c_proj.out_features)
    want = jpool.apply({"params": jv["params"]["visual"]["attnpool"]},
                       jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = pool(torch.from_numpy(x))
    close(got.numpy(), want)


def test_encode_text_matches_jax(rn):
    tm, jm, jv, _ = rn
    ids = np.zeros((3, 12), np.int64)
    ids[0, :4] = [5, 3, 7, 99]
    ids[1, :6] = [5, 9, 12, 4, 2, 99]
    ids[2, :12] = [5] + list(range(20, 30)) + [99]
    want = jax.jit(functools.partial(jm.apply, method="encode_text"))(
        jv, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = tm.encode_text(torch.from_numpy(ids))
    close(got.numpy(), want)


def test_clip_resnet_converters_invert_each_other(rn):
    tm, _, jv, sd = rn
    cfg = tm.rn_cfg
    tree = fj.clip_resnet_variables_to_jax(sd, cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jv)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
    back = fj.clip_resnet_state_dict_from_jax(jv, cfg)
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


# -- the Combiner -------------------------------------------------------------

COMB = dict(clip_feature_dim=32, projection_dim=24, hidden_dim=40)


def combiner_pair(mix, dropout=0.5, seed=21):
    cfg = tcomb.CombinerConfig(**COMB, middle_mix=mix, dropout=dropout)
    sd = tcomb.random_state_dict(cfg, seed)
    tm = tcomb.Combiner(cfg, device="cpu")
    tm.load_state_dict(sd)
    jm = jcomb.Combiner(jcomb.CombinerConfig(**COMB, middle_mix=mix,
                                             dropout=dropout))
    return tm, jm, fj.combiner_variables_to_jax(sd, cfg), sd


def combiner_inputs(b=3, f=4, seed=8):
    rng = np.random.default_rng(seed)
    d = COMB["clip_feature_dim"]
    return (rng.standard_normal((b, f, d)).astype(np.float32),
            rng.standard_normal((b, f, 16, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((b, f, d)).astype(np.float32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mix", ["dense", "conv4x4"])
def test_combiner_matches_jax(mix, train):
    """eval mode, and train mode at dropout 0 (where the mode changes
    nothing but the code path)."""
    tm, jm, jv, _ = combiner_pair(mix, dropout=0.0 if train else 0.5)
    high, middle, text, target = combiner_inputs()
    t = [torch.from_numpy(a) for a in (high, middle, text, target)]
    rngs = {"dropout": jax.random.key(0)}
    feats = (jnp.asarray(high), jnp.asarray(middle))
    want_p = jax.jit(functools.partial(
        jm.apply, train=train, method="combine_features"))(
            jv, feats, jnp.asarray(text), rngs=rngs)
    want_l = jax.jit(functools.partial(jm.apply, train=train))(
        jv, feats, jnp.asarray(text), (jnp.asarray(target), None),
        rngs=rngs)
    tm.train(train)
    with torch.no_grad():
        got_p = tm.combine_features((t[0], t[1]), t[2])
        got_l = tm((t[0], t[1]), t[2], (t[3], None))
    close(got_p.numpy(), want_p)
    close(got_l.numpy(), want_l)
    np.testing.assert_allclose(np.linalg.norm(got_p.numpy(), axis=1), 1.0,
                               rtol=1e-6)


def test_conv4x4_needs_sixteen_tokens():
    tm = combiner_pair("conv4x4")[0]
    high, middle, text, _ = combiner_inputs()
    with pytest.raises(ValueError, match="L == 16"):
        tm.combine_features((torch.from_numpy(high),
                             torch.from_numpy(middle[:, :, :8])),
                            torch.from_numpy(text))


def test_combiner_converters_match_the_jax_importer():
    """conv4x4 is the reference checkpoint's layout: the port's tree is
    what convert_combiner makes of the same state dict; both mixes invert
    exactly."""
    for mix in ("conv4x4", "dense"):
        tm, _, jv, sd = combiner_pair(mix)
        if mix == "conv4x4":
            want = convert_combiner(sd)
            for (pa, a), (pb, b) in zip(
                    jax.tree_util.tree_leaves_with_path(want),
                    jax.tree_util.tree_leaves_with_path(jv)):
                assert pa == pb
                np.testing.assert_array_equal(np.asarray(a), b)
        back = fj.combiner_state_dict_from_jax(jv, tm.cfg)
        assert back.keys() == sd.keys()
        for k in sd:
            torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_dropout_draws_from_the_module_generator():
    """Train mode at dropout 0.5: the seven dropouts take their masks from
    the generator a trainer sets, not from torch's global RNG."""
    from cross_modal_video_engine_tpu_torch.train.linas_trainer import (
        set_dropout_generator)
    tm = combiner_pair("dense", dropout=0.5)[0].train()
    high, middle, text, _ = (torch.from_numpy(a) for a in combiner_inputs())
    assert sum(isinstance(m, torch.nn.Dropout) for m in tm.modules()) == 7

    def run(seed):
        set_dropout_generator(tm, torch.Generator().manual_seed(seed))
        global_state = torch.get_rng_state()
        with torch.no_grad():
            out = tm.combine_features((high, middle), text)
        assert torch.equal(torch.get_rng_state(), global_state)
        return out

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    tm.eval()
    with torch.no_grad():
        e1 = tm.combine_features((high, middle), text)
        e2 = tm.combine_features((high, middle), text)
    assert torch.equal(e1, e2) and not torch.equal(e1, a)

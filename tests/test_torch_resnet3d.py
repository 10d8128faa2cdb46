"""The port's 3D-CNN backbones, heads and recognizers against the JAX
package's, on the CPU at a small size (stage_blocks (1, 1, 1, 1) or
(1, 2, 1, 1), base width 8, 8 frames of 32², X3D at widths 8-32).

One state dict drawn from a numpy seed loads into the port as it is and
into the JAX package through convert/torch_import.py's importers
(convert_resnet3d, convert_csn, convert_slowfast, convert_x3d), which are
the parity bridge.

* Forward in eval mode, at an even (32²) and an odd (33²) size (the
  stride-2 convs' padding): features within 1e-4 of the largest.
* Forward in train mode: features within 1e-4 of the largest, each
  running statistic after the forward within 1e-5 of its tensor's
  largest magnitude (flax's biased variance), except the non-local model
  (NL_STATS_TOL: JAX's f32 fast variance E[x²] - E[x]² loses digits on
  the non-local block's maps, whose mean lies far above their spread).
  In float64 in both
  packages (jax.enable_x64) every family but the non-local one, whose
  JAX attention runs in f32 whatever the input, agrees to 1e-9: the same
  arithmetic.
* The port's converters against the importers, both directions exact,
  for each backbone alone and under BackboneClassifier, X3DClassifier and
  RecognizerRelseq; the s2d stem against the plain conv in both packages
  and through SlowFast with the flag on and off; the stage maps; the
  recognizers' scores and decodes; flax's BatchNorm on 5-D inputs in f32
  and bf16; the training init's distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cross_modal_video_engine_tpu.convert import torch_import as ti
from cross_modal_video_engine_tpu.models import decoder_head as jdh
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import resnet3d as jr
from cross_modal_video_engine_tpu.ops import s2d_stem as js2d
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import resnet3d as tr
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
from cross_modal_video_engine_tpu_torch.models.layers import FlaxBatchNorm
from cross_modal_video_engine_tpu_torch.ops.s2d_stem import (
    s2d_kernel, s2d_stem_conv)
from torch_parity import max_rel, min_cosine

FWD_TOL = 1e-4               # of the largest feature, f32
STATS_TOL = 1e-5             # of each statistic's largest magnitude
NL_STATS_TOL = 3e-5          # the non-local model's statistics, f32
F64_TOL = 1e-9
CLASSES = 6
DECODER = dict(num_classes=5, max_len=3)

# name: (port backbone, port config, JAX backbone, JAX config, importer,
# config fields)
FAMILIES = {
    "i3d": ("ResNet3D", "ResNet3DConfig", ti.convert_resnet3d,
            dict(stage_blocks=(1, 1, 1, 1), base_channels=8,
                 conv1_kernel_t=5, stage_temporal_kernels=(3, 3, 3, 3))),
    "slowonly_nl": ("ResNet3D", "ResNet3DConfig", ti.convert_resnet3d,
                    dict(stage_blocks=(1, 2, 1, 1), base_channels=8,
                         non_local=((0,), (1, 0), (1,), (0,)))),
    "csn_ir": ("CSN", "CSNConfig", ti.convert_csn,
               dict(stage_blocks=(1, 1, 1, 1), base_channels=8, mode="ir")),
    "csn_ip": ("CSN", "CSNConfig", ti.convert_csn,
               dict(stage_blocks=(1, 1, 1, 1), base_channels=8, mode="ip")),
    "slowfast": ("SlowFast", "SlowFastConfig", ti.convert_slowfast,
                 dict(depth_blocks=(1, 1, 1, 1), base_channels=8, alpha=4,
                      beta_inv=4)),
    "slowfast_lateral_norm": ("SlowFast", "SlowFastConfig",
                              ti.convert_slowfast,
                              dict(depth_blocks=(1, 1, 1, 1),
                                   base_channels=8, alpha=4, beta_inv=4,
                                   lateral_norm=True)),
    "x3d_half": ("X3D", "X3DConfig", ti.convert_x3d,
                 dict(stage_blocks=(1, 2, 1, 1),
                      stage_channels=(8, 16, 24, 32), feat_dim=48)),
    "x3d_all": ("X3D", "X3DConfig", ti.convert_x3d,
                dict(stage_blocks=(1, 2, 1, 1),
                     stage_channels=(8, 16, 24, 32), feat_dim=48,
                     se_style="all")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread, and torch's global RNG and thread count left as
    found (tests/test_stgcn_conversion.py draws from the global RNG)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def random_conv_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Every float entry of the model's state dict redrawn from a numpy
    seed: convs and linears at lecun-normal scale, BatchNorm scales near
    1, biases small, running means small and variances in [0.5, 1.5), the
    decoder's start embedding at 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            out[k] = v.clone()
            continue
        shape, leaf = tuple(v.shape), k.rsplit(".", 1)[1]
        if leaf == "running_var":
            a = 0.5 + rng.random(shape)
        elif leaf == "running_mean" or k.endswith("bias") \
                or "bias_" in leaf:
            a = 0.05 * rng.standard_normal(shape)
        elif k.endswith("start_emb.weight"):
            a = rng.standard_normal(shape)
        elif v.dim() == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = int(np.prod(shape[1:])) ** -0.5 * rng.standard_normal(shape)
        out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def backbone_pair(name: str, seed: int = 3, **overrides):
    """(port backbone loaded with a seeded state dict, its state dict,
    the JAX backbone, its variables through the importer)."""
    tcls, cfg_name, importer, kw = FAMILIES[name]
    kw = dict(kw, **overrides)
    tm = getattr(tr, tcls)(getattr(tr, cfg_name)(**kw), device="cpu")
    sd = random_conv_state_dict(tm, seed)
    tm.load_state_dict(sd)
    jcfg = getattr(jr, cfg_name)(**kw)
    variables = importer({"backbone." + k: v for k, v in sd.items()}, jcfg)
    return tm, sd, getattr(jr, tcls)(jcfg), variables


def japply(jm, variables, *arrays, **kw):
    """jm.apply under jax.jit (one compile of the whole model, several
    times faster on the CPU than op by op); kw are static."""
    return jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(variables, *arrays)


def videos(batch: int = 2, frames: int = 8, size: int = 32,
           seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, frames, size, size, 3)).astype(np.float32)


def jax_stats_to_port(tm, stats) -> dict:
    """JAX batch_stats -> {port buffer name: numpy} through the port's
    converter."""
    return {k: v.numpy() for k, v in tconv.conv_recognizer_state_dict_from_jax(
        {"params": tconv.conv_recognizer_variables_to_jax(
            tm.state_dict(), tm)["params"], "batch_stats": stats},
        tm).items() if k.endswith(("running_mean", "running_var"))}


# -- forward ---------------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_eval_forward_matches_jax(name, size):
    tm, _, jm, variables = backbone_pair(name)
    x = videos(size=size)
    want = np.asarray(japply(jm, variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, tm.feat_dim)
    assert max_rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_forward_and_statistics_match_jax(name):
    tm, _, jm, variables = backbone_pair(name)
    x = videos(batch=4)
    want, mutated = japply(jm, variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    tm.train()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert max_rel(got, np.asarray(want)) <= FWD_TOL
    stats = dict(tm.state_dict())
    jstats = jax_stats_to_port(tm, mutated["batch_stats"])
    tol = NL_STATS_TOL if name == "slowonly_nl" else STATS_TOL
    for key, w in jstats.items():
        assert max_rel(stats[key].numpy(), w) <= tol, key
    # the statistics moved, by flax's update
    assert all(int(stats[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 1
               for k in jstats)


@pytest.mark.parametrize("name", [n for n in FAMILIES if n != "slowonly_nl"])
def test_train_forward_float64(name):
    tm, sd, jm, variables = backbone_pair(name)
    tm = tm.double()
    tm.load_state_dict(sd)
    x = videos(batch=4)
    tm.train()
    got = tm(torch.from_numpy(x).double()).detach().numpy()
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           variables)
        want, mutated = japply(jm, v64, jnp.asarray(x, jnp.float64),
                                 train=True, mutable=["batch_stats"])
        want = np.asarray(want)
        jstats = jax.tree.map(np.asarray, mutated["batch_stats"])
    assert want.dtype == np.float64
    assert max_rel(got, want) <= F64_TOL
    port = tconv.conv_recognizer_variables_to_jax(
        {k: v.float() if v.is_floating_point() else v
         for k, v in tm.state_dict().items()}, tm)["batch_stats"]
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(jstats)):
        assert max_rel(a, b) <= 1e-6           # the port's read back in f32


def test_stage_maps_match_jax():
    tm, _, jm, variables = backbone_pair("i3d")
    x = videos()
    want = japply(jm, variables, jnp.asarray(x), return_stages=True,
                  include_stem=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), return_stages=True, include_stem=True)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape                      # channels-last
        assert max_rel(g.numpy(), np.asarray(w)) <= FWD_TOL
    tm, _, jm, variables = backbone_pair("slowfast")
    want = japply(jm, variables, jnp.asarray(x), return_stages=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), return_stages=True)
    assert got[0].shape == want[0].shape and got[0].shape[1] == 1
    assert max_rel(got[0].numpy(), np.asarray(want[0])) <= FWD_TOL


def test_slowfast_layout():
    """The first slow block takes the lateral channels: it has a
    downsample even at stride 1; the lateral convs stride time by alpha;
    the fast pathway is 1/beta_inv as wide."""
    tm, sd, _, variables = backbone_pair("slowfast")
    first = tm.slow_path.layer1[0]
    assert first.downsample is not None
    assert first.conv2.conv.stride == (1, 1, 1)
    assert tm.slow_path.conv1_lateral.conv.stride == (4, 1, 1)
    assert tm.fast_path.conv1.conv.out_channels == 8 // 4
    assert "slow_l1_0" in variables["params"] \
        and "downsample" in variables["params"]["slow_l1_0"]
    assert "slow_path.layer1.0.downsample.conv.weight" in sd


# -- the s2d stem ------------------------------------------------------------------

@pytest.mark.parametrize("kt,stride_t", [(5, 1), (1, 1), (3, 2)])
def test_s2d_stem_matches_plain_conv_in_both_packages(kt, stride_t):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 6, 32, 24)).astype(np.float32)
    w = rng.standard_normal((8, 3, kt, 7, 7)).astype(np.float32) * 0.1
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = F.conv3d(xt, wt, stride=(stride_t, 2, 2),
                     padding=(kt // 2, 3, 3)).numpy()
    got = s2d_stem_conv(xt, wt, stride_t=stride_t).numpy()
    assert max_rel(got, plain) <= 1e-5
    want = np.asarray(js2d.s2d_stem_conv(
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
        jnp.asarray(w.transpose(2, 3, 4, 1, 0)), stride_t=stride_t))
    assert max_rel(got, want.transpose(0, 4, 1, 2, 3)) <= 1e-5
    # the retiled kernel is the JAX one, quadrant for quadrant
    k9 = np.asarray(js2d.s2d_kernel(jnp.asarray(w.transpose(2, 3, 4, 1, 0))))
    np.testing.assert_array_equal(s2d_kernel(wt).numpy(),
                                  k9.transpose(4, 3, 0, 1, 2))
    with pytest.raises(AssertionError):
        s2d_stem_conv(torch.zeros(1, 3, 4, 30, 32), wt)


def test_slowfast_s2d_stem_keeps_parameters_and_outputs():
    tm, sd, jm, variables = backbone_pair("slowfast")
    ts, _, js, jv = backbone_pair("slowfast", fast_s2d_stem=True)
    assert set(ts.state_dict()) == set(sd)
    ts.load_state_dict(sd)
    assert jax.tree.structure(jv) == jax.tree.structure(variables)
    x = videos()
    with torch.no_grad():
        plain, s2d = tm(torch.from_numpy(x)), ts(torch.from_numpy(x))
    assert max_rel(s2d.numpy(), plain.numpy()) <= 1e-5
    want = np.asarray(japply(js, variables, jnp.asarray(x)))
    assert max_rel(s2d.numpy(), want) <= FWD_TOL
    ts.train()
    got = ts(torch.from_numpy(x)).detach().numpy()
    want, _ = japply(js, variables, jnp.asarray(x), train=True,
                     mutable=["batch_stats"])
    assert max_rel(got, np.asarray(want)) <= FWD_TOL


# -- converters ----------------------------------------------------------------

def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


FAMILY_FNS = {"ResNet3D": "resnet3d", "CSN": "csn", "SlowFast": "slowfast",
              "X3D": "x3d"}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_backbone_converters_invert_the_importers(name):
    tm, sd, _, variables = backbone_pair(name)
    tcls, cfg_name, _, kw = FAMILIES[name]
    cfg = getattr(tr, cfg_name)(**kw)
    fam = FAMILY_FNS[tcls]
    to_jax = getattr(tconv, f"{fam}_variables_to_jax")(sd, cfg)
    _assert_trees_equal(to_jax, variables)
    back = getattr(tconv, f"{fam}_state_dict_from_jax")(variables, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def _wrapped(name: str, wrapper: str, seed: int = 5):
    """(port recognizer with a seeded state dict, its state dict, the JAX
    recognizer, its variables) for `wrapper` over backbone `name`."""
    tcls, cfg_name, importer, kw = FAMILIES[name]
    backbone = getattr(tr, tcls)(getattr(tr, cfg_name)(**kw), device="cpu")
    jbackbone = getattr(jr, tcls)(getattr(jr, cfg_name)(**kw))
    if wrapper == "classifier":
        tm = trec.BackboneClassifier(backbone, CLASSES)
        jm = jrec.BackboneClassifier(jbackbone, CLASSES)
    elif wrapper == "x3d_classifier":
        tm = trec.X3DClassifier(backbone, CLASSES, mid_channels=16)
        jm = jrec.X3DClassifier(jbackbone, CLASSES, mid_channels=16)
    else:
        dec = dict(DECODER, in_channels=backbone.feat_dim)
        tm = trec.RecognizerRelseq(backbone, RNNDecoderConfig(**dec))
        jm = jrec.RecognizerRelseq(jbackbone, jdh.RNNDecoderConfig(**dec))
    sd = random_conv_state_dict(tm, seed)
    tm.load_state_dict(sd)
    if wrapper == "x3d_classifier":
        variables = importer(sd, jbackbone.cfg)
    else:
        bb = importer({k: v for k, v in sd.items()
                       if k.startswith("backbone.")}, jbackbone.cfg)
        head = ({"fc_cls": {"kernel": sd["cls_head.fc_cls.weight"].numpy().T,
                            "bias": sd["cls_head.fc_cls.bias"].numpy()}}
                if wrapper == "classifier"
                else ti.convert_rnn_decoder_head(sd))
        variables = {"params": {"backbone": bb["params"], "cls_head": head},
                     "batch_stats": {"backbone": bb["batch_stats"]}}
    return tm, sd, jm, variables


WRAPPED = [("i3d", "classifier"), ("slowonly_nl", "relseq"),
           ("csn_ip", "classifier"), ("slowfast", "classifier"),
           ("slowfast_lateral_norm", "relseq"), ("x3d_half", "x3d_classifier"),
           ("x3d_all", "classifier"), ("x3d_half", "relseq")]


@pytest.mark.parametrize("name,wrapper", WRAPPED)
def test_recognizers_convert_both_ways_and_match_jax(name, wrapper):
    tm, sd, jm, variables = _wrapped(name, wrapper)
    _assert_trees_equal(tconv.conv_recognizer_variables_to_jax(sd, tm),
                        variables)
    back = tconv.conv_recognizer_state_dict_from_jax(variables, tm)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    x = videos(batch=4)
    with torch.no_grad():
        got = tm.forward_test(torch.from_numpy(x), num_segs=2).numpy()
    want = japply(jm, variables, jnp.asarray(x), num_segs=2,
                  method="forward_test")
    assert got.shape == np.asarray(want).shape
    assert max_rel(got, np.asarray(want)) <= FWD_TOL
    assert min_cosine(got, np.asarray(want)) >= 0.9999


def test_heads_dropout_in_train_mode_only():
    tm, _, _, _ = _wrapped("i3d", "classifier")
    assert tm.cls_head.dropout.p == 0.5          # SlowFast's too, as in JAX
    tm.cls_head.dropout.generator = torch.Generator().manual_seed(0)
    f = torch.ones(4, tm.backbone.feat_dim)
    assert torch.equal(tm.cls_head(f), tm.cls_head.fc_cls(f))
    tm.train()
    dropped = tm.cls_head.dropout(f)
    assert set(torch.unique(dropped).tolist()) <= {0.0, 2.0}


# -- flax's BatchNorm --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flax_batchnorm_matches_flax(dtype):
    from flax import linen as nn
    rng = np.random.default_rng(11)
    x = (2.0 + rng.standard_normal((3, 4, 5, 6, 7))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(7)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(7)).astype(np.float32)
    mean0, var0 = (0.1 * rng.standard_normal(7)).astype(np.float32), \
        (0.5 + rng.random(7)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    variables = {"params": {"scale": jnp.asarray(scale, jdt),
                            "bias": jnp.asarray(bias, jdt)},
                 "batch_stats": {"mean": jnp.asarray(mean0),
                                 "var": jnp.asarray(var0)}}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, mut = bn.apply(variables, jnp.asarray(x, jdt),
                         mutable=["batch_stats"])
    tb = FlaxBatchNorm(7, device="cpu").train()
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(scale).to(tdt).float())
        tb.bias.copy_(torch.from_numpy(bias).to(tdt).float())
        tb.running_mean.copy_(torch.from_numpy(mean0))
        tb.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x.transpose(0, 4, 1, 2, 3)).to(tdt)
    got = tb(xt).detach()
    assert got.dtype == tdt and tb.running_var.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert max_rel(got.float().numpy().transpose(0, 2, 3, 4, 1),
                   np.asarray(want, np.float32)) <= tol
    assert max_rel(tb.running_mean.numpy(),
                   np.asarray(mut["batch_stats"]["mean"])) <= 1e-5
    assert max_rel(tb.running_var.numpy(),
                   np.asarray(mut["batch_stats"]["var"])) <= 1e-5
    # eval mode normalizes by the running statistics
    tb.eval()
    bn_eval = nn.BatchNorm(use_running_average=True, momentum=0.9,
                           epsilon=1e-5)
    want = bn_eval.apply({"params": variables["params"],
                          "batch_stats": mut["batch_stats"]},
                         jnp.asarray(x, jdt))
    assert max_rel(tb(xt).detach().float().numpy().transpose(0, 2, 3, 4, 1),
                   np.asarray(want, np.float32)) <= tol


def test_csn_batchnorm_eps():
    def bns(model):
        return [m for m in model.modules() if isinstance(m, FlaxBatchNorm)]

    tm, _, _, _ = backbone_pair("csn_ip")
    assert {m.eps for m in bns(tm)} == {1e-3}
    tm, _, _, _ = backbone_pair("i3d")
    assert {m.eps for m in bns(tm)} == {1e-5}
    assert {m.momentum for m in bns(tm)} == {0.1}


# -- the training init ------------------------------------------------------------

def test_conv_init_follows_flax_init_schemes():
    """conv_init_state_dict draws what the JAX modules' init draws: the
    same zeros and ones, and per kernel of 200 or more elements the same
    spread within 25%."""
    for name, wrapper in (("slowonly_nl", "relseq"),
                          ("x3d_half", "x3d_classifier")):
        tm, _, jm, _ = _wrapped(name, wrapper)
        sd = trec.conv_init_state_dict(tm, seed=0)
        assert set(sd) == set(tm.state_dict())
        x = jnp.zeros((1, 8, 32, 32, 3), jnp.float32)
        kw = {"mode": "inference"} if wrapper == "relseq" else {}
        jv = jax.jit(lambda k, a: jm.init(k, a, **kw))(jax.random.key(0), x)
        jsd = tconv.conv_recognizer_state_dict_from_jax(
            jax.tree.map(np.asarray, jv), tm)
        for k, v in sd.items():
            w = jsd[k].numpy() if k in jsd else None
            if w is None or not v.is_floating_point():
                continue
            g = v.numpy()
            if np.all(w == w.flat[0]):
                np.testing.assert_array_equal(g, w, err_msg=k)
            elif w.size >= 200:
                assert abs(g.std() / w.std() - 1) <= 0.25, k

"""The port's TPN neck and TPNRecognizer against the JAX package's, on the
CPU at a small size: the neck alone on stage maps of 16 and 32 channels
(8² and 4², 2 to 5 frames), and over a ResNet3D (stage_blocks (1, 1, 1,
1), base 4, 4 frames of 32²); neck widths 8-40, groups 4.

One state dict drawn from a numpy seed loads into the port as it is and
into the JAX package through convert_resnet3d and convert_tpn (the
TPNRecognizer's `cls_head.fc_cls`, which no importer reads, through the
port's convert/from_jax.py).

* The neck in eval and train mode for three flows: 'cascade' with a
  top-down upsample (T 4 and 2), 'parallel' with the ceil-mode temporal
  pools (T 5 and 4 at scales 3 and 2, the tails padded with -inf),
  'cascade' at scale 2 on 5 frames: features within FWD_TOL (1e-5,
  train TRAIN_TOL 1e-4) of the largest, `loss_aux` within 1e-5 relative,
  running statistics within 1e-5 of their largest; the aux head's and the
  classifier's dropout masks handed to both packages.
* `resample_t` at ratios that are not whole numbers: up as
  jax.image.resize's 'nearest' (torch's 'nearest-exact'), down as flax's
  floor-mode max pool; the ceil-mode pool; the spatial ladder keyed on the
  channel ratio.
* TPNRecognizer: eval logits and `forward_test`, the converters against
  the importers both ways, one `make_tpn_train_step_stats` step against
  JAX's (loss, `loss_cls`, gradients within 1e-4 of each tensor's
  largest, parameters and statistics after it), and the bf16 step (f32
  masters and statistics, the loss within 2e-2 of JAX's bf16 and of the
  f32 step's, the gradients by group as close to the f32 step's as
  test_torch_recognizer2d's bf16 test holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from cross_modal_video_engine_tpu.convert import torch_import as ti
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import resnet3d as jr
from cross_modal_video_engine_tpu.models import tpn as jtpn
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import resnet3d as tr
from cross_modal_video_engine_tpu_torch.models import tpn as ttpn
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from test_torch_recognizer2d import (BF16_MARGIN, _jax_state, _optimizers,
                                     check_step, draw_masks,
                                     same_random)  # noqa: F401
from test_torch_resnet3d import japply, random_conv_state_dict
from test_torch_resnet3d_train import _group_cosines
from torch_parity import max_rel

FWD_TOL, TRAIN_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5
CLASSES, AUX, BATCH = 6, 5, 3
NECK = dict(in_channels=(16, 32), out_channels=16, mid_channels=8,
            lf_out_channels=24, fusion_channels=40, groups=4,
            aux_num_classes=AUX, aux_loss_weight=0.5)
# case: (config fields, frames of the two stage maps)
CASES = {"cascade_up": (dict(downsample_scales=(1, 1)), (4, 2)),
         "parallel_ceil": (dict(downsample_scales=(3, 2),
                                flow_type="parallel"), (5, 4)),
         "cascade_ceil": (dict(downsample_scales=(2, 2)), (5, 5))}
BACKBONE = dict(stage_blocks=(1, 1, 1, 1), base_channels=4)
REC_NECK = dict(NECK, in_channels=(64, 128), downsample_scales=(2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def neck_pair(case: str, seed: int = 11):
    fields, frames = CASES[case]
    kw = dict(NECK, **fields)
    tm = ttpn.TPN(ttpn.TPNConfig(**kw), device="cpu")
    sd = random_conv_state_dict(tm, seed)
    tm.load_state_dict(sd)
    jcfg = jtpn.TPNConfig(**kw)
    variables = ti.convert_tpn({"neck." + k: v for k, v in sd.items()},
                               jcfg)
    rng = np.random.default_rng(seed + 1)
    stages = [rng.standard_normal((BATCH, c, t, s, s)).astype(np.float32)
              for c, t, s in zip((16, 32), frames, (8, 4))]
    return tm, sd, jtpn.TPN(jcfg), variables, stages


def _last(a):
    return jnp.asarray(a.transpose(0, 2, 3, 4, 1))


@pytest.mark.parametrize("case", list(CASES))
def test_neck_eval_matches_jax(case):
    tm, _, jm, variables, stages = neck_pair(case)
    want, aux = japply(jm, variables, [_last(s) for s in stages])
    with torch.no_grad():
        got, taux = tm([torch.from_numpy(s) for s in stages])
    assert aux == {} and taux == {}
    got = got.numpy().transpose(0, 2, 3, 4, 1)
    assert got.shape == np.asarray(want).shape
    assert max_rel(got, np.asarray(want)) <= FWD_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_neck_train_aux_loss_and_statistics_match_jax(case, same_random):
    tm, _, jm, variables, stages = neck_pair(case)
    same_random(masks=draw_masks([(BATCH, 32)], 0.5))
    target = np.random.default_rng(2).integers(0, AUX, BATCH)
    (want, aux), mutated = japply(
        jm, variables, [_last(s) for s in stages],
        target=jnp.asarray(target), train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(0)})
    tm.train()
    got, taux = tm([torch.from_numpy(s) for s in stages],
                   torch.from_numpy(target))
    assert max_rel(got.detach().numpy().transpose(0, 2, 3, 4, 1),
                   np.asarray(want)) <= TRAIN_TOL
    jaux = float(aux["loss_aux"])
    assert abs(float(taux["loss_aux"]) - jaux) <= 1e-5 * abs(jaux)
    stats = tconv.conv_recognizer_state_dict_from_jax(
        {"params": variables["params"],
         "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])},
        tm)
    for key, b in tm.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            assert max_rel(b.numpy(), stats[key].numpy()) <= STATS_TOL, key


def test_neck_converters_invert_the_importer():
    tm, sd, _, variables, _ = neck_pair("parallel_ceil")
    cfg = tm.cfg
    got = tconv.tpn_variables_to_jax(sd, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, np.asarray(b))
    back = tconv.tpn_state_dict_from_jax(variables, cfg)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


# -- the resampling and the ladder --------------------------------------------

@pytest.mark.parametrize("t_in,t_out", [(3, 8), (4, 6), (2, 5), (8, 3),
                                        (7, 2), (6, 6)])
def test_resample_t_matches_jax(t_in, t_out):
    """Up: half-pixel nearest (jax.image.resize 'nearest'); down: a
    floor-mode max pool of t_in // t_out (so 8 -> 3 gives 4 frames, as
    JAX's does)."""
    x = np.random.default_rng(t_in * 10 + t_out).standard_normal(
        (2, t_in, 3, 2, 5)).astype(np.float32)
    if t_in < t_out:
        want = jax.image.resize(jnp.asarray(x), (2, t_out, 3, 2, 5),
                                "nearest")
    elif t_in > t_out:
        s = t_in // t_out
        want = nn.max_pool(jnp.asarray(x), (s, 1, 1), strides=(s, 1, 1))
    else:
        want = x
    got = ttpn.resample_t(torch.from_numpy(x.transpose(0, 4, 1, 2, 3)),
                          t_out).numpy().transpose(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_temporal_pool_is_ceil_mode():
    x = torch.arange(5.0).reshape(1, 1, 5, 1, 1)
    got = ttpn.temporal_pool_ceil(x, 3).flatten().tolist()
    assert got == [2.0, 4.0]              # the tail window: frames 3, 4
    assert ttpn.temporal_pool_ceil(-x, 3).flatten().tolist() == [0.0, -3.0]


@pytest.mark.parametrize("in_channels,steps", [((16, 64), [2, 0]),
                                               ((32, 32), [0, 0]),
                                               ((16, 32, 64), [2, 1, 0])])
def test_spatial_ladder_is_keyed_on_channels(in_channels, steps):
    tm = ttpn.TPN(ttpn.TPNConfig(in_channels=in_channels, out_channels=8,
                                 mid_channels=8, lf_out_channels=8,
                                 fusion_channels=8, groups=4,
                                 downsample_scales=(1,) * len(in_channels)),
                  device="meta")
    ladders = tm.spatial_modulation.spatial_modulation
    assert [len(l) for l in ladders] == steps
    assert tm.aux_head is None


# -- TPNRecognizer ------------------------------------------------------------

def rec_pair(seed: int = 13, dropout: float = 0.5):
    tm = trec.TPNRecognizer(tr.ResNet3D(tr.ResNet3DConfig(**BACKBONE),
                                        device="cpu"),
                            ttpn.TPNConfig(**REC_NECK), CLASSES, dropout)
    sd = random_conv_state_dict(tm, seed)
    tm.load_state_dict(sd)
    jm = jrec.TPNRecognizer(jr.ResNet3D(jr.ResNet3DConfig(**BACKBONE)),
                            jtpn.TPNConfig(**REC_NECK), CLASSES, dropout)
    return tm, sd, jm, tconv.conv_recognizer_variables_to_jax(sd, tm)


def rec_clips(seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (BATCH, 4, 32, 32, 3)).astype(np.float32)


def test_recognizer_converters_are_the_importers():
    tm, sd, _, variables = rec_pair()
    bb = ti.convert_resnet3d({k: v for k, v in sd.items()
                              if k.startswith("backbone.")},
                             jr.ResNet3DConfig(**BACKBONE))
    neck = ti.convert_tpn(sd, jtpn.TPNConfig(**REC_NECK))
    for part, want in (("backbone", bb), ("neck", neck)):
        for coll in ("params", "batch_stats"):
            got = variables[coll][part]
            assert jax.tree.structure(got) == jax.tree.structure(want[coll])
            for a, b in zip(jax.tree.leaves(got),
                            jax.tree.leaves(want[coll])):
                np.testing.assert_array_equal(a, np.asarray(b))
    assert set(variables["params"]["cls_head"]) == {"kernel", "bias"}
    back = tconv.conv_recognizer_state_dict_from_jax(variables, tm)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_recognizer_eval_logits_match_jax():
    tm, _, jm, variables = rec_pair()
    x = rec_clips()
    want = np.asarray(japply(jm, variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (BATCH, CLASSES)
    assert max_rel(got, want) <= FWD_TOL
    x2 = np.concatenate([x, rec_clips(4)])
    want = np.asarray(japply(jm, variables, jnp.asarray(x2), num_segs=2,
                             method="forward_test"))
    with torch.no_grad():
        got = tm.forward_test(torch.from_numpy(x2), num_segs=2).numpy()
    assert max_rel(got, want) <= FWD_TOL


def test_tpn_stats_step_matches_jax(same_random):
    """One step: the classifier's cross entropy plus loss_aux, both
    dropouts' masks handed to both packages."""
    tm, _, jm, variables = rec_pair()
    same_random(masks=draw_masks([(BATCH, 128), (BATCH, 40)], 0.5))
    x = rec_clips(5)
    lab = np.random.default_rng(6).integers(0, CLASSES, BATCH)
    jtx, ttx = _optimizers()
    jstate, jstats, jlogs = jrt.make_tpn_train_step_stats(jm, jtx)(
        _jax_state(variables, jtx), variables["batch_stats"],
        jnp.asarray(x), jnp.asarray(lab, jnp.int32), jax.random.key(0))
    tstate, tlogs = trt.make_tpn_train_step_stats(tm, device="cpu")(
        trt.init_rec_state(tm, ttx), torch.from_numpy(x),
        torch.from_numpy(lab))
    check_step(tm, jstate, jstats, tlogs, jlogs)
    jcls = float(jlogs["loss_cls"])
    assert abs(float(tlogs["loss_cls"]) - jcls) <= 1e-5 * abs(jcls)
    assert float(tlogs["loss"]) > float(tlogs["loss_cls"])   # loss_aux
    assert float(tlogs["top1_acc"]) == float(jlogs["top1_acc"])


def test_tpn_bf16_step_matches_jax(same_random):
    tm, _, jm, variables = rec_pair(dropout=0.0)
    same_random(masks=draw_masks([(BATCH, 128)], 0.5))      # the aux head
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    x = rec_clips(7)
    lab = np.random.default_rng(8).integers(0, CLASSES, BATCH)
    grads, losses = {}, {}
    for bf16 in (False, True):
        jtx, ttx = _optimizers()
        jstate, _, jlogs = jrt.make_tpn_train_step_stats(jm, jtx, bf16=bf16)(
            _jax_state(variables, jtx), variables["batch_stats"],
            jnp.asarray(x), jnp.asarray(lab, jnp.int32), jax.random.key(0))
        tm.load_state_dict(sd)
        _, tlogs = trt.make_tpn_train_step_stats(tm, bf16=bf16,
                                                 device="cpu")(
            trt.init_rec_state(tm, ttx), torch.from_numpy(x),
            torch.from_numpy(lab))
        grads[bf16] = ({n: p.grad.clone() for n, p in tm.named_parameters()},
                       tconv.conv_recognizer_state_dict_from_jax(
                           {"params": jax.tree.map(np.asarray,
                                                   jstate.opt_state[0])}, tm))
        losses[bf16] = (float(tlogs["loss"]), float(jlogs["loss"]))
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        assert all(b.dtype == torch.float32 for n, b in tm.named_buffers()
                   if n.endswith(("running_mean", "running_var")))
    port, jax_ = losses[True]
    assert abs(port - jax_) <= 2e-2 * abs(jax_)
    assert abs(port - losses[False][0]) <= 2e-2 * abs(port)
    cos = _group_cosines(grads[True][0], {
        n: g.numpy() for n, g in grads[False][1].items()})
    jax_own = _group_cosines(
        {n: torch.as_tensor(g) for n, g in grads[True][1].items()},
        {n: g.numpy() for n, g in grads[False][1].items()})
    for group, c in cos.items():
        assert c >= min(0.99, jax_own[group]) - BF16_MARGIN, (cos, jax_own)

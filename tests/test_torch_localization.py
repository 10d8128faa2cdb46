"""The temporal-localization models, losses, labels, sampler, datasets,
pipeline ops, metrics and train steps of the PyTorch port against the JAX
package, on the CPU at the JAX tests' small shapes (BMN T=20, N=4, D=20,
hidden 16/8/16; TEM hidden 16; PEM 24-wide features; SSN T=24, 3
classes).

Tolerances, f32 on both sides: forwards within 1e-5 of each output's
largest magnitude; losses within 1e-5 relative and their gradients within
1e-4 of each gradient's largest magnitude; one step of each step maker
from the same state: the loss within 1e-5 relative, each gradient within
1e-4 of its largest magnitude, each parameter after the step within 1e-5
of its largest (under Adam, the elements whose gradient is below 1e-6 are
held to 2 lr: Adam turns rounding noise into a step of +-lr).  The host
code (labels, sampler, datasets, ops, metrics, proposal post-processing,
the sampling matrix) is equal, bit for bit.  The losses that subsample
take the JAX key's own uniforms, handed to the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cross_modal_video_engine_tpu.data import datasets_extra as jds
from cross_modal_video_engine_tpu.data import pipelines_extra as jpe
from cross_modal_video_engine_tpu.losses import localization as jl
from cross_modal_video_engine_tpu.metrics import proposals as jmet
from cross_modal_video_engine_tpu.models import bmn as jbmn
from cross_modal_video_engine_tpu.models import bsn as jbsn
from cross_modal_video_engine_tpu.models import ssn as jssn
from cross_modal_video_engine_tpu.train import localization_trainer as jlt
from cross_modal_video_engine_tpu_torch.convert import from_jax as cv
from cross_modal_video_engine_tpu_torch.data import datasets_extra as tds
from cross_modal_video_engine_tpu_torch.data.pipelines import build_pipeline
from cross_modal_video_engine_tpu_torch.losses import localization as tl
from cross_modal_video_engine_tpu_torch.metrics import proposals as tmet
from cross_modal_video_engine_tpu_torch.models import bmn as tbmn
from cross_modal_video_engine_tpu_torch.models import bsn as tbsn
from cross_modal_video_engine_tpu_torch.models import ssn as tssn
from cross_modal_video_engine_tpu_torch.models.recognizer import (
    conv_init_state_dict)
from cross_modal_video_engine_tpu_torch.train import (
    localization_trainer as tlt)

from torch_parity import capturing, max_rel, random_variables, to_np

FWD_TOL, LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-5, 1e-4, 1e-5
ADAM_NOISE = 1e-6
BMN_CFG = dict(temporal_dim=20, feat_dim=8, num_samples=4, max_duration=20,
               hidden_1d=16, hidden_2d=8, hidden_3d=16)
SSN_CFG = dict(feat_dim=8, num_classes=3, parts=(1, 2, 1), hidden=16)
SAMPLER = dict(positive_per_video=1, incomplete_per_video=2,
               background_per_video=1, background_coverage=0.02)


@pytest.fixture(autouse=True)
def _torch_rng():
    with torch.random.fork_rng():
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _feats(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the models through the converters, both ways -----------------------------

def _pair(kind):
    """(JAX module, its random variables, the port's module loaded from
    them, one input batch as numpy arrays)."""
    if kind == "bmn":
        jm = jbmn.BMN(jbmn.BMNConfig(**BMN_CFG))
        tm = tbmn.BMN(tbmn.BMNConfig(**BMN_CFG), device="cpu")
        args = (_feats(1, 2, 20, 8),)
    elif kind == "tem":
        jm, tm = jbsn.TEM(hidden=16), tbsn.TEM(8, 16, device="cpu")
        args = (_feats(2, 2, 16, 8),)
    elif kind == "pem":
        jm, tm = jbsn.PEM(hidden=16), tbsn.PEM(24, 16, device="cpu")
        args = (_feats(3, 20, 24),)
    else:
        jm = jssn.SSNHead(jssn.SSNConfig(**SSN_CFG))
        tm = tssn.SSNHead(tssn.SSNConfig(**SSN_CFG), device="cpu")
        rng = np.random.default_rng(4)
        props = np.sort(rng.uniform(0, 24, (2, 5, 2)), -1)
        args = (_feats(4, 2, 24, 8),
                np.stack([tssn.stpp_matrix(24, p) for p in props]))
    init_args = args if kind != "ssn" else (args[0][0], args[1][0])
    v = random_variables(jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), *map(jnp.asarray, init_args))), seed=7)
    tm.load_state_dict(getattr(cv, f"{'ssn_head' if kind == 'ssn' else kind}"
                                   f"_state_dict_from_jax")(v))
    return jm, v, tm, args


@pytest.mark.parametrize("kind", ["bmn", "tem", "pem", "ssn"])
def test_forward_matches_jax(kind):
    jm, v, tm, args = _pair(kind)
    if kind == "ssn":     # the JAX head takes one video; the port a batch
        outs = [jm.apply(v, *map(jnp.asarray, (f, s))) for f, s in
                zip(*args)]
        want = {k: np.stack([np.asarray(o[k]) for o in outs])
                for k in outs[0]}
    else:
        want = jm.apply(v, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tm(*map(_t, args))
    if kind == "pem":
        got, want = {"score": got}, {"score": want}
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
        assert max_rel(to_np(got[k]), want[k]) <= FWD_TOL, k
    to_jax = getattr(cv, f"{'ssn_head' if kind == 'ssn' else kind}"
                         f"_variables_to_jax")
    back = to_jax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(v)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, v)))


@pytest.mark.parametrize("size", [(20, 4, 20), (33, 7, 12)])
def test_sampling_matrix_bit_equal(size):
    want = jbmn.bm_sampling_matrix(*size)
    got = tbmn.bm_sampling_matrix(*size)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(tbmn.sampling_matrix(*size), want)


def test_sampling_matrix_is_a_buffer_outside_the_state_dict():
    m = tbmn.BMN(tbmn.BMNConfig(**BMN_CFG), device="cpu")
    assert "sampling" not in m.state_dict()
    assert m.sampling.shape == (20, 4 * 20 * 20)
    assert tbmn.sampling_matrix(20, 4, 20) is tbmn.sampling_matrix(20, 4, 20)


@pytest.mark.parametrize("kind", ["bmn", "tem", "pem", "ssn"])
def test_training_init(kind):
    """conv_init_state_dict draws every parameter of a localizer: kernels
    at lecun-normal scale (fan-in: input channels per group x kernel
    volume), biases zero."""
    tm = _pair(kind)[2]
    sd = conv_init_state_dict(tm, 0)
    assert sorted(sd) == sorted(tm.state_dict())
    for name, w in sd.items():
        if name.endswith("bias"):
            assert not w.any(), name
        elif w.numel() >= 200:
            fan_in = int(np.prod(w.shape[1:]))
            assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.25, name


# -- the losses and their gradients -------------------------------------------

def _uniforms(key, shape):
    km, kl = jax.random.split(key)
    return (np.asarray(jax.random.uniform(km, shape)),
            np.asarray(jax.random.uniform(kl, shape)))


def _loss_cases():
    rng = np.random.default_rng(11)
    D = T = 12
    pred = rng.uniform(0.02, 0.98, (2, D, T)).astype(np.float32)
    iou = rng.uniform(0, 1, (2, D, T)).astype(np.float32) ** 2
    mask = np.broadcast_to(jlt.bm_mask(T, D), (2, D, T)).astype(np.float32)
    seq = rng.uniform(0.02, 0.98, (4, 2, T)).astype(np.float32)
    lab = rng.uniform(0, 1, (3, 2, T)).astype(np.float32)
    piou = rng.uniform(0, 1, 40).astype(np.float32)
    ppred = rng.uniform(0, 1, 40).astype(np.float32)
    key = jax.random.key(5)
    # SSN: 2 videos of [1 positive, 2 incomplete, 1 background]
    n, c = 8, 3
    act = rng.standard_normal((n, c + 1)).astype(np.float32)
    comp = rng.standard_normal((n, c)).astype(np.float32)
    reg = rng.standard_normal((n, c, 2)).astype(np.float32)
    ptype = np.array([0, 1, 1, 2] * 2, np.int32)
    labels = np.array([2, 1, 3, 0, 3, 3, 2, 0], np.int32)
    targets = rng.standard_normal((n, 2)).astype(np.float32)
    ssn_kw = dict(positive_per_video=1, background_per_video=1,
                  incomplete_per_video=2)
    u_iou = _uniforms(key, iou.shape)
    u_piou = _uniforms(key, piou.shape)
    # (name, JAX fn, port fn, differentiable args, other args,
    #  port-only keyword arguments)
    return {
        "blr": (jl.binary_logistic_regression_loss,
                tl.binary_logistic_regression_loss, (seq[0],), (lab[0],), {}),
        "bmn_tem": (jl.bmn_tem_loss, tl.bmn_tem_loss, (seq[0], seq[1]),
                    (lab[0], lab[1]), {}),
        "bmn_pem_reg": (jl.bmn_pem_reg_loss, tl.bmn_pem_reg_loss, (pred,),
                        (iou * mask, mask, key), {"draws": u_iou}),
        "bmn_pem_cls": (jl.bmn_pem_cls_loss, tl.bmn_pem_cls_loss, (pred,),
                        (iou * mask, mask), {}),
        "bmn_loss": (lambda *a: jl.bmn_loss(*a)[0],
                     lambda *a, **k: tl.bmn_loss(*a, **k)[0],
                     (pred, pred[::-1].copy(), seq[0], seq[1]),
                     (iou, lab[0], lab[1], mask, key), {"draws": u_iou}),
        "bsn_tem": (lambda *a: jl.bsn_tem_loss(*a)["loss"],
                    lambda *a: tl.bsn_tem_loss(*a)["loss"],
                    (seq[0], seq[1], seq[2]), (lab[0], lab[1], lab[2]), {}),
        "bsn_pem": (jl.bsn_pem_loss, tl.bsn_pem_loss, (ppred,), (piou,), {}),
        "bsn_pem_weighted": (jl.bsn_pem_weighted_loss,
                             tl.bsn_pem_weighted_loss, (ppred,),
                             (piou, key), {"draws": u_piou}),
        "ohem": (lambda p, l: jl.ohem_hinge_loss(p, l, -1, 0.5, 4),
                 lambda p, l: tl.ohem_hinge_loss(p, l, -1, 0.5, 4),
                 (comp,), (labels.clip(1),), {}),
        "ohem_keep0": (lambda p, l: jl.ohem_hinge_loss(p, l, 1, 0.1, 4),
                       lambda p, l: tl.ohem_hinge_loss(p, l, 1, 0.1, 4),
                       (comp,), (labels.clip(1),), {}),
        "ssn_activity": (jl.ssn_activity_loss, tl.ssn_activity_loss, (act,),
                         (labels, np.array([0, 3, 4, 7])), {}),
        "ssn_completeness": (
            lambda p, l, i: jl.ssn_completeness_loss(p, l, i, 1, 2, 0.5),
            lambda p, l, i: tl.ssn_completeness_loss(p, l, i, 1, 2, 0.5),
            (comp,), (labels, np.array([0, 1, 2, 4, 5, 6])), {}),
        "ssn_regression": (jl.ssn_classwise_regression_loss,
                           tl.ssn_classwise_regression_loss, (reg,),
                           (labels, targets, np.array([0, 4])), {}),
        "ssn_loss": (lambda a, c_, r, *o: jl.ssn_loss(a, c_, r, *o,
                                                      **ssn_kw)["loss"],
                     lambda a, c_, r, *o: tl.ssn_loss(a, c_, r, *o,
                                                      **ssn_kw)["loss"],
                     (act, comp, reg), (ptype, labels, targets), {}),
    }


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_and_gradients_match_jax(name):
    jfn, tfn, diff, other, kw = LOSS_CASES[name]
    n = len(diff)
    want, jgrads = jax.value_and_grad(
        lambda *d: jfn(*d, *other), argnums=tuple(range(n)))(
            *map(jnp.asarray, diff))
    tdiff = [_t(d).requires_grad_(True) for d in diff]
    targs = [a if isinstance(a, jax.Array) else _t(a) for a in other]
    targs = [a for a in targs if not isinstance(a, jax.Array)]
    got = tfn(*tdiff, *targs, **kw)
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL * max(
        abs(float(want)), 1e-6), name
    if float(want) == 0.0 and not got.requires_grad:
        return
    got.backward()
    for t, g in zip(tdiff, jgrads):
        tg = np.zeros(t.shape, np.float32) if t.grad is None else to_np(
            t.grad)
        assert max_rel(tg, np.asarray(g)) <= GRAD_TOL, name


def test_draws_from_a_generator():
    """Without draws the subsampling losses draw two uniforms of the
    target's shape from the generator on the CPU: the same loss as those
    uniforms handed in."""
    case = LOSS_CASES["bmn_pem_reg"]
    pred, (iou, mask, _key) = case[2][0], case[3]
    g = torch.Generator().manual_seed(3)
    u = (torch.rand(iou.shape, generator=g), torch.rand(iou.shape,
                                                        generator=g))
    a = tl.bmn_pem_reg_loss(_t(pred), _t(iou), _t(mask), draws=u)
    b = tl.bmn_pem_reg_loss(_t(pred), _t(iou), _t(mask),
                            generator=torch.Generator().manual_seed(3))
    assert float(a) == float(b)


# -- labels, sampler, datasets, ops, metrics, post-processing -----------------

def _eq(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        _eq(vars(a), vars(b))
    else:
        assert a == b


def test_labels_and_sampler_match_jax():
    rng = np.random.default_rng(21)
    gt = np.sort(rng.uniform(0, 1, (3, 2)), -1)
    for T, D in ((20, 20), (16, 8)):
        _eq(tlt.bm_mask(T, D), jlt.bm_mask(T, D))
        _eq(tlt.bmn_labels(gt, T, D), jlt.bmn_labels(gt, T, D))
        _eq(tlt.bsn_tem_labels(gt, T), jlt.bsn_tem_labels(gt, T))
    props = np.sort(rng.uniform(0, 48, (30, 2)), -1)
    gts = np.array([[10.0, 30.0], [32.0, 44.0]])
    for seed in range(3):
        _eq(tlt.sample_ssn_proposals(
                props, gts, np.array([1, 3]),
                tlt.SSNSamplerConfig(**SAMPLER),
                np.random.default_rng(seed)),
            jlt.sample_ssn_proposals(
                props, gts, np.array([1, 3]),
                jlt.SSNSamplerConfig(**SAMPLER),
                np.random.default_rng(seed)))


def test_metrics_and_post_processing_match_jax():
    rng = np.random.default_rng(22)
    gt = {f"v{i}": np.sort(rng.uniform(0, 50, (2, 2)), -1) for i in range(4)}
    props = {v: np.concatenate([np.sort(rng.uniform(0, 50, (30, 2)), -1),
                                rng.uniform(0, 1, (30, 1))], 1)
             for v in gt}
    for fn in ("pairwise_temporal_iou",):
        _eq(getattr(tmet, fn)(props["v0"][:, :2], gt["v0"]),
            getattr(jmet, fn)(props["v0"][:, :2], gt["v0"]))
        _eq(getattr(tmet, fn)(props["v0"][0, :2], gt["v0"], True),
            getattr(jmet, fn)(props["v0"][0, :2], gt["v0"], True))
    _eq(tmet.average_recall_at_avg_proposals(gt, props, 120, 30),
        jmet.average_recall_at_avg_proposals(gt, props, 120, 30))
    prec, rec = rng.uniform(0, 1, 9), np.sort(rng.uniform(0, 1, 9))
    _eq(tmet.interpolated_precision_recall(prec, rec),
        jmet.interpolated_precision_recall(prec, rec))
    preds = [(f"v{i % 5}", 1, *np.sort(rng.uniform(0, 50, 2)),
              rng.uniform()) for i in range(25)]
    _eq(tmet.average_precision_at_temporal_iou(gt, preds),
        jmet.average_precision_at_temporal_iou(gt, preds))

    T = 20
    s, e = rng.uniform(0, 1, T), rng.uniform(0, 1, T)
    reg, cls = rng.uniform(0, 1, (T, T)), rng.uniform(0, 1, (T, T))
    rows = tbmn.generate_proposals(s, e, reg, cls, 60)
    _eq(rows, jbmn.generate_proposals(s, e, reg, cls, 60))
    _eq(tbmn.soft_nms(rows, top_k=25), jbmn.soft_nms(rows, top_k=25))
    # ties in the pairing keep the loop order
    tied = np.round(rng.uniform(0, 1, T), 1)
    pairs = tbsn.match_boundaries(tied, tied[::-1].copy())
    _eq(pairs, jbsn.match_boundaries(tied, tied[::-1].copy()))
    _eq(tbsn.proposal_features(s, pairs), jbsn.proposal_features(s, pairs))
    _eq(tssn.stpp_matrix(T, rows[:, :2] * 1.3),
        jssn.stpp_matrix(T, rows[:, :2] * 1.3))
    a, c = rng.standard_normal((6, 4)), rng.standard_normal((6, 3))
    _eq(tssn.ssn_proposal_scores(a, c), jssn.ssn_proposal_scores(a, c))


PROPOSAL_FILE = """# 0
video_a
100
1
2
3 10 40
5 60 90
4
3 0.8500 0.9000 12 38
0 0.0500 0.0200 1 8
5 0.2000 0.5000 55 75
5 0.2000 0.5000 30 20
# 1
video_b
50
1
1
1 5 25
2
1 0.9000 0.8000 6 24
1 0.1000 0.3000 20 40
"""


def test_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(23)
    ann = {}
    (tmp_path / "f").mkdir()
    for i, t in enumerate((16, 20, 11)):
        np.save(tmp_path / "f" / f"v{i}.npy",
                rng.standard_normal((t, 8)).astype(np.float32))
        ann[f"v{i}"] = {"duration": 30.0 + i, "annotations": [
            {"segment": [2.0 + i, 12.0], "label": "a"},
            {"segment": [10.0, 40.0], "label": 2}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    a = tds.ActivityNetDataset(str(tmp_path / "ann.json"),
                               str(tmp_path / "f"), 10)
    b = jds.ActivityNetDataset(str(tmp_path / "ann.json"),
                               str(tmp_path / "f"), 10)
    assert len(a) == len(b) == 3
    for i in range(3):
        _eq(a[i], b[i])

    path = tmp_path / "props.txt"
    path.write_text(PROPOSAL_FILE)
    _eq(tds.load_localize_proposal_file(str(path)),
        jds.load_localize_proposal_file(str(path)))
    cfg = dict(positive_per_video=1, incomplete_per_video=2,
               background_per_video=1)
    a = tds.SSNDataset(str(path), "frames",
                       tlt.SSNSamplerConfig(**cfg), seed=4)
    b = jds.SSNDataset(str(path), "frames",
                       jlt.SSNSamplerConfig(**cfg), seed=4)
    assert len(a) == len(b) == 2
    for _ in range(2):
        for i in range(2):
            _eq(a[i], b[i])


def test_localization_ops_match_jax(tmp_path):
    """The four ops are registered (no longer refused) and give what the
    JAX ops give."""
    rng = np.random.default_rng(24)
    feats = rng.standard_normal((12, 5)).astype(np.float32)
    np.savetxt(tmp_path / "v.csv", feats, delimiter=",",
               header="a,b,c,d,e", comments="")
    res = dict(data_prefix=str(tmp_path), video_name="v")
    op = build_pipeline([dict(type="LoadLocalizationFeature")])
    _eq(op(dict(res)), jpe.LoadLocalizationFeature()(dict(res)))

    res = dict(feature_frame=96, duration_frame=100, duration_second=30.0,
               annotations=[{"segment": [3.0, 12.5]},
                            {"segment": [20.0, 31.0]}])
    _eq(build_pipeline([dict(type="GenerateLocalizationLabels")])(
        dict(res)), jpe.GenerateLocalizationLabels()(dict(res)))

    (tmp_path / "p").mkdir()
    (tmp_path / "q").mkdir()
    rows = np.concatenate([np.sort(rng.uniform(0, 1, (9, 2)), -1),
                           rng.uniform(0, 1, (9, 4))], 1)
    np.savetxt(tmp_path / "p" / "v.csv", rows, delimiter=",", fmt="%.6f",
               header="tmin,tmax,tmin_score,tmax_score,score,match_iou")
    np.save(tmp_path / "q" / "v.npy", rng.standard_normal((9, 24)))
    kw = dict(top_k=5, pgm_proposals_dir=str(tmp_path / "p"),
              pgm_features_dir=str(tmp_path / "q"))
    _eq(build_pipeline([dict(type="LoadProposals", **kw)])(
        {"video_name": "v"}), jpe.LoadProposals(**kw)({"video_name": "v"}))

    props = [tds.SSNProposal(10, 40, 100), (55, 75), tds.SSNProposal(
        2, 30, 100)]
    jprops = [jds.SSNProposal(10, 40, 100), (55, 75), jds.SSNProposal(
        2, 30, 100)]
    for mode in ("train", "val", "test"):
        kw = dict(clip_len=2, body_segments=3, aug_segments=(1, 2),
                  aug_ratio=0.5, frame_interval=2, mode=mode, seed=9,
                  temporal_jitter=mode == "train")
        got = build_pipeline([dict(type="SampleProposalFrames", **kw)])(
            dict(total_frames=100, out_proposals=props, start_index=1))
        want = jpe.SampleProposalFrames(**kw)(
            dict(total_frames=100, out_proposals=jprops, start_index=1))
        _eq({k: v for k, v in got.items() if k != "out_proposals"},
            {k: v for k, v in want.items() if k != "out_proposals"})


# -- one step of each step maker from the same state --------------------------

def _check_step(tm, jparams_after, jgrads, tlogs, jlogs, to_sd, adam_lr=None):
    want = float(jlogs["loss"])
    assert abs(float(tlogs["loss"]) - want) <= STEP_TOL * abs(want)
    g = to_sd({"params": jax.tree.map(np.asarray, jgrads)})
    p = to_sd({"params": jax.tree.map(np.asarray, jparams_after)})
    for name, param in tm.named_parameters():
        assert max_rel(to_np(param.grad), g[name]) <= GRAD_TOL, name
        got, ref = param.detach(), p[name]
        if adam_lr is not None:
            m = g[name].abs() < ADAM_NOISE
            if m.any():
                assert float((got[m] - ref[m]).abs().max()) <= 2 * adam_lr
            got, ref = got[~m], ref[~m]
        if got.numel():
            assert max_rel(to_np(got), ref.numpy()) <= STEP_TOL, name


def _jax_state(v, tx):
    params = jax.tree.map(jnp.asarray, v["params"])
    return params, capturing(tx).init(params)


@pytest.mark.parametrize("kind", ["bmn", "tem", "pem", "pem_weighted",
                                  "ssn", "ssn_batch"])
def test_one_step_matches_jax(kind):
    lr = 1e-3
    base = kind.split("_")[0]
    jm, v, tm, args = _pair(base)
    to_sd = cv.localizer_state_dict_from_jax
    rng = np.random.default_rng(31)
    if base == "bmn":
        jtx, ttx, adam = optax.adamw(lr, weight_decay=0.0), \
            tlt.make_loc_optimizer("adamw", lr), lr
        gt = [jlt.bmn_labels(np.sort(rng.uniform(0, 1, (2, 2)), -1), 20, 20)
              for _ in range(2)]
        batch = (args[0], *(np.stack([g[i] for g in gt]) for i in range(3)),
                 np.broadcast_to(jlt.bm_mask(20, 20), (2, 20, 20)).copy())
        key = jax.random.key(8)
        jstep = jlt.make_bmn_train_step(jm, capturing(jtx))
        jargs, tkw = batch + (key,), {"draws": _uniforms(key, (2, 20, 20))}
        tstep = tlt.make_bmn_train_step(tm, device="cpu")
    elif base == "tem":
        jtx, ttx, adam = optax.adam(lr), tlt.make_loc_optimizer("adam", lr), lr
        gt = [jlt.bsn_tem_labels(np.sort(rng.uniform(0, 1, (1, 2)), -1), 16)
              for _ in range(2)]
        jargs = args + tuple(np.stack([g[i] for g in gt]) for i in range(3))
        jstep, tkw = jlt.make_bsn_tem_train_step(jm, capturing(jtx)), {}
        tstep = tlt.make_bsn_tem_train_step(tm, device="cpu")
    elif base == "pem":
        jtx, ttx, adam = optax.adam(lr), tlt.make_loc_optimizer("adam", lr), lr
        weighted = kind == "pem_weighted"
        iou = rng.uniform(0, 1, 20).astype(np.float32)
        key = jax.random.key(9)
        jstep = jlt.make_bsn_pem_train_step(jm, capturing(jtx),
                                            weighted=weighted)
        tstep = tlt.make_bsn_pem_train_step(tm, weighted=weighted,
                                            device="cpu")
        jargs = args + (iou,) + ((key,) if weighted else ())
        tkw = {"draws": _uniforms(key, (20,))} if weighted else {}
    else:
        jtx = optax.chain(optax.add_decayed_weights(1e-4),
                          optax.sgd(0.05, momentum=0.9))
        ttx, adam = tlt.make_loc_optimizer("sgd", 0.05, 1e-4), None
        scfg = jlt.SSNSamplerConfig(**SAMPLER)
        labels = np.array([[2, 1, 3, 0], [3, 3, 2, 0]], np.int32)
        ptype = np.array([[0, 1, 1, 2]] * 2, np.int32)
        targets = rng.standard_normal((2, 4, 2)).astype(np.float32)
        feats, stpp = args[0], args[1][:, :4]
        if kind == "ssn":
            jstep = jlt.make_ssn_train_step(jm, capturing(jtx), scfg)
            jargs = (feats[0], stpp[0], labels[0], ptype[0], targets[0])
            tstep = tlt.make_ssn_train_step(
                tm, tlt.SSNSamplerConfig(**SAMPLER), device="cpu")
        else:
            jstep = jlt.make_ssn_batch_train_step(jm, capturing(jtx), scfg)
            jargs = (feats, stpp, labels, ptype, targets)
            tstep = tlt.make_ssn_batch_train_step(
                tm, tlt.SSNSamplerConfig(**SAMPLER), device="cpu")
        tkw = {}
    params, opt_state = _jax_state(v, jtx)
    params, opt_state, jlogs = jstep(params, opt_state,
                                     *map(jnp.asarray, jargs))
    targs = [_t(a).long() if a.dtype == np.int32 else _t(a)
             for a in jargs if not isinstance(a, jax.Array)]
    state = tlt.init_loc_state(tm, ttx)
    state, tlogs = tstep(state, *targs, **tkw)
    assert state.model is tm
    _check_step(tm, params, opt_state[0], tlogs, jlogs, to_sd, adam)


def test_optimizer_chains():
    """make_loc_optimizer: no clip; 'adam' takes no decay (the JAX CLI
    ignores the config's); 'adamw' and 'sgd' take theirs."""
    p = [("w", torch.nn.Parameter(torch.ones(3)))]
    for name, kind, wd in (("adam", "adam", 0.0), ("Adam", "adam", 0.0),
                           ("adamw", "adamw", 0.0), ("sgd", "sgd", 1e-4)):
        opt = tlt.make_loc_optimizer(name, 1e-3, 1e-4 if kind != "adamw"
                                     else 0.0)(p)
        assert (opt.kind, opt.max_norm, opt.weight_decay) == (kind, None, wd)
    m = tbsn.PEM(24, 16, device="cpu")
    step = tlt.make_bsn_pem_train_step(m, device="cpu")
    with pytest.raises(ValueError, match="not the one"):
        step(tlt.init_loc_state(tbsn.PEM(24, 16, device="cpu"),
                                tlt.make_loc_optimizer("adam", 1e-3)),
             torch.zeros(4, 24), torch.zeros(4))

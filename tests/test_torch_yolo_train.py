"""The port's detector training step (train/yolo_trainer.py, models/yolo.py
in train mode) against the JAX package's, on the CPU at a small size
(width 0.125, depth 0.33, 64 px, 3 classes; the segment head 4 masks on 16
prototypes).  One seeded state dict (models/yolo.random_state_dict, its
BatchNorm statistics random) starts both; two steps of the detect, segment
and classify trainers run from it on the same numpy batches, each package
from its own state.

After each step: the loss and its items within 1e-5 relative; the
gradients of the first step (the port's `.grad`, JAX's read off its first
velocity: v1 = g + wd * p on the decayed group) and the velocity within
1e-3 of each tensor's largest magnitude (the BatchNorm backward over the
2x2 maps of stride 32 at batch 2 cancels: the BatchNorm parameters' f32
gradients differ by up to 6e-4 of their largest); params, EMA params and
BatchNorm statistics (the model's and the EMA's) within 3e-4 of each
tensor's largest magnitude (the BatchNorm biases, small, move by the
gradients' noise times the warmup's bias lr; 1.6e-4 seen after two
steps).

The bf16 arm (f32 masters, a bf16 forward and backward): at this size
bf16 moves the raw maps by 15-20% of their largest magnitude in either
package, and JAX's own bf16 update of the detector is at cosine 0.5 of
its f32 update, so the update is held only for the classifier.  Held:
the loss within 2e-2 relative of JAX's bf16 loss; masters, velocity, EMA
and BatchNorm statistics f32 in both packages; the running statistics
within 5e-2 of each tensor's largest magnitude; the classifier's whole
update (new - old, per group) at cosine 0.9 or more against JAX's.
Also: the schedule, the train-state converters and resume both ways (the
same bytes)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.losses import yolo as jloss
from cross_modal_video_engine_tpu.models import yolo as jyolo
from cross_modal_video_engine_tpu.train import resume as jresume
from cross_modal_video_engine_tpu.train import yolo_trainer as jyt
from cross_modal_video_engine_tpu_torch.convert import (
    yolo_cls_state_dict_from_jax, yolo_cls_variables_to_jax,
    yolo_state_dict_from_jax, yolo_train_state_from_jax,
    yolo_train_state_to_jax, yolo_variables_to_jax)
from cross_modal_video_engine_tpu_torch.losses import yolo as tloss
from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
from cross_modal_video_engine_tpu_torch.train import resume as tresume
from cross_modal_video_engine_tpu_torch.train import yolo_trainer as tyt

DETECT = tyolo.YoloConfig(num_classes=3, depth_multiple=0.33,
                          width_multiple=0.125, img_size=64)
SEGMENT = dataclasses.replace(DETECT, masks=4, protos=16)
CLASSIFY = tyolo.YoloConfig(num_classes=5, depth_multiple=0.33,
                            width_multiple=0.125, img_size=64)
KINDS = {"detect": DETECT, "segment": SEGMENT, "classify": CLASSIFY}
B, T = 2, 4
OPT = jyt.YoloOptHyp()
WD = jyt.scaled_weight_decay(OPT, B)
# ni 50 and 51 of 10 batches an epoch, 3 epochs: inside the warmup
SCHEDULE = [jyt.lr_momentum_at(ni, 5, 10, 3, OPT) for ni in (50, 51)]
LOSS_REL, GRAD_REL, STATE_REL = 1e-5, 1e-3, 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _batch(kind, seed):
    rng = np.random.default_rng(seed)
    images = rng.random((B, 64, 64, 3), np.float32)
    if kind == "classify":
        return images, rng.integers(0, CLASSIFY.num_classes, B)
    cxy = rng.uniform(0.2, 0.8, (B, T, 2))
    wh = rng.uniform(0.1, 0.5, (B, T, 2))
    cls = rng.integers(0, 3, (B, T, 1))
    targets = np.concatenate([cls, cxy, wh], -1).astype(np.float32)
    valid = np.array([[True] * T, [True, True, False, False]])
    gt = (rng.random((B, T, 16, 16)) > 0.5).astype(np.float32)
    return images, targets, valid, gt


def _to_jax(sd, kind):
    cfg = KINDS[kind]
    conv = yolo_cls_variables_to_jax if kind == "classify" \
        else yolo_variables_to_jax
    return jax.tree.map(jnp.asarray, conv(sd, cfg))


def _from_jax(params, stats, kind):
    conv = yolo_cls_state_dict_from_jax if kind == "classify" \
        else yolo_state_dict_from_jax
    return conv({"params": jax.tree.map(np.asarray, params),
                 "batch_stats": jax.tree.map(np.asarray, stats)},
                KINDS[kind])


def _models(kind, bf16=False):
    cfg = KINDS[kind]
    classifier = kind == "classify"
    sd = tyolo.random_state_dict(cfg, seed=3, classifier=classifier)
    tm = (tyolo.YoloClassifier if classifier else tyolo.YoloV5)(
        cfg, device="cpu")
    state = tyt.init_yolo_train_state(tm, state_dict=sd)
    jcfg = jyolo.YoloConfig(**dataclasses.asdict(cfg))
    jm = (jyolo.YoloClassifier if classifier else jyolo.YoloV5)(jcfg)
    v = _to_jax(sd, kind)
    zeros = jax.tree.map(jnp.zeros_like, v["params"])
    jstate = jyt.YoloTrainState(v["params"], v["batch_stats"], zeros,
                                v["params"], v["batch_stats"],
                                jnp.zeros((), jnp.int32))
    if classifier:
        tstep = tyt.make_yolo_cls_train_step(tm, tyt.YoloOptHyp(), WD,
                                             bf16=bf16, device="cpu")
        jstep = jyt.make_yolo_cls_train_step(jm, OPT, WD, bf16=bf16)
    else:
        tstep = tyt.make_yolo_train_step(tm, tloss.YoloHyp(),
                                         tyt.YoloOptHyp(), WD, bf16=bf16,
                                         device="cpu")
        jstep = jyt.make_yolo_train_step(jm, jloss.YoloHyp(), OPT, WD,
                                         bf16=bf16)
    return state, tstep, jstate, jstep


def _run(kind, state, tstep, jstate, jstep, seed, sched):
    batch = _batch(kind, seed)
    if kind == "classify":
        images, labels = batch
        state, tlogs = tstep(state, torch.from_numpy(images),
                             torch.from_numpy(labels), *sched)
        jstate, jlogs = jstep(jstate, jnp.asarray(images),
                              jnp.asarray(labels, jnp.int32), *sched)
    else:
        images, targets, valid, gt = batch
        extra = dict(gt_masks=gt) if kind == "segment" else {}
        state, tlogs = tstep(state, torch.from_numpy(images),
                             torch.from_numpy(targets),
                             torch.from_numpy(valid), *sched,
                             **{k: torch.from_numpy(v)
                                for k, v in extra.items()})
        jstate, jlogs = jstep(jstate, jnp.asarray(images),
                              jnp.asarray(targets), jnp.asarray(valid),
                              *sched, **{k: jnp.asarray(v)
                                         for k, v in extra.items()})
    return state, tlogs, jstate, jlogs


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _jax_parts(jstate, kind):
    """The JAX state as the port's tensors by part."""
    cur = _from_jax(jstate.params, jstate.batch_stats, kind)
    ema = _from_jax(jstate.ema_params, jstate.ema_stats, kind)
    vel = _from_jax(jstate.vel, jstate.batch_stats, kind)
    return cur, vel, ema


def _port_parts(state):
    return (state.model.state_dict(), state.vel, state.ema.state_dict())


def _compare_state(state, jstate, kind, rel):
    cur, vel, ema = _jax_parts(jstate, kind)
    got_cur, got_vel, got_ema = _port_parts(state)
    for want, got in ((cur, got_cur), (ema, got_ema)):
        for k, v in got.items():
            if v.is_floating_point() and not k.endswith("anchors"):
                assert _rel_err(v, want[k]) <= rel, k
    for k, v in got_vel.items():     # the velocity is a gradient
        assert _rel_err(v, vel[k]) <= (rel and GRAD_REL), k
    assert state.updates == int(jstate.updates)


@pytest.fixture(scope="module", params=sorted(KINDS))
def two_steps(request):
    kind = request.param
    state, tstep, jstate, jstep = _models(kind)
    p0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    steps = []
    for i, sched in enumerate(SCHEDULE):
        state, tlogs, jstate, jlogs = _run(kind, state, tstep, jstate,
                                           jstep, 10 + i, sched)
        grads = {n: p.grad.clone() for n, p in
                 state.model.named_parameters()}
        steps.append((tlogs, jlogs, grads, jstate))
        if i == 0:
            _compare_state(state, jstate, kind, STATE_REL)
    return kind, state, jstate, steps, p0


def test_step_logs_match_jax(two_steps):
    kind, _, _, steps, _ = two_steps
    for tlogs, jlogs, *_ in steps:
        assert set(tlogs) == set(jlogs)
        for k in jlogs:
            assert _rel_err(tlogs[k], jlogs[k]) <= LOSS_REL, k


def test_first_step_gradients_match_jax(two_steps):
    """JAX's gradients from its first velocity (zero before):
    v1 = g + wd * p0 on the decayed group, g elsewhere."""
    kind, state, _, steps, p0 = two_steps
    _, _, grads, jstate1 = steps[0]
    groups = tyt.param_groups(state.model)
    _, vel1, _ = _jax_parts(jstate1, kind)
    for n, g in grads.items():
        want = vel1[n] - (WD * p0[n] if groups[n] == 0 else 0.0)
        assert _rel_err(g, want) <= GRAD_REL, n
    assert {groups[n] for n in grads} == {0, 1, 2}


def test_state_after_two_steps_matches_jax(two_steps):
    kind, state, jstate, _, _ = two_steps
    _compare_state(state, jstate, kind, STATE_REL)
    # the EMA moved: updates counted after the increment
    assert state.updates == 2


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == nb == 0:
        return 1.0
    return float(a @ b / (na * nb))


@pytest.mark.parametrize("kind", ["detect", "classify"])
def test_bf16_step_matches_jax(kind):
    state, tstep, jstate, jstep = _models(kind, bf16=True)
    p0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, tlogs, jstate, jlogs = _run(kind, state, tstep, jstate, jstep, 20,
                                       SCHEDULE[0])
    assert _rel_err(tlogs["loss"], jlogs["loss"]) <= 2e-2
    for leaf in jax.tree.leaves((jstate.params, jstate.batch_stats,
                                 jstate.vel, jstate.ema_params,
                                 jstate.ema_stats)):
        assert leaf.dtype == jnp.float32
    for part in _port_parts(state):
        for k, v in part.items():
            assert v.dtype in (torch.float32, torch.int64), k
    cur, _, _ = _jax_parts(jstate, kind)
    got = state.model.state_dict()
    for k, v in got.items():
        if "running" in k:
            assert _rel_err(v, cur[k]) <= 5e-2, k
    if kind == "classify":
        groups = tyt.param_groups(state.model)
        for g in (0, 1, 2):
            names = [k for k in groups if groups[k] == g]
            a = np.concatenate([(got[k] - p0[k]).numpy().ravel()
                                for k in names])
            b = np.concatenate([(cur[k] - p0[k]).numpy().ravel()
                                for k in names])
            assert _cos(a, b) >= 0.9, g


@pytest.mark.parametrize("cos_lr", [False, True])
def test_lr_momentum_at_matches_jax(cos_lr):
    jo = jyt.YoloOptHyp(cos_lr=cos_lr)
    to = tyt.YoloOptHyp(cos_lr=cos_lr)
    for nb, epochs in ((10, 5), (60, 4)):
        for ni in (0, 1, 50, 99, 100, 101, 180, 239):
            epoch = ni // nb
            assert tyt.lr_momentum_at(ni, epoch, nb, epochs, to) == \
                jyt.lr_momentum_at(ni, epoch, nb, epochs, jo)
    for bs in (2, 16, 64, 100):
        assert tyt.scaled_weight_decay(to, bs) == \
            jyt.scaled_weight_decay(jo, bs)


def test_train_state_converters_round_trip(two_steps):
    kind, state, jstate, *_ = two_steps
    classifier = kind == "classify"
    tree = yolo_train_state_to_jax(*_port_parts(state), state.updates,
                                   KINDS[kind], classifier)
    assert (jax.tree.structure(tree["params"])
            == jax.tree.structure(jax.tree.map(np.asarray, jstate.params)))
    assert (jax.tree.structure(tree["ema_stats"])
            == jax.tree.structure(jax.tree.map(np.asarray,
                                               jstate.batch_stats)))
    sd, vel, ema, updates = yolo_train_state_from_jax(tree, KINDS[kind],
                                                      classifier)
    got_sd, got_vel, got_ema = _port_parts(state)
    for want, got in ((sd, got_sd), (ema, got_ema), (vel, got_vel)):
        for k, v in got.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(want[k], v), k
    assert updates == state.updates


def _fresh(kind):
    cfg = KINDS[kind]
    tm = (tyolo.YoloClassifier if kind == "classify" else tyolo.YoloV5)(
        cfg, device="cpu")
    return tyt.init_yolo_train_state(tm, seed=1)


def test_resume_both_ways(two_steps, tmp_path):
    """JAX writes, the port resumes and writes the same bytes; the port
    writes, JAX resumes the same state."""
    kind, state, jstate, *_ = two_steps
    loop = {"epoch": 3, "best": 0.25}
    jresume.save_train_state(str(tmp_path / "jax"), {"state": tuple(jstate)},
                             loop)
    fresh = _fresh(kind)
    payload, got_loop = tresume.load_train_state(str(tmp_path / "jax"),
                                                 {"state": fresh})
    assert got_loop == loop
    resumed = payload["state"]
    assert resumed.updates == 2
    _compare_state(resumed, jstate, kind, 0.0)
    tresume.save_train_state(str(tmp_path / "port"), {"state": resumed},
                             loop)
    names = [os.path.join(tmp_path, d, tresume.STATE_FILE)
             for d in ("jax", "port")]
    a, b = (open(n, "rb").read() for n in names)
    assert a == b
    tresume.save_train_state(str(tmp_path / "port2"), {"state": state}, loop)
    back, _ = jresume.load_train_state(str(tmp_path / "port2"),
                                       {"state": tuple(jstate)})
    jback = jyt.YoloTrainState(*back["state"])
    _compare_state(state, jback, kind, 0.0)

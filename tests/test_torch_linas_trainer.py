"""The port's LINAS trainer against the JAX package's, on the CPU.

The model is tests/fixtures.tiny_config with dropout 0 (the packages draw
dropout from different streams by design), the weights the port's
`seeded_state_dict` carried into JAX by convert/from_jax.py, the batches
the first two of the same 16-caption collection in both packages' data
providers (batch 8, support 2).

* The optimizer alone against optax (Adam and RMSprop, the clip firing or
  not, a parameter without a gradient), three steps.
* The train step, two steps, for GT, map, de+map (with and without
  with_detach, finetune_vid, the kl and mse+kl distills), text+video with
  distill_loss text, video, text+video and cross, distill_with_similarity
  'adapt', rmsprop and a grad_clip that fires: the loss and the logs, every
  gradient, the parameters, batch_stats and the optimizer's count, mu and
  nu (JAX's gradients are captured by an optax transformation wrapped
  around the trainer's own optimizer).
* One step of the 'adapt' mask; `EpochScheduler` over one sequence of
  scores; `best_checkpoint_manager`'s directory tree (same-name case
  included, files byte-equal); `latest_checkpoint`.
* Resume both ways: a JAX `train()`'s epoch_0 state resumed by the port's
  `train()` and by JAX's own (epoch 1's loss and rsum, the final
  parameters; a de+map and an 'adapt' run, RMSprop); an Adam run's
  epoch_0 loaded into the port leaf for leaf as JAX loads it, then one
  mask step and one train step in both; a port-written state loaded by
  JAX's `load_train_state` (the same bytes as JAX writes for it) gives the
  port's next step.  A port-written model_best restores in the JAX
  package and embeds as the port does.
* train() and make_train_step run on the card unless asked for the CPU,
  and raise for a mesh; the CLI's flags are the JAX CLI's and --device.

Tolerances (f32); whole steps do not agree elementwise at rtol 1e-5 /
atol 1e-6, for the reasons below.  Losses and logs rtol 1e-5, atol 1e-6.  A gradient element: rtol 1e-5 and
atol 2e-6 of the step's largest gradient element, since a gradient sums
per-sample terms of that size in another order in each package (GRU
backward over 64 frames, BatchNorm's backward).  Moments the same, against
the largest element of that moment (the second as its square root, a
gradient's units).  Parameters after a step
1e-5 absolute, but Adam moves every element by about lr whatever its
gradient's size, so an element whose gradient is rounding noise moves by
+-lr in a direction that noise picks, in either package alike: the
mappings' fc1 bias (BatchNorm's mean subtraction gives it a gradient of
exactly 0 in exact arithmetic), the support attention's key bias, conv
biases whose ReLUs are all on.  Such an element (one where the two
packages' clipped gradients differ by more than 1% of its RMS gradient
sqrt(nu_hat), so that its update lr * mu_hat / sqrt(nu_hat) may differ by
more than 1e-6) is held only to a move of at most 4 lr a step; they are
about 1% of the elements, at most 2%.  The step cases
therefore start every step from the same state (JAX's, loaded into the
port through convert/from_jax.py), and the end-to-end resume runs use
RMSprop, which does not amplify noise (eps inside the square root): there
every parameter is held to 1e-5.  Running statistics 1e-5 absolute; the
optimizer alone 1e-6 absolute; embeddings 1e-4 (as in
tests/test_torch_dual_encoding.py); rsum 1e-6 absolute."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from fixtures import make_collection, tiny_config

from cross_modal_video_engine_tpu.cli import common as jcommon
from cross_modal_video_engine_tpu.cli import retrieval_trainer as jrt
from cross_modal_video_engine_tpu.models import dual_encoding as jde
from cross_modal_video_engine_tpu.train import checkpoint as jckpt
from cross_modal_video_engine_tpu.train import linas_trainer as jlt
from cross_modal_video_engine_tpu.train import resume as jres
from cross_modal_video_engine_tpu_torch.cli import common as tcommon
from cross_modal_video_engine_tpu_torch.cli import retrieval_trainer as trt
from cross_modal_video_engine_tpu_torch.convert.from_jax import (
    dual_encoding_state_dict_from_jax, dual_encoding_variables_to_jax,
    linas_mask_state_from_jax, linas_train_state_from_jax)
from cross_modal_video_engine_tpu_torch.models import dual_encoding as tde
from cross_modal_video_engine_tpu_torch.models.layers import Dropout
from cross_modal_video_engine_tpu_torch.train import checkpoint as tckpt
from cross_modal_video_engine_tpu_torch.train import linas_trainer as tlt
from cross_modal_video_engine_tpu_torch.train import optim as topt
from cross_modal_video_engine_tpu_torch.train import resume as tres

RTOL, ATOL = 1e-5, 1e-6
GRAD_FLOOR = 2e-6         # a gradient element's atol / the largest element
NOISE = 1e-2              # gradient difference / RMS gradient: noise above
MOVE_BOUND = 4            # a noise element moves at most this many lr
PARAM_TOL = 1e-5
OPTIM_TOL = 1e-6
EMB_TOL = 1e-4
RSUM_TOL = 1e-6
BATCH, SUPPORT, WEIGHT_SEED = 8, 2, 11
PA = (1.3, 0.7)                      # a learned adapt mask: pa1, pa2
TV = dict(student_model="text+video")
# name -> (model overrides, LinasTrainConfig overrides)
STEP_CASES = {
    "GT": (dict(style="GT"), {}),
    "map": (dict(student_model="map"), {}),
    "de+map": ({}, {}),
    "de+map-no-detach": ({}, dict(with_detach=False)),
    "de+map-finetune-vid": ({}, dict(finetune_vid=True)),
    "de+map-kl": ({}, dict(distill_type="kl")),
    "de+map-mse+kl": ({}, dict(distill_type="mse+kl")),
    "text+video-text": (TV, dict(distill_loss="text")),
    "text+video-video": (TV, dict(distill_loss="video")),
    "text+video-text+video": (TV, dict(distill_loss="text+video")),
    "text+video-cross": (TV, dict(distill_loss="text+video",
                                  distill_type="cross")),
    "text+video-adapt": (TV, dict(distill_with_similarity=True,
                                  similarity_type="adapt")),
    "rmsprop": ({}, dict(optimizer="rmsprop")),
    "clip": ({}, dict(grad_clip=0.05)),
}


@pytest.fixture(autouse=True)
def _torch_state_kept():
    """Each test leaves torch's global RNG and thread count as found."""
    rng, threads = torch.get_rng_state(), torch.get_num_threads()
    yield
    assert torch.equal(torch.get_rng_state(), rng)
    assert torch.get_num_threads() == threads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 16-caption collection and both packages' datasets of it."""
    root = str(tmp_path_factory.mktemp("linas_train"))
    info = make_collection(root, n_videos=8, caps_per_video=2)
    args = (root, info["collection"], info["feature"])
    return dict(
        root=root, info=info,
        j_train=jcommon.load_dataset(*args, support_set_number=SUPPORT),
        j_val=jcommon.load_dataset(*args),
        t_train=tcommon.load_dataset(*args, support_set_number=SUPPORT,
                                     device="cpu"),
        t_val=tcommon.load_dataset(*args, device="cpu"))


def _configs(world, model_kw, train_kw=None, **extra):
    jcfg = tiny_config(world["info"], dropout=0.0, **model_kw)
    tcfg = tde.DualEncodingConfig(**dataclasses.asdict(jcfg))
    train_kw = dict(train_kw or {}, **extra)
    return (jcfg, tcfg, jlt.LinasTrainConfig(**train_kw),
            tlt.LinasTrainConfig(**train_kw))


def _np(t):
    return t.detach().numpy()


def _port_state(tcfg, ttrain):
    model = tde.DualEncoding(tcfg, device="cpu")
    return tlt.init_train_state(model, tlt.make_optimizer(ttrain),
                                seed=WEIGHT_SEED)


def _jax_variables(tcfg):
    return dual_encoding_variables_to_jax(
        tde.seeded_state_dict(tcfg, WEIGHT_SEED))


def _assert_sd(got, want, tol, skip=("num_batches_tracked",)):
    """Two port state dicts (tensors) within an absolute tolerance."""
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith(skip):
            continue
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=0,
                                   atol=tol, err_msg=k)


def _assert_close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=err_msg)


# -- the optimizer alone -------------------------------------------------------

def _optax_chain(kind, max_norm, lr):
    def base(learning_rate):
        opt = (optax.rmsprop(learning_rate) if kind == "rmsprop"
               else optax.adam(learning_rate))
        return optax.chain(optax.clip_by_global_norm(max_norm), opt)
    return optax.inject_hyperparams(base)(learning_rate=lr)


@pytest.mark.parametrize("clip", [False, True], ids=["no-clip", "clip"])
@pytest.mark.parametrize("kind", ["adam", "rmsprop"])
def test_optimizer_matches_optax(kind, clip):
    """Three steps; "c" never gets a gradient (optax: zeros, its moments
    decay and the count moves)."""
    rng = np.random.default_rng(41)
    shapes = {"a": (3, 4), "b": (5,), "c": (2,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    max_norm = 0.5 if clip else 100.0
    tx = _optax_chain(kind, max_norm, 1e-2)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    opt = topt.OptaxOptimizer(list(tparams.items()), 1e-2, kind, max_norm)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        grads["c"][:] = 0.0
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                           for g in grads.values()))
        assert (norm > max_norm) == clip
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads),
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = None if k == "c" else torch.tensor(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(_np(tparams[k]),
                                       np.asarray(jparams[k]), rtol=0,
                                       atol=OPTIM_TOL, err_msg=k)
    named = opt.named_state()
    inner = jstate.inner_state[1][0]
    assert named["count"] == int(jstate.count) == 3
    assert named["learning_rate"] == float(
        jstate.hyperparams["learning_rate"])
    for m in ("mu", "nu"):
        if kind == "rmsprop" and m == "mu":
            assert "mu" not in named
            continue
        for k in shapes:
            np.testing.assert_allclose(_np(named[m][k]),
                                       np.asarray(getattr(inner, m)[k]),
                                       rtol=0, atol=OPTIM_TOL)


# -- the train step ------------------------------------------------------------

def _capturing(tx):
    """tx with the raw gradients kept in its state: (grads, tx's state)."""
    def init(params):
        return (jax.tree.map(jnp.zeros_like, params), tx.init(params))

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def _batches(world, n=2):
    j = list(world["j_train"].train_batches(BATCH, 0))[:n]
    t = list(world["t_train"].train_batches(BATCH, 0))[:n]
    assert len(j) == len(t) == n
    for jb, tb in zip(j, t):       # the same captions in both providers
        np.testing.assert_array_equal(np.asarray(jb[1].ids),
                                      _np(tb[1].ids))
    return j, t


def _check_step(tcfg, start, jstate, jlogs, tstate, tlogs, ttrain):
    """One step from the same state `start` (a port state dict) in both
    packages.  Returns JAX's state as the port's (state dict, optimizer
    named state) and its raw gradients."""
    assert sorted(tlogs) == sorted(jlogs)
    for k in jlogs:
        _assert_close(_np(tlogs[k]), jlogs[k], err_msg=k)
    grads, inner = jstate.opt_state
    want_grads = dual_encoding_state_dict_from_jax({"params": grads}, tcfg)
    gmax = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in tstate.model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(_np(g), _np(want_grads[name]),
                                   rtol=RTOL, atol=GRAD_FLOOR * gmax,
                                   err_msg=name)
    want_sd, want_named = linas_train_state_from_jax(
        serialization.to_state_dict(jlt.TrainState(
            jstate.params, jstate.batch_stats, inner)), tcfg)
    named = tstate.optimizer.named_state()
    assert named["count"] == want_named["count"]
    assert named["learning_rate"] == want_named["learning_rate"]
    assert ("mu" in named) == (ttrain.optimizer == "adam")
    for m in ("mu", "nu"):
        if m not in want_named:
            continue
        # the second moment in a gradient's units
        unit = (lambda t: t.sqrt()) if m == "nu" else (lambda t: t)
        want = {k: unit(w) for k, w in want_named[m].items()}
        mmax = max(float(w.abs().max()) for w in want.values())
        for k, w in want.items():
            np.testing.assert_allclose(_np(unit(named[m][k])), _np(w),
                                       rtol=RTOL, atol=GRAD_FLOOR * mmax,
                                       err_msg=f"{m} {k}")
    # an element's update is decided by rounding noise where the packages'
    # (clipped) gradients differ by more than NOISE of its RMS gradient
    clip = min(1.0, ttrain.grad_clip / float(optax.global_norm(grads)))
    if ttrain.optimizer == "adam":
        rms = {k: (v / (1 - 0.999 ** named["count"])).sqrt()
               for k, v in want_named["nu"].items()}
    else:
        rms = {k: (v + 1e-8).sqrt() for k, v in want_named["nu"].items()}
    sd = tstate.model.state_dict()
    params = dict(tstate.model.named_parameters())
    n_noisy = 0
    for k, w in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        got, w = _np(sd[k]), _np(w)
        if k not in params:                     # running statistics
            np.testing.assert_allclose(got, w, rtol=0, atol=PARAM_TOL,
                                       err_msg=k)
            continue
        g = params[k].grad
        dg = (torch.zeros_like(params[k]) if g is None else g) \
            - want_grads[k]
        noisy = _np(clip * dg.abs() > NOISE * rms[k])
        n_noisy += int(noisy.sum())
        np.testing.assert_allclose(got[~noisy], w[~noisy], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)
        bound = MOVE_BOUND * named["learning_rate"]
        for moved in (got, w):
            assert np.all(np.abs(moved - _np(start[k]))[noisy] <= bound)
    # the mappings' fc1 biases, the key projection, some conv biases:
    # about 1% of the tiny model's 7-10 thousand elements
    assert n_noisy <= 0.02 * sum(p.numel() for p in params.values())
    return (want_sd, want_named), grads


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(world, case):
    """Two steps (the second one's bias correction), each from the same
    state: after the first, JAX's state is loaded into the port."""
    model_kw, train_kw = STEP_CASES[case]
    jcfg, tcfg, jtrain, ttrain = _configs(world, model_kw, train_kw)
    jmodel = jde.DualEncoding(jcfg)
    variables = _jax_variables(tcfg)
    tx = _capturing(jlt.make_optimizer(jtrain))
    jstate = jlt.TrainState(variables["params"], variables["batch_stats"],
                            tx.init(variables["params"]))
    jstep = jlt.make_train_step(jmodel, jtrain, tx)
    tstate = _port_state(tcfg, ttrain)
    tstep = tlt.make_train_step(tstate.model, ttrain, device="cpu")
    adapt = ttrain.similarity_type == "adapt"
    for jb, tb in zip(*_batches(world)):
        jmask = jlt.mask_matrix(jnp.asarray(PA), BATCH) if adapt else None
        tmask = tlt.mask_matrix(torch.tensor(PA), BATCH) if adapt else None
        start = {k: v.clone() for k, v in tstate.model.state_dict().items()}
        jstate, jlogs = jstep(jstate, *jb[:3], jax.random.key(0), jmask)
        tstate, tlogs = tstep(tstate, *tb[:3], tmask)
        (want_sd, want_named), grads = _check_step(
            tcfg, start, jstate, jlogs, tstate, tlogs, ttrain)
        if case == "clip":
            assert float(optax.global_norm(grads)) > ttrain.grad_clip
        tstate.model.load_state_dict(want_sd)
        tstate.optimizer.load_named_state(want_named)


def test_mask_step_matches_jax(world):
    jcfg, tcfg, jtrain, ttrain = _configs(
        world, TV, dict(distill_with_similarity=True,
                        similarity_type="adapt"))
    jmodel = jde.DualEncoding(jcfg)
    variables = _jax_variables(tcfg)
    jstate = jlt.TrainState(variables["params"], variables["batch_stats"],
                            None)
    tx2 = jlt.make_mask_optimizer(jtrain)
    jmask, jloss = jlt.make_mask_train_step(jmodel, tx2)(
        jlt.init_mask_state(tx2), jstate,
        *next(world["j_train"].train_batches(BATCH, 0))[:3])
    tstate = _port_state(tcfg, ttrain)
    ttx2 = tlt.make_mask_optimizer(ttrain)
    tmask, tloss = tlt.make_mask_train_step(tstate.model)(
        tlt.init_mask_state(ttx2, "cpu"), tstate,
        *next(world["t_train"].train_batches(BATCH, 0))[:3])
    _assert_close(tloss, jloss)
    assert not np.allclose(_np(tmask.pa), 1.0)        # pa moved
    _assert_close(_np(tmask.pa), np.asarray(jmask.pa))
    pa, named = linas_mask_state_from_jax(
        serialization.to_state_dict(tuple(jmask)))
    got = tmask.optimizer.named_state()
    assert got["count"] == named["count"] == 1
    for m in ("mu", "nu"):
        _assert_close(_np(got[m]["pa"]), _np(named[m]["pa"]), err_msg=m)
    # the model's weights did not move
    _assert_sd(tstate.model.state_dict(),
               tde.seeded_state_dict(tcfg, WEIGHT_SEED), 0.0)


# -- the scheduler, the best checkpoint ------------------------------------------

def test_epoch_scheduler_matches_jax():
    scores = [1.0, 2.0, 2.0, 1.5, 1.9, 3.0, 3.0, 2.0, 2.5, 2.9, 1.0, 0.5,
              0.7, 0.1]
    jcfg = jlt.LinasTrainConfig()
    tx = jlt.make_optimizer(jcfg)
    params = {"w": jnp.zeros(3)}
    jstate = jlt.TrainState(params, {}, tx.init(params))
    tstate = tlt.TrainState(None, topt.OptaxOptimizer(
        [("w", torch.zeros(3, requires_grad=True))], jcfg.learning_rate))
    js, ts = jlt.EpochScheduler(jcfg), tlt.EpochScheduler(
        tlt.LinasTrainConfig())
    seq_j, seq_t = [], []
    for score in scores:
        jstate, jbest, jstop = js.on_epoch_end(jstate, score)
        tstate, tbest, tstop = ts.on_epoch_end(tstate, score)
        seq_j.append((jlt.get_learning_rate(jstate), jbest, jstop,
                      js.since_halve, js.no_impr))
        seq_t.append((tlt.get_learning_rate(tstate), tbest, tstop,
                      ts.since_halve, ts.no_impr))
    assert seq_t == seq_j
    assert seq_t[-1][2]                       # it stops in the end


def _tree_listing(root):
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for d in dirnames:
            p = os.path.join(dirpath, d)
            if os.path.islink(p):
                out[os.path.join(rel, d)] = "-> " + os.path.basename(
                    os.readlink(p))
        for f in filenames:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.join(rel, f)] = fh.read()
    return out


def test_best_checkpoint_manager_matches_jax(tmp_path):
    """Scores 1, 0.5 (not kept), 2, 2.00001 (a new best that prints to
    the same name), 3: the same tree, link and bytes in both packages."""
    cfg = tde.DualEncodingConfig(word_dim=12)
    roots = {}
    for name, mod in (("jax", jckpt), ("port", tckpt)):
        roots[name] = root = str(tmp_path / name)
        os.makedirs(root)
        save = mod.best_checkpoint_manager(root)
        saved = [save({"params": {"w": np.full(3, s, np.float32)}}, cfg, s,
                      {"epoch": i})
                 for i, s in enumerate([1.0, 0.5, 2.0, 2.00001])]
        assert saved == [True, False, True, True]
        assert sorted(os.listdir(root)) == ["model_best",
                                            "model_best_2.0000"]
        assert save({"params": {"w": np.full(3, 3.0, np.float32)}}, cfg,
                    3.0)
    assert _tree_listing(roots["port"]) == _tree_listing(roots["jax"])
    assert sorted(os.listdir(roots["port"])) == ["model_best",
                                                 "model_best_3.0000"]


def test_latest_checkpoint_matches_jax(tmp_path):
    for d in ("epoch_0", "epoch_10", "epoch_2", "epoch_x", "model_best"):
        os.makedirs(tmp_path / d)
    got = tres.latest_checkpoint(str(tmp_path))
    assert got == jres.latest_checkpoint(str(tmp_path))
    assert os.path.basename(got) == "epoch_10"
    assert tres.latest_checkpoint(str(tmp_path / "none")) is None


# -- resume, both ways -------------------------------------------------------------

RESUME_CASES = {"de+map": ({}, {}),
                "adapt": (TV, dict(distill_with_similarity=True,
                                   similarity_type="adapt"))}


def _jax_epoch0(world, root, jcfg, jtrain):
    """JAX train() for one epoch; returns its epoch_0 train state."""
    os.makedirs(root)
    jrt.train(jcfg, jtrain, world["j_train"], world["j_val"], root,
              batch_size=BATCH, log_every=0, num_epochs=1,
              checkpoint_interval=1)
    return os.path.join(root, "epoch_0")


def _jax_capturing(jmodel, jtrain, state):
    """JAX's step, and `state` with its gradients captured (_capturing)."""
    tx = _capturing(jlt.make_optimizer(jtrain))
    return (jlt.make_train_step(jmodel, jtrain, tx),
            jlt.TrainState(state.params, state.batch_stats,
                           (jax.tree.map(jnp.zeros_like, state.params),
                            state.opt_state)))


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_jax_epoch_state_resumes_in_the_port(world, tmp_path, case):
    """JAX train() writes epoch_0; JAX and the port resume it for epoch 1:
    the same loss, rsum, learning rate, val_metric_hist.txt and final
    parameters (RMSprop: see the module docstring)."""
    model_kw, train_kw = RESUME_CASES[case]
    jcfg, tcfg, jtrain, ttrain = _configs(world, model_kw, train_kw,
                                          optimizer="rmsprop")
    epoch0 = _jax_epoch0(world, str(tmp_path / "first"), jcfg, jtrain)
    out = {}
    for name in ("jax", "port"):
        out[name] = str(tmp_path / name)
        os.makedirs(out[name])
    jstate, jhist, _ = jrt.train(
        jcfg, jtrain, world["j_train"], world["j_val"], out["jax"],
        batch_size=BATCH, log_every=0, num_epochs=2, resume=epoch0)
    tstate, thist, _ = trt.train(
        tcfg, ttrain, world["t_train"], world["t_val"], out["port"],
        batch_size=BATCH, log_every=0, num_epochs=2, resume=epoch0,
        device="cpu")
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist] == [1]
    _assert_close(thist[0]["loss"], jhist[0]["loss"])
    np.testing.assert_allclose(thist[0]["rsum"], jhist[0]["rsum"], rtol=0,
                               atol=RSUM_TOL)
    assert thist[0]["lr"] == jhist[0]["lr"]
    want = dual_encoding_state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, tcfg)
    _assert_sd(tstate.model.state_dict(), want, PARAM_TOL)
    with open(os.path.join(out["port"], "val_metric_hist.txt")) as f:
        port_hist = f.read()
    with open(os.path.join(out["jax"], "val_metric_hist.txt")) as f:
        assert port_hist == f.read()


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_jax_adam_state_loads_in_the_port(world, tmp_path, case):
    """An Adam run's epoch_0 (and its adapt mask) loads into the port as
    JAX loads it, leaf for leaf; one mask step and one train step from it
    then match JAX's."""
    model_kw, train_kw = RESUME_CASES[case]
    jcfg, tcfg, jtrain, ttrain = _configs(world, model_kw, train_kw)
    adapt = ttrain.similarity_type == "adapt"
    epoch0 = _jax_epoch0(world, str(tmp_path / "first"), jcfg, jtrain)
    jb, tb = _batches(world, 1)
    jmodel = jde.DualEncoding(jcfg)
    template = {"state": jlt.init_train_state(
        jmodel, jlt.make_optimizer(jtrain), *jb[0][:3])}
    tstate = _port_state(tcfg, ttrain)
    tpayload = {"state": tstate}
    if adapt:
        tx2 = jlt.make_mask_optimizer(jtrain)
        template["mask"] = tuple(jlt.init_mask_state(tx2))
        tpayload["mask"] = tlt.init_mask_state(
            tlt.make_mask_optimizer(ttrain), "cpu")
    jpayload, jloop = jres.load_train_state(epoch0, template)
    restored, tloop = tres.load_train_state(epoch0, tpayload)
    assert tloop == jloop and jloop["epoch"] == 0
    want_sd, want_named = linas_train_state_from_jax(
        serialization.to_state_dict(jpayload["state"]), tcfg)
    assert want_named["count"] == 2                   # two steps an epoch
    _assert_sd(tstate.model.state_dict(), want_sd, 0.0)
    named = tstate.optimizer.named_state()
    for m in ("count", "learning_rate"):
        assert named[m] == want_named[m]
    for m in ("mu", "nu"):
        _assert_sd(named[m], want_named[m], 0.0)
    jstep, jstate = _jax_capturing(jmodel, jtrain, jpayload["state"])
    tstep = tlt.make_train_step(tstate.model, ttrain, device="cpu")
    jmask = tmask = None
    if adapt:
        jms = jlt.MaskState(*jpayload["mask"])
        tms = restored["mask"]
        pa, mnamed = linas_mask_state_from_jax(
            serialization.to_state_dict(jpayload["mask"]))
        assert torch.equal(tms.pa.detach(), pa)
        assert tms.optimizer.named_state()["count"] == mnamed["count"] == 2
        jms, _ = jlt.make_mask_train_step(jmodel, tx2)(
            jms, jstate, *jb[0][:3])
        tms, _ = tlt.make_mask_train_step(tstate.model)(
            tms, tstate, *tb[0][:3])
        _assert_close(_np(tms.pa), np.asarray(jms.pa))
        jmask = jlt.mask_matrix(jms.pa, BATCH)
        tmask = tlt.mask_matrix(tms.pa, BATCH)
    start = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    jstate, jlogs = jstep(jstate, *jb[0][:3], jax.random.key(0), jmask)
    tstate, tlogs = tstep(tstate, *tb[0][:3], tmask)
    _check_step(tcfg, start, jstate, jlogs, tstate, tlogs, ttrain)


def test_port_state_loads_in_jax(world, tmp_path):
    """The port's state after one step, saved: the bytes JAX writes for the
    state it loads from them, and JAX's next step from it is the port's."""
    jcfg, tcfg, jtrain, ttrain = _configs(world, {})
    jb, tb = _batches(world)
    tstate = _port_state(tcfg, ttrain)
    tstep = tlt.make_train_step(tstate.model, ttrain, device="cpu")
    tstate, _ = tstep(tstate, *tb[0][:3])
    path = str(tmp_path / "epoch_0")
    loop = {"epoch": 0, "best": 12.5, "no_impr": 0, "since_halve": 1}
    tres.save_train_state(path, {"state": tstate}, loop)

    jmodel = jde.DualEncoding(jcfg)
    template = jlt.init_train_state(jmodel, jlt.make_optimizer(jtrain),
                                    *jb[0][:3])
    payload, jloop = jres.load_train_state(path, {"state": template})
    assert jloop == loop
    again = str(tmp_path / "again")
    jres.save_train_state(again, payload, jloop)
    for f in ("train_state.msgpack", "loop_state.json"):
        with open(os.path.join(path, f), "rb") as a, \
                open(os.path.join(again, f), "rb") as b:
            assert a.read() == b.read(), f
    jstep, jstate = _jax_capturing(jmodel, jtrain, payload["state"])
    start = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    jstate, jlogs = jstep(jstate, *jb[1][:3], jax.random.key(0))
    tstate, tlogs = tstep(tstate, *tb[1][:3])
    _check_step(tcfg, start, jstate, jlogs, tstate, tlogs, ttrain)


def test_port_model_best_restores_in_jax(world, tmp_path):
    _, tcfg, _, ttrain = _configs(world, {})
    out = str(tmp_path / "run")
    os.makedirs(out)
    tstate, hist, best = trt.train(
        tcfg, ttrain, world["t_train"], world["t_val"], out,
        batch_size=BATCH, log_every=0, num_epochs=1, device="cpu")
    assert os.path.islink(best) and len(hist) == 1
    jmodel, extra = jcommon.restore_dual_encoding(best)
    assert extra["meta"] == {"epoch": 0, "score": hist[0]["rsum"]}
    text, _ = next(world["j_val"].text_batches(BATCH))
    videos, _ = next(world["j_val"].video_batches(BATCH))
    ttext, _ = next(world["t_val"].text_batches(BATCH))
    tvideos, _ = next(world["t_val"].video_batches(BATCH))
    model = tstate.model.eval()
    with torch.no_grad():
        for method, jx, tx_ in (("embed_txt_distill", text, ttext),
                                ("embed_vis_distill", videos, tvideos)):
            want = jmodel.apply(extra["variables"], jx, method=method)
            got = getattr(model, method)(tx_)
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                       atol=EMB_TOL, err_msg=method)


# -- devices, the CLI, dropout ---------------------------------------------------------

def test_training_runs_on_the_card_unless_asked(world, tmp_path):
    _, tcfg, _, ttrain = _configs(world, {})
    with pytest.raises(ValueError, match="cuda"):
        trt.train(tcfg, ttrain, world["t_train"], world["t_val"],
                  str(tmp_path))
    model = tde.DualEncoding(tcfg, device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        tlt.make_train_step(model, ttrain)
    for call in (lambda: tlt.make_train_step(model, ttrain, mesh=object(),
                                             device="cpu"),
                 lambda: trt.train(tcfg, ttrain, world["t_train"],
                                   world["t_val"], str(tmp_path),
                                   device="cpu", mesh=object())):
        with pytest.raises(NotImplementedError, match="item 11"):
            call()


def _flags(main):
    with pytest.raises(SystemExit):
        main(["--help"])


def test_cli_flags_and_outputs(world, tmp_path, capsys):
    """The port's CLI takes the JAX CLI's flags and --device, and writes
    model_best, val_metric_hist.txt and epoch_0, and prints the last
    history line as JSON."""
    helps = {}
    for name, main in (("jax", jrt.main), ("port", trt.main)):
        _flags(main)
        helps[name] = {w.strip("[],") for w in capsys.readouterr().out.split()
                       if w.startswith(("--", "[--"))}
    assert helps["port"] == helps["jax"] | {"--device"}
    info = world["info"]
    sizes = {k: v for k, v in dataclasses.asdict(
        tiny_config(info, dropout=0.0)).items()
        if k not in ("vocab_size", "bow_vocab_size", "visual_feat_dim",
                     "style", "student_model")}
    out = str(tmp_path / "cli")
    trt.main(["--rootpath", world["root"], "--trainCollection",
              info["collection"], "--valCollection", info["collection"],
              "--visual_feature", info["feature"], "--out_dir", out,
              "--batch_size", str(BATCH), "--num_epochs", "1",
              "--support_set_number", str(SUPPORT), "--visual_feat_dim",
              str(info["feat_dim"]), "--config_json", json.dumps(sizes),
              "--checkpoint_interval", "1", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(last) == ["epoch", "loss", "lr", "rsum", "time"]
    assert sorted(os.listdir(out)) == [
        "epoch_0", "model_best", f"model_best_{last['rsum']:.4f}",
        "val_metric_hist.txt"]
    with open(os.path.join(out, "val_metric_hist.txt")) as f:
        assert f.read() == f"0 {last['rsum']:.4f}\n"


def test_dropout_draws_from_its_generator():
    d = Dropout(0.25).train()
    x = torch.ones(20000)
    draws = []
    for seed in (3, 3, 4):
        d.generator = torch.Generator().manual_seed(seed)
        draws.append(d(x))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    kept = draws[0] != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert torch.all(draws[0][kept] == 1 / 0.75)
    assert torch.equal(d.eval()(x), x)

"""The port's BatchNorm training of the 3D-CNN recognizers against the JAX
package's, on the CPU at a small size (tests/test_torch_resnet3d.py's
backbones: widths 8-32, 8 frames of 32², batch 4; dropouts 0 where the
packages are compared).

* Two steps of `make_cls_train_step_stats` (BackboneClassifier on
  SlowFast with the s2d fast stem, on the non-local SlowOnly, and
  X3DClassifier) and one of `make_seq_train_step_stats` (RecognizerRelseq
  on CSN-ip), each from JAX's state (parameters, statistics, momentum),
  SGD with momentum, weight decay and the clip engaged: the loss within
  1e-5 relative, each gradient at cosine >= 0.9999 to JAX's and within
  GRAD_TOL of its tensor's largest, each parameter and running statistic
  after the step within 1e-5 of its tensor's largest magnitude (the
  non-local model's statistics within test_torch_resnet3d.NL_STATS_TOL).
  The non-local model's gradients are held to cosine >= 0.9999 to JAX's
  and within GRAD_TOL of the float64 gradients of the same step (the
  port's model in float64), and the port's worst distance from float64
  to be no larger than JAX's: upstream of the first non-local block JAX's
  miss GRAD_TOL, because flax's f32 variance E[y²] - E[y]² after conv_out
  loses digits where the attention-averaged maps have a mean far above
  their spread; its parameters after the step are held within 1e-5 plus
  the learning rate times the two packages' gradient difference.
  A gradient that is zero in exact arithmetic is rounding noise in both
  packages (the non-local block's phi bias: softmax ignores a shift of
  the keys; its g bias and CSN-ip's pointwise BatchNorm bias: a
  per-channel shift that a train-mode BatchNorm takes out again): where
  JAX's largest element is below NOISE of the model's largest gradient,
  the two are held within NOISE of that largest gradient instead.  (A
  second step run on from the port's own state is not compared: at this
  size a parameter that differs by rounding flips ReLUs in the small
  BatchNorm batches, which moves gradients by percents of a tensor's
  largest, with either package's rounding.)
* `bf16=True` against JAX's bf16 step: the loss within 2e-2 relative,
  the gradients by group (convs, BatchNorms, head) at cosine >= 0.99 or,
  where JAX's own bf16 step is farther from its f32 step, at least that
  cosine (at this size BatchNorm over 1x1 and 2x2 maps in bf16 puts
  JAX's own bf16 convs and BatchNorms below 0.99 to its f32 ones); f32
  masters and statistics in both.
* `precise_bn.update_bn_stats` against JAX's within STATS_TOL / 0.1 (the
  inversion of an EMA step of momentum 0.1 multiplies a statistic's
  rounding by 10), and its EMA inversion for BatchNorms of other
  momenta.
* The epoch state with `batch_stats`: written by JAX, read by the port
  and written back byte for byte; written by the port after a step, read
  by JAX's `load_train_state` leaf for leaf.
* The refusals that name their part, and the steps' refusal of the
  models they do not train.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.models import decoder_head as jdh
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import resnet3d as jr
from cross_modal_video_engine_tpu.train import precise_bn as jpbn
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu.train import resume as jres
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import resnet3d as tr
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
from cross_modal_video_engine_tpu_torch.train import precise_bn as tpbn
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from cross_modal_video_engine_tpu_torch.train import resume as tres
from test_torch_resnet3d import (FAMILIES, NL_STATS_TOL, STATS_TOL,
                                 random_conv_state_dict, videos)
from torch_parity import (capturing, jax_state_tree, max_rel, min_cosine,
                          to_np)

CLASSES, BATCH = 6, 4
LOSS_REL = 1e-5
GRAD_COS, GRAD_TOL = 0.9999, 1e-3
NOISE = 1e-5                 # of the model's largest gradient
PARAM_TOL = 1e-5
PRECISE_BN_TOL = STATS_TOL / 0.1
BF16_LOSS_REL, BF16_GRAD_COS = 2e-2, 0.99
CHAIN = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
             weight_decay=1e-2, grad_clip=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _models(name, wrapper, seed=5, **overrides):
    """(port recognizer, JAX recognizer, JAX variables), dropouts 0, one
    seeded state dict through the importers."""
    tcls, cfg_name, importer, kw = FAMILIES[name]
    kw = dict(kw, **overrides)
    backbone = getattr(tr, tcls)(getattr(tr, cfg_name)(**kw), device="cpu")
    jbackbone = getattr(jr, tcls)(getattr(jr, cfg_name)(**kw))
    if wrapper == "classifier":
        tm = trec.BackboneClassifier(backbone, CLASSES, dropout_ratio=0.0)
        jm = jrec.BackboneClassifier(jbackbone, CLASSES, dropout_ratio=0.0)
    elif wrapper == "x3d_classifier":
        tm = trec.X3DClassifier(backbone, CLASSES, 16, dropout_ratio=0.0)
        jm = jrec.X3DClassifier(jbackbone, CLASSES, 16, dropout_ratio=0.0)
    else:
        dec = dict(num_classes=5, in_channels=backbone.feat_dim, max_len=3,
                   input_dropout_p=0.0)
        tm = trec.RecognizerRelseq(backbone, RNNDecoderConfig(**dec))
        jm = jrec.RecognizerRelseq(jbackbone, jdh.RNNDecoderConfig(**dec))
    sd = random_conv_state_dict(tm, seed)
    tm.load_state_dict(sd)
    return tm, jm, tconv.conv_recognizer_variables_to_jax(sd, tm)


def _cls_batch(i):
    rng = np.random.default_rng(300 + i)
    return videos(BATCH, seed=40 + i), rng.integers(0, CLASSES, BATCH)


def _seq_batch(i):
    rng = np.random.default_rng(400 + i)
    targets = (rng.random((BATCH, 3, 5)) < 0.4).astype(np.float32)
    mask = np.ones((BATCH, 3), np.float32)
    mask[0, 2] = 0.0
    return videos(BATCH, seed=50 + i), targets, mask


def _jax_state(variables, tx):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jrt.RecTrainState(params, tx.init(params),
                             jnp.zeros((), jnp.int32))


def _load_jax_state(tstate, jstate, jstats):
    """JAX's state (built on `capturing`'s optimizer) and statistics into
    the port's, through the converters."""
    model, opt = tstate.model, tstate.optimizer
    sd, named, step = tconv.rec_train_state_from_jax(
        jax_state_tree(jstate), model, "sgd", clip=True)
    sd.update(tconv.conv_batch_stats_from_jax(
        jax.tree.map(np.asarray, jstats), model))
    model.load_state_dict(sd, strict=False)
    opt.load_named_state(named)
    return tstate._replace(step=step)


def _groups(names):
    out = {}
    for n in names:
        g = ("head" if n.startswith("cls_head") else
             "bn" if ".bn." in n else "conv")
        out.setdefault(g, []).append(n)
    return out


def _group_cosines(a: dict, b: dict) -> dict:
    cos = {}
    for g, names in _groups(a).items():
        x = np.concatenate([to_np(a[n]).ravel() for n in names])
        y = np.concatenate([np.asarray(b[n], np.float32).ravel()
                            for n in names])
        cos[g] = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    return cos


def _f64_grads(tm, v, lab) -> dict:
    """The step's gradients in float64: a float64 copy of the port's model
    in train mode on the same batch (its statistics move in the copy
    only)."""
    import copy
    m64 = copy.deepcopy(tm).double().train()
    loss = torch.nn.functional.cross_entropy(
        m64(torch.from_numpy(v).double()), torch.from_numpy(lab))
    loss.backward()
    return {n: p.grad.numpy() for n, p in m64.named_parameters()}


def _check_step(tm, jstate, jstats, tlogs, jlogs, stats_tol, truth=None):
    jloss = float(jlogs["loss"])
    assert abs(float(tlogs["loss"]) - jloss) <= LOSS_REL * abs(jloss)
    jgrads = tconv.conv_recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.opt_state[0])}, tm)
    jparams = tconv.conv_recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.params),
         "batch_stats": jax.tree.map(np.asarray, jstats)}, tm)
    largest = max(float(g.abs().max()) for g in jgrads.values())
    if truth is not None:       # the port no farther from float64 than JAX
        assert max(max_rel(to_np(p.grad), truth[n])
                   for n, p in tm.named_parameters()) \
            <= max(max_rel(jgrads[n].numpy(), truth[n]) for n in truth)
    for name, p in tm.named_parameters():
        g, w = to_np(p.grad), jgrads[name].numpy()
        if np.abs(w).max() < NOISE * largest:
            assert np.abs(g - w).max() <= NOISE * largest, name
        else:
            assert min_cosine(g.reshape(1, -1), w.reshape(1, -1)) \
                >= GRAD_COS, name
            assert max_rel(g, w if truth is None else truth[name]) \
                <= GRAD_TOL, name
        got, want = to_np(p), jparams[name].numpy()
        if truth is None:
            assert max_rel(got, want) <= PARAM_TOL, name
        else:       # JAX's gradient error, carried by one SGD update
            assert np.abs(got - want).max() <= PARAM_TOL * np.abs(
                want).max() + CHAIN["learning_rate"] * np.abs(g - w).max(), \
                name
    for name, b in tm.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert max_rel(b.numpy(), jparams[name].numpy()) <= stats_tol, \
                name


CLS_CASES = {"slowfast_s2d": ("slowfast", "classifier",
                              dict(fast_s2d_stem=True)),
             "slowonly_nl": ("slowonly_nl", "classifier", {}),
             "x3d": ("x3d_half", "x3d_classifier", {})}


@pytest.mark.parametrize("case", list(CLS_CASES))
def test_cls_stats_steps_match_jax(case):
    name, wrapper, over = CLS_CASES[case]
    tm, jm, variables = _models(name, wrapper, **over)
    jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(
        **CHAIN), total_steps=5))
    jstate, jstats = _jax_state(variables, jtx), variables["batch_stats"]
    jstep = jrt.make_cls_train_step_stats(jm, jtx)
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**CHAIN), total_steps=5))
    step = trt.make_cls_train_step_stats(tm, device="cpu")
    stats_tol = NL_STATS_TOL if name == "slowonly_nl" else STATS_TOL
    for i in range(2):
        v, lab = _cls_batch(i)
        tstate = _load_jax_state(tstate, jstate, jstats)
        truth = _f64_grads(tm, v, lab) if name == "slowonly_nl" else None
        jstate, jstats, jlogs = jstep(jstate, jstats, jnp.asarray(v),
                                      jnp.asarray(lab, jnp.int32),
                                      jax.random.key(i))
        tstate, tlogs = step(tstate, torch.from_numpy(v),
                             torch.from_numpy(lab))
        _check_step(tm, jstate, jstats, tlogs, jlogs, stats_tol, truth)
        assert float(tlogs["top1_acc"]) == float(jlogs["top1_acc"])
        assert tstate.step == int(jstate.step) == i + 1
        # every parameter takes decay, BatchNorm scales included
        assert tstate.optimizer.weight_decay == CHAIN["weight_decay"]


def test_seq_stats_step_matches_jax():
    tm, jm, variables = _models("csn_ip", "relseq")
    jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(
        **CHAIN), total_steps=5))
    jstate, jstats = _jax_state(variables, jtx), variables["batch_stats"]
    jstep = jrt.make_seq_train_step_stats(jm, jtx)
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**CHAIN), total_steps=5))
    step = trt.make_seq_train_step_stats(tm, device="cpu")
    v, targets, mask = _seq_batch(0)
    jstate, jstats, jlogs = jstep(jstate, jstats, jnp.asarray(v),
                                  jnp.asarray(targets), jnp.asarray(mask),
                                  jax.random.key(0))
    tstate, tlogs = step(tstate, torch.from_numpy(v),
                         torch.from_numpy(targets), torch.from_numpy(mask))
    _check_step(tm, jstate, jstats, tlogs, jlogs, STATS_TOL)
    assert tm.training          # forward_train runs in train mode


def test_bf16_stats_step_matches_jax():
    """The bf16 step (f32 masters, f32 statistics) against JAX's bf16 step
    from the same state, and both against the f32 step."""
    tm, jm, variables = _models("slowfast", "classifier",
                                fast_s2d_stem=True)
    v, lab = _cls_batch(0)
    grads, losses = {}, {}
    for bf16 in (False, True):
        jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(
            **CHAIN), total_steps=5))
        jstep = jrt.make_cls_train_step_stats(jm, jtx, bf16=bf16)
        jstate, jstats, jlogs = jstep(_jax_state(variables, jtx),
                                      variables["batch_stats"],
                                      jnp.asarray(v),
                                      jnp.asarray(lab, jnp.int32),
                                      jax.random.key(0))
        tm.load_state_dict(tconv.conv_recognizer_state_dict_from_jax(
            variables, tm))
        tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
            trt.RecognitionTrainConfig(**CHAIN), total_steps=5))
        tstate, tlogs = trt.make_cls_train_step_stats(
            tm, bf16=bf16, device="cpu")(tstate, torch.from_numpy(v),
                                         torch.from_numpy(lab))
        grads[bf16] = ({n: p.grad.clone() for n, p in tm.named_parameters()},
                       tconv.conv_recognizer_state_dict_from_jax(
                           {"params": jax.tree.map(np.asarray,
                                                   jstate.opt_state[0])}, tm))
        losses[bf16] = (float(tlogs["loss"]), float(jlogs["loss"]))
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        assert all(b.dtype == torch.float32 for n, b in tm.named_buffers()
                   if n.endswith(("running_mean", "running_var")))
        assert all(g.dtype == torch.float32 for g in grads[bf16][0].values())
    port, jax_ = losses[True]
    assert abs(port - jax_) <= BF16_LOSS_REL * abs(jax_)
    assert abs(port - losses[False][0]) <= BF16_LOSS_REL * abs(port)
    cos = _group_cosines(grads[True][0], grads[True][1])
    # how far JAX's own bf16 gradients are from its f32 ones
    jax_own = _group_cosines(
        {n: torch.as_tensor(g) for n, g in grads[True][1].items()},
        {n: g.numpy() for n, g in grads[False][1].items()})
    for group, c in cos.items():
        assert c >= min(BF16_GRAD_COS, jax_own[group]), (cos, jax_own)


# -- precise BN -------------------------------------------------------------------

def test_precise_bn_matches_jax():
    tm, jm, variables = _models("slowfast", "classifier")
    batches = [videos(2, seed=60 + i) for i in range(3)]
    want = jpbn.update_bn_stats(
        jax.jit(lambda v, b: jm.apply(v, b, train=True,
                                      mutable=["batch_stats"])),
        variables, [jnp.asarray(b) for b in batches], num_iters=2)
    tm.eval()
    tpbn.update_bn_stats(tm, [torch.from_numpy(b) for b in batches],
                         num_iters=2)
    assert not tm.training                    # the mode it had
    got = tm.state_dict()
    wsd = tconv.conv_batch_stats_from_jax(want["batch_stats"], tm)
    for k, w in wsd.items():
        if k.endswith(("running_mean", "running_var")):
            assert max_rel(got[k].numpy(), w.numpy()) <= PRECISE_BN_TOL, k


def test_precise_bn_inverts_each_momentum():
    """The average of the true batch statistics, for BatchNorms of torch
    momentum 0.1 (flax 0.9) and 0.03 (YOLO's 0.97), biased variances."""
    from cross_modal_video_engine_tpu_torch.models.layers import (
        FlaxBatchNorm)
    from cross_modal_video_engine_tpu_torch.models.yolo import BatchNorm
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(rng.standard_normal((5, 3, 4, 4)).astype(
        np.float32) * (1 + i) + i) for i in range(3)]
    for bn in (FlaxBatchNorm(3, device="cpu"), BatchNorm(3, device="cpu")):
        tpbn.update_bn_stats(bn, xs)
        mean = np.mean([x.mean((0, 2, 3)).numpy() for x in xs], 0)
        var = np.mean([x.var((0, 2, 3), unbiased=False).numpy() for x in xs],
                      0)
        np.testing.assert_allclose(bn.running_mean.numpy(), mean, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), var, rtol=1e-5)


# -- epoch states --------------------------------------------------------------------

def _bytes(path):
    with open(os.path.join(path, "train_state.msgpack"), "rb") as f:
        return f.read()


def test_epoch_state_with_batch_stats_crosses_packages(tmp_path):
    tm, jm, variables = _models("x3d_half", "x3d_classifier")
    jtx = jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**CHAIN),
                                 total_steps=5)
    jstate, jstats = _jax_state(variables, jtx), variables["batch_stats"]
    jstep = jrt.make_cls_train_step_stats(jm, jtx)
    v, lab = _cls_batch(0)
    jstate, jstats, _ = jstep(jstate, jstats, jnp.asarray(v),
                              jnp.asarray(lab, jnp.int32), jax.random.key(0))
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jres.save_train_state(jax_dir, {"state": jstate, "batch_stats": jstats},
                          {"epoch": 0})
    tx = trt.make_rec_optimizer(trt.RecognitionTrainConfig(**CHAIN),
                                total_steps=5)
    tstate = trt.init_rec_state(tm, tx)
    payload, loop = tres.load_train_state(jax_dir, {"state": tstate,
                                                    "batch_stats": tm})
    assert loop == {"epoch": 0} and payload["batch_stats"] is tm
    tstate = payload["state"]
    assert tstate.step == 1
    want = tconv.conv_recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.params),
         "batch_stats": jax.tree.map(np.asarray, jstats)}, tm)
    for k, t in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, want[k]), k
    tres.save_train_state(port_dir, payload, loop)
    assert _bytes(port_dir) == _bytes(jax_dir)

    # one port step, then JAX reads the port's state
    step = trt.make_cls_train_step_stats(tm, device="cpu")
    v, lab = _cls_batch(1)
    tstate, _ = step(tstate, torch.from_numpy(v), torch.from_numpy(lab))
    tres.save_train_state(port_dir, {"state": tstate, "batch_stats": tm},
                          {"epoch": 1})
    template = {"state": _jax_state(variables, jtx),
                "batch_stats": variables["batch_stats"]}
    jpayload, jloop = jres.load_train_state(port_dir, template)
    assert jloop == {"epoch": 1} and int(jpayload["state"].step) == 2
    got = tconv.conv_recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jpayload["state"].params),
         "batch_stats": jax.tree.map(np.asarray, jpayload["batch_stats"])},
        tm)
    for k, t in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, got[k]), k
    # a payload without statistics does not read a file that has them
    with pytest.raises(ValueError, match="batch_stats"):
        tres.load_train_state(port_dir, {"state": tstate,
                                         "batch_stats": None})


# -- refusals ----------------------------------------------------------------------

def test_stats_steps_refuse_other_models():
    tm, _, _ = _models("i3d", "classifier")
    with pytest.raises(ValueError, match="make_cls_train_step_stats"):
        trt.make_cls_train_step(tm, device="cpu")
    with pytest.raises(ValueError, match="caption model"):
        trt.make_seq_train_step_stats(tm, device="cpu")
    rm, _, _ = _models("i3d", "relseq")
    with pytest.raises(ValueError, match="make_seq_train_step_stats"):
        trt.make_seq_train_step(rm, device="cpu")
    # a model cast whole to bf16 (the serving cast): not f32 masters
    with pytest.raises(ValueError, match="float32 masters"):
        trt.make_cls_train_step_stats(tm.to(torch.bfloat16), device="cpu")

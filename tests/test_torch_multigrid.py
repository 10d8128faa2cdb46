"""Multigrid training (train/multigrid.py and the multigrid part of
train/recognition_trainer.py) of the port against the JAX package's, on
the CPU with the small SlowFast of tests/test_torch_resnet3d.py (alpha 4,
widths 8-32; dropouts 0), raw clips of 8 frames of 32²:

* `MultigridSchedule.bucket_for` over long and short cycles and the final
  epochs, `lr_for`, `compiled_shapes`: equal to JAX's;
* `adapt_clips_to_bucket` (frames by np.round(np.linspace), the
  antialiased bilinear resize of jax.image.resize) within 1e-6;
  `bucketize_batches` and `_RawChunker` array-equal to JAX's (tails
  dropped);
* `make_multigrid_train_step` bucket by bucket (4 frames of 16², where
  alpha 4 leaves the slow path one frame; 8 of 16²; 8 of 32²), each
  from JAX's state: the loss within 1e-5 relative, gradients, parameters
  and statistics as tests/test_torch_resnet3d_train.py holds a step (the
  update times lr_scale, weight decay included);
* `train_multigrid` over four epochs (two coarse, two final), long cycle
  and short cycle, with precise BN: the same buckets, lr_scale and step
  counts per epoch, losses within 1e-3 relative, the recomputed
  statistics of the finest bucket within 5e-3: the variances of their
  largest, the means in units of the channels' largest standard
  deviation (a mean near 0 has no relative precision).  Over the loop
  the parameters drift apart by rounding: 4e-6 of a tensor's largest
  on the long cycle, 1.8e-4 on the short one, whose batch-2 steps at
  16² normalize 1x1 maps, and the statistics by up to 1.2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.train import multigrid as jmg
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.train import multigrid as tmg
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from test_torch_resnet3d import STATS_TOL, videos
from test_torch_resnet3d_train import (CHAIN, CLASSES, _check_step,
                                       _jax_state, _load_jax_state, _models)
from torch_parity import capturing, max_rel, to_np

BUCKETS = ((4, 4, 16), (2, 8, 16), (2, 8, 32))
LOOP_REL, LOOP_STATS = 1e-3, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _schedules(**kw):
    j = jmg.MultigridSchedule(
        buckets=tuple(jmg.GridBucket(*b) for b in BUCKETS), **kw)
    t = tmg.MultigridSchedule(
        buckets=tuple(tmg.GridBucket(*b) for b in BUCKETS), **kw)
    return j, t


@pytest.mark.parametrize("kw", [
    dict(long_cycle_epochs=1, final_epochs=1, base_batch=2),
    dict(long_cycle_epochs=2, final_epochs=2, short_cycle_period=2),
    dict(long_cycle_epochs=1, final_epochs=0, short_cycle_period=3),
    {}])
def test_schedule_matches_jax(kw):
    j, t = _schedules(**kw)
    for total in (1, 5, 11):
        for epoch in range(total):
            for step in range(7):
                jb = j.bucket_for(epoch, total, step)
                tb = t.bucket_for(epoch, total, step)
                assert (tb.batch_size, tb.num_frames, tb.resolution) == (
                    jb.batch_size, jb.num_frames, jb.resolution)
                assert t.lr_for(tb) == j.lr_for(jb) and tb.cost == jb.cost
    assert t.compiled_shapes() == j.compiled_shapes()
    assert tmg.MultigridSchedule().compiled_shapes() == \
        jmg.MultigridSchedule().compiled_shapes()


@pytest.mark.parametrize("frames,res", [(4, 16), (8, 16), (3, 24), (8, 32),
                                        (5, 40)])
def test_adapt_clips_matches_jax(frames, res):
    x = videos(3, frames=8, size=32, seed=70)
    b = (3, frames, res)
    want = np.asarray(jrt.adapt_clips_to_bucket(jnp.asarray(x),
                                                jmg.GridBucket(*b)))
    got = trt.adapt_clips_to_bucket(torch.from_numpy(x), tmg.GridBucket(*b))
    assert tuple(got.shape) == want.shape
    assert np.abs(to_np(got) - want).max() <= 1e-6


def _raw_batches(n=5, batch=3, seed=80):
    rng = np.random.default_rng(seed)
    return [(videos(batch, seed=seed + i),
             rng.integers(0, CLASSES, batch)) for i in range(n)]


def test_bucketize_and_chunker_match_jax():
    raw = _raw_batches()
    for b in BUCKETS:
        want = list(jrt.bucketize_batches(
            [(jnp.asarray(c), jnp.asarray(lab)) for c, lab in raw],
            jmg.GridBucket(*b)))
        got = list(trt.bucketize_batches(
            [(torch.from_numpy(c), torch.from_numpy(lab)) for c, lab in raw],
            tmg.GridBucket(*b)))
        assert len(got) == len(want) == (5 * 3) // b[0]
        for (gc, gl), (wc, wl) in zip(got, want):
            assert np.abs(to_np(gc) - np.asarray(wc)).max() <= 1e-6
            np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    jc = jrt._RawChunker(raw)
    tc = trt._RawChunker([(torch.from_numpy(c), torch.from_numpy(lab))
                          for c, lab in raw])
    for n in (2, 4, 1, 5, 2, 4):
        want, got = jc.take(n), tc.take(n)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("bucket", BUCKETS)
def test_multigrid_step_matches_jax_bucket_by_bucket(bucket):
    tm, jm, variables = _models("slowfast", "classifier")
    base = 2
    scale = bucket[0] / base
    jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(
        **CHAIN), total_steps=5))
    jstate, jstats = _jax_state(variables, jtx), variables["batch_stats"]
    jstep = jrt.make_multigrid_train_step(jm, jtx, scale, True)
    tstate = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**CHAIN), total_steps=5))
    tstep = trt.make_multigrid_train_step(tm, scale, device="cpu")
    x = trt.adapt_clips_to_bucket(
        torch.from_numpy(videos(bucket[0], seed=90)),
        tmg.GridBucket(*bucket)).numpy()
    lab = np.arange(bucket[0]) % CLASSES
    for i in range(2):
        tstate = _load_jax_state(tstate, jstate, jstats)
        params, jstats, opt_state, jlogs = jstep(
            jstate.params, jstats, jstate.opt_state, jnp.asarray(x),
            jnp.asarray(lab, jnp.int32), jax.random.key(i))
        jstate = jrt.RecTrainState(params, opt_state, jstate.step + 1)
        tstate, tlogs = tstep(tstate, torch.from_numpy(x),
                              torch.from_numpy(lab))
        _check_step(tm, jstate, jstats, tlogs, jlogs, STATS_TOL)
    # the schedule's count moves once a step, whatever the bucket
    assert tstate.optimizer.count == 2


def test_update_scale_multiplies_the_whole_update():
    """lr_scale multiplies the optimizer's update after its -lr multiply,
    weight decay included, in float32: p + (-lr · (g + wd · p)) · s."""
    f = np.float32
    g = np.array([0.1, 0.2, -0.3], f)          # below the clip's norm
    for scale in (1.0, 4.0, 0.25):
        p = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
        want = p.detach().numpy().copy()
        opt = trt.make_rec_optimizer(trt.RecognitionTrainConfig(
            **CHAIN))([("p", p)])
        p.grad = torch.from_numpy(g.copy())
        opt.step(update_scale=scale)
        upd = (g + f(CHAIN["weight_decay"]) * want) \
            * f(-CHAIN["learning_rate"])
        want = want + upd * f(scale)
        np.testing.assert_array_equal(p.detach().numpy(), want)
        assert opt.count == 1


def _epoch_batches(seed):
    raw = _raw_batches(n=4, batch=2, seed=seed)

    def jax_batches(epoch):
        for c, lab in raw[epoch % 2:] + raw[:epoch % 2]:
            yield jnp.asarray(c), jnp.asarray(lab)

    def port_batches(epoch):
        for c, lab in raw[epoch % 2:] + raw[:epoch % 2]:
            yield torch.from_numpy(c), torch.from_numpy(lab)

    return jax_batches, port_batches


@pytest.mark.parametrize("short", [0, 2])
def test_train_multigrid_matches_jax(short):
    tm, jm, variables = _models("slowfast", "classifier")
    tcfg = dict(CHAIN, learning_rate=1e-3)
    kw = dict(long_cycle_epochs=1, final_epochs=2, base_batch=2,
              short_cycle_period=short)
    jsched, tsched = _schedules(**kw)
    jb, tb = _epoch_batches(95)
    (jvars, _), jhist = jrt.train_multigrid(
        jm, variables, jrt.RecognitionTrainConfig(**tcfg), jsched, jb, 4,
        precise_bn_batches=2, total_steps=12)
    state, thist = trt.train_multigrid(
        tm, trt.RecognitionTrainConfig(**tcfg), tsched, tb, 4,
        precise_bn_batches=2, total_steps=12, device="cpu")
    assert state.model is tm and state.optimizer.count == sum(
        h["steps"] for h in thist)
    assert [h["epoch"] for h in thist] == [0, 1, 2, 3]
    for t, j in zip(thist, jhist):
        assert t["bucket"] == j["bucket"] and t["steps"] == j["steps"]
        assert t["lr_scale"] == j["lr_scale"]
        assert abs(t["loss"] - j["loss"]) <= LOOP_REL * abs(j["loss"])
    assert {h["bucket"] for h in thist} >= {BUCKETS[0], BUCKETS[-1]}
    want = tconv.conv_recognizer_state_dict_from_jax(
        jax.tree.map(np.asarray, jvars), tm)
    got = tm.state_dict()
    for k, w in want.items():
        if k.endswith("running_var"):
            assert max_rel(got[k].numpy(), w.numpy()) <= LOOP_STATS, k
        elif k.endswith("running_mean"):     # in units of the spread
            spread = float(want[k[:-4] + "var"].max()) ** 0.5
            assert np.abs(got[k].numpy() - w.numpy()).max() \
                <= LOOP_STATS * spread, k

"""OmniSource training (`train_omnisource`, `_cycle`) of the port against
the JAX package's, on the CPU with the small I3D of
tests/test_torch_resnet3d.py (widths 8-32, 8 frames of 32², batch 4;
dropouts 0): a main source of four batches an epoch, train_ratio [2, 1,
2] over two aux sources, the first of two batches (rebuilt when it runs
out), the second empty (its waves end at once).

* Two epochs: the same history keys (`loss`, `top1_acc` and their
  `/aux0` twins; none for the empty source), values within 1e-3
  relative, final weights and statistics within 1e-3 of their largest
  (SGD at lr 1e-3: at 1e-2 the two packages' rounding drifts the first
  conv 1.5e-3 of its largest apart over the twelve steps of BatchNorm on
  batches of 4); the optimizer's count is every step, main and aux.
* `epoch_callback` after each epoch with the state and `it`; a run
  resumed from the JAX-written `epoch_0` (`{"params", "batch_stats",
  "opt_state"}`, loop state `{"epoch", "it"}`) ends where JAX's
  uninterrupted run ends, and one resumed from the port's own `epoch_0`
  ends bit for bit where the port's uninterrupted run ends.
* `_cycle` rebuilds an exhausted source and stops at an empty one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu.train import resume as jres
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from cross_modal_video_engine_tpu_torch.train import resume as tres
from test_torch_resnet3d import videos
from test_torch_resnet3d_train import CHAIN, CLASSES, _models
from torch_parity import max_rel

RATIO = (2, 1, 2)
HIST_REL, FINAL_TOL = 1e-3, 1e-3
TCFG = dict(CHAIN, learning_rate=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _sources(to):
    """(main_batches(epoch), [aux0(), aux1()]) over seeded clips, as `to`
    (jnp.asarray or torch.from_numpy) makes them."""
    rng = np.random.default_rng(7)
    main = [(videos(4, seed=500 + i), rng.integers(0, CLASSES, 4))
            for i in range(4)]
    aux = [(videos(4, seed=600 + i), rng.integers(0, CLASSES, 4))
           for i in range(2)]

    def main_batches(epoch):
        order = main[epoch % 4:] + main[:epoch % 4]
        return [(to(c), to(lab)) for c, lab in order]

    return main_batches, [lambda: [(to(c), to(lab)) for c, lab in aux],
                          lambda: []]


def _state_dict(tm):
    return {k: v.clone() for k, v in tm.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _close(got, want):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert max_rel(got[k].numpy(), w.numpy()) <= FINAL_TOL, k


def test_cycle_rebuilds_and_stops():
    made = []

    def source():
        made.append(1)
        return iter([1, 2])

    it = trt._cycle(source)
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1] and len(made) == 3
    assert list(trt._cycle(lambda: iter([]))) == []


def test_train_omnisource_matches_jax_and_resumes(tmp_path):
    tm, jm, variables = _models("i3d", "classifier")
    start = _state_dict(tm)
    jmain, jaux = _sources(jnp.asarray)
    saved = {}

    def jsave(epoch, st):
        path = str(tmp_path / f"jax_epoch_{epoch}")
        jres.save_train_state(path, {"params": st["params"],
                                     "batch_stats": st["batch_stats"],
                                     "opt_state": st["opt_state"]},
                              {"epoch": epoch, "it": st["it"]})
        saved[epoch] = st["it"]

    jvars, jhist = jrt.train_omnisource(
        jm, variables, jrt.RecognitionTrainConfig(**TCFG), jmain, jaux,
        RATIO, 2, total_steps=20, epoch_callback=jsave)
    assert saved == {0: 4, 1: 8}

    tmain, taux = _sources(torch.from_numpy)
    seen = []

    def tsave(epoch, st):
        seen.append((epoch, st["it"], st["state"].step))
        tres.save_train_state(str(tmp_path / f"port_epoch_{epoch}"),
                              {"omnisource": st["state"],
                               "batch_stats": tm}, {"epoch": epoch,
                                                    "it": st["it"]})

    state, thist = trt.train_omnisource(
        tm, trt.RecognitionTrainConfig(**TCFG), tmain, taux, RATIO, 2,
        total_steps=20, epoch_callback=tsave, device="cpu")
    # two waves an epoch of one aux0 batch; aux1 is empty
    assert seen == [(0, 4, 6), (1, 8, 12)]
    assert state.optimizer.count == 12
    assert [set(h) for h in thist] == [set(h) for h in jhist] == [
        {"epoch", "loss", "top1_acc", "loss/aux0", "top1_acc/aux0"}] * 2
    for t, j in zip(thist, jhist):
        for k in j:
            assert abs(t[k] - j[k]) <= HIST_REL * max(abs(j[k]), 1e-3), k
    want = tconv.conv_recognizer_state_dict_from_jax(
        jax.tree.map(np.asarray, jvars), tm)
    _close(tm.state_dict(), want)
    final = _state_dict(tm)

    # resumed from JAX's epoch_0: JAX's final weights
    for src, check in (("jax", lambda: _close(tm.state_dict(), want)),
                       ("port", lambda: [
                           torch.testing.assert_close(
                               v, final[k], rtol=0, atol=0)
                           for k, v in _state_dict(tm).items()])):
        tm.load_state_dict(start, strict=False)
        fresh = trt.init_rec_state(tm, trt.make_rec_optimizer(
            trt.RecognitionTrainConfig(**TCFG), total_steps=20))
        payload, loop = tres.load_train_state(
            str(tmp_path / f"{src}_epoch_0"),
            {"omnisource": fresh, "batch_stats": tm})
        assert loop == {"epoch": 0, "it": 4}
        tmain, taux = _sources(torch.from_numpy)
        state, hist = trt.train_omnisource(
            tm, trt.RecognitionTrainConfig(**TCFG), tmain, taux, RATIO, 2,
            total_steps=20, start_epoch=1, state=payload["omnisource"],
            init_it=loop["it"], device="cpu")
        assert [h["epoch"] for h in hist] == [1]
        check()


def test_omnisource_epoch_state_layout_is_jax(tmp_path):
    """The port's epoch file holds the tree the JAX CLI writes: JAX's
    load_train_state reads it onto its own template leaf for leaf."""
    tm, jm, variables = _models("i3d", "classifier")
    tx = jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**TCFG),
                                total_steps=20)
    state = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**TCFG), total_steps=20))
    path = str(tmp_path / "epoch_3")
    tres.save_train_state(path, {"omnisource": state, "batch_stats": tm},
                          {"epoch": 3, "it": 17})
    template = {"params": variables["params"],
                "batch_stats": variables["batch_stats"],
                "opt_state": tx.init(variables["params"])}
    got, loop = jres.load_train_state(path, template)
    assert loop == {"epoch": 3, "it": 17}
    want = tconv.conv_recognizer_variables_to_jax(tm.state_dict(), tm)
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert os.path.exists(os.path.join(path, "loop_state.json"))


def test_train_ratio_must_name_each_source():
    tm, _, _ = _models("i3d", "classifier")
    main, aux = _sources(torch.from_numpy)
    with pytest.raises(ValueError, match="aux sources"):
        trt.train_omnisource(tm, trt.RecognitionTrainConfig(**TCFG), main,
                             aux, (2, 1), 1, device="cpu")

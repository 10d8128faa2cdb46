"""The port's Combiner training against the JAX package's, on the CPU at
tiny widths: the contrastive loss and its gradient against optax, one
train step against the JAX step (with and without the global-norm clip),
`composed_rank_eval` (both of the JAX function's branches), the combiner
trainer's CLI whose `model_best` the JAX `load_checkpoint` restores, and
`composed_validate`'s report against the JAX CLI's on the same files.

Tolerances: the loss within 1e-5 relative; each gradient tensor within
1e-4 of its norm plus 1e-6 of the whole gradient's norm; the parameters
after one Adam step within 1e-6 where the JAX gradient is above 1e-3 of
its largest element, else within 2 lr (Adam's first update is lr * g /
(|g| + eps), whose sign rounding noise picks where g is noise); restored
checkpoints give combine_features within 1e-5; rankings by their recalls
and the sets of their top-k, which rows at equal distance may reorder."""

import argparse
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_torch_composed_retrieval import EDITS, write_triplets

from cross_modal_video_engine_tpu.cli import composed_validate as jcv
from cross_modal_video_engine_tpu.losses import contrastive as jloss
from cross_modal_video_engine_tpu.models import combiner as jcomb
from cross_modal_video_engine_tpu.train import checkpoint as jckpt
from cross_modal_video_engine_tpu.train import combiner_trainer as jtr
from cross_modal_video_engine_tpu_torch.bench import serve as bserve
from cross_modal_video_engine_tpu_torch.cli import combiner_trainer as tct
from cross_modal_video_engine_tpu_torch.cli import composed_inference as tci
from cross_modal_video_engine_tpu_torch.cli import composed_validate as tcv
from cross_modal_video_engine_tpu_torch.convert import from_jax as fj
from cross_modal_video_engine_tpu_torch.losses import contrastive as tloss
from cross_modal_video_engine_tpu_torch.models import clip as tclip
from cross_modal_video_engine_tpu_torch.models import combiner as tcomb
from cross_modal_video_engine_tpu_torch.train import combiner_trainer as ttr
from cross_modal_video_engine_tpu_torch.utils.bpe import write_toy_merges

COMB = dict(clip_feature_dim=32, projection_dim=24, hidden_dim=40)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def test_contrastive_loss_and_gradient_match_optax():
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((6, 8)).astype(np.float32)
    pred /= np.linalg.norm(pred, axis=1, keepdims=True)
    target = rng.standard_normal((6, 8)).astype(np.float32)
    target /= np.linalg.norm(target, axis=1, keepdims=True)

    def jfn(p):
        return jloss.clip_contrastive_loss(jloss.info_nce_logits(
            p, jnp.asarray(target)))

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    logits = tloss.info_nce_logits(p, torch.from_numpy(target))
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jloss.info_nce_logits(jnp.asarray(pred),
                                         jnp.asarray(target))),
        rtol=0, atol=1e-4)
    got = tloss.clip_contrastive_loss(logits)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5 * float(np.abs(want_g).max()))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloss.sharded_contrastive_loss(p, p, "data")


def batch(b=6, f=4, seed=3):
    rng = np.random.default_rng(seed)
    d = COMB["clip_feature_dim"]
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, f, d), (b, f, 16, d), (b, d), (b, f, d), (b, f, 16, d))]


def jax_tree(model):
    """The port's parameters or gradients as the JAX params tree."""
    return fj.combiner_variables_to_jax(
        {n: p.detach() for n, p in model.named_parameters()},
        model.cfg)["params"]


def grads_tree(model):
    return fj.combiner_variables_to_jax(
        {n: p.grad for n, p in model.named_parameters()},
        model.cfg)["params"]


@pytest.mark.parametrize("mix", ["dense", "conv4x4"])
@pytest.mark.parametrize("grad_clip", [0.0, 1e-3], ids=["noclip", "clip"])
def test_one_train_step_matches_jax(grad_clip, mix):
    cfg = tcomb.CombinerConfig(**COMB, dropout=0.0, middle_mix=mix)
    tcfg = ttr.CombinerTrainConfig(learning_rate=LR, grad_clip=grad_clip)
    model = tcomb.Combiner(cfg, device="cpu")
    state = ttr.init_combiner_state(model, ttr.make_combiner_optimizer(tcfg),
                                    seed=4)
    params0 = jax_tree(model)
    h, m, text, th, tm = batch()
    state, loss = ttr.make_combiner_train_step(model)(
        state, (torch.from_numpy(h), torch.from_numpy(m)),
        torch.from_numpy(text), (torch.from_numpy(th), torch.from_numpy(tm)))
    assert state.model is model and state.optimizer.count == 1

    jm = jcomb.Combiner(jcomb.CombinerConfig(**COMB, dropout=0.0,
                                             middle_mix=mix))
    tx = jtr.make_combiner_optimizer(jtr.CombinerTrainConfig(
        learning_rate=LR, grad_clip=grad_clip))
    jstate = jtr.CombinerTrainState(params0, tx.init(params0))
    args = ((jnp.asarray(h), jnp.asarray(m)), jnp.asarray(text),
            (jnp.asarray(th), jnp.asarray(tm)), jax.random.key(0))
    jstate, jloss_v = jtr.make_combiner_train_step(jm, tx)(jstate, *args)

    def loss_fn(params):
        logits = jm.apply({"params": params}, *args[:3], train=True,
                          rngs={"dropout": args[3]})
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.arange(logits.shape[0])).mean()

    jgrads = jax.jit(jax.grad(loss_fn))(params0)
    np.testing.assert_allclose(float(loss), float(jloss_v), rtol=1e-5)
    g_port = jax.tree_util.tree_leaves(grads_tree(model))
    g_jax = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    total = np.sqrt(sum(float((g ** 2).sum()) for g in g_jax))
    gmax = max(float(np.abs(g).max()) for g in g_jax)
    if grad_clip:
        assert total > 10 * grad_clip            # the clip acts
    for gp, gj in zip(g_port, g_jax):
        err = np.linalg.norm(gp - gj)
        assert err <= 1e-4 * np.linalg.norm(gj) + 1e-6 * total
    p_port = jax.tree_util.tree_leaves(jax_tree(model))
    p_jax = [np.asarray(p) for p in jax.tree_util.tree_leaves(jstate.params)]
    for pp, pj, gj in zip(p_port, p_jax, g_jax):
        noise = np.abs(gj) < 1e-3 * gmax
        diff = np.abs(pp - pj)
        assert diff[~noise].max(initial=0.0) <= 1e-6
        assert diff[noise].max(initial=0.0) <= 2 * LR


@pytest.mark.parametrize("n_index", [30, 5000],
                         ids=["top_k", "approx_max_k"])
def test_composed_rank_eval_matches_jax(n_index):
    cfg = tcomb.CombinerConfig(**COMB, middle_mix="dense")
    sd = tcomb.random_state_dict(cfg, 6)
    model = tcomb.Combiner(cfg, device="cpu")
    model.load_state_dict(sd)
    rng = np.random.default_rng(7)
    h, m, text, _, _ = batch(b=5, seed=8)
    index = rng.standard_normal((n_index, 4, 32)).astype(np.float32)
    ref_rows = rng.integers(0, n_index, 5)
    gt_rows = rng.integers(0, n_index, 5)
    # make some queries hit: their target is the predicted feature itself
    with torch.no_grad():
        pred = model.combine_features((torch.from_numpy(h),
                                       torch.from_numpy(m)),
                                      torch.from_numpy(text)).numpy()
    index[gt_rows[:3]] = pred[:3, None, :]
    index[ref_rows[3]] = pred[3]          # a reference row that would win
    order, metrics = ttr.composed_rank_eval(
        model, (torch.from_numpy(h), torch.from_numpy(m)),
        torch.from_numpy(text), torch.from_numpy(index),
        torch.from_numpy(ref_rows), torch.from_numpy(gt_rows))
    jm = jcomb.Combiner(jcomb.CombinerConfig(**COMB, middle_mix="dense"))
    jorder, jmetrics = jtr.composed_rank_eval(
        jm, fj.combiner_variables_to_jax(sd, cfg)["params"],
        (jnp.asarray(h), jnp.asarray(m)), jnp.asarray(text),
        jnp.asarray(index), jnp.asarray(ref_rows), jnp.asarray(gt_rows))
    assert metrics == jmetrics and metrics["recall_at1"] >= 60.0
    assert order.shape == np.asarray(jorder).shape == (5, min(50, n_index))
    assert not (order[:, :n_index - 1] == ref_rows[:, None]).any()
    for k in (1, 5, 10, 50):
        for a, b in zip(order[:, :k], np.asarray(jorder)[:, :k]):
            assert set(a) == set(b)


# -- the CLIs -----------------------------------------------------------------

VIT32 = tclip.CLIPConfig(embed_dim=32, image_resolution=64, vision_width=48,
                         vision_layers=2, vision_heads=4, patch_size=16,
                         context_length=12, vocab_size=800, text_width=40,
                         text_heads=4, text_layers=2, dtype="float32")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The combiner trainer's CLI for two epochs on a tiny triplet set,
    with the frozen f32 ViT text tower."""
    root = str(tmp_path_factory.mktemp("comb"))
    tsv, feats, id2name = write_triplets(root, n_videos=8, n_triplets=12,
                                         dim=32)
    clip = os.path.join(root, "clip")
    bserve.write_clip_checkpoint(clip, VIT32, seed=2)
    merges = os.path.join(root, "merges.txt")
    write_toy_merges(merges, EDITS, n_merges=16)
    out = os.path.join(root, "out")
    history = tct.main([
        "--triplets", tsv, "--features_root", feats, "--id2name", id2name,
        "--clip_checkpoint", clip, "--merges", merges, "--out_dir", out,
        "--batch_size", "4", "--num_epochs", "2", "--learning_rate", "1e-3",
        "--projection_dim", "24", "--hidden_dim", "40", "--device", "cpu"])
    return argparse.Namespace(tsv=tsv, feats=feats, id2name=id2name,
                              clip=clip, merges=merges, out=out,
                              history=history)


def test_combiner_trainer_writes_a_model_best_jax_restores(trained):
    hist = trained.history
    assert [r["epoch"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["loss"]) and len(r["step_losses"]) == 3
               for r in hist)
    assert {"recall_at1", "mean_recall"} <= set(hist[0])    # frequency 3
    best = os.path.join(trained.out, "model_best")
    variables, cfg_d, meta = jckpt.load_checkpoint(best)
    assert cfg_d["clip_feature_dim"] == 32 and cfg_d["middle_mix"] == "dense"
    assert meta["epoch"] == 0
    h, m, text, _, _ = batch(b=3, seed=9)
    jm = jcomb.Combiner(jcomb.CombinerConfig(**cfg_d))
    want = jax.jit(functools.partial(jm.apply, method="combine_features"))(
        variables, (jnp.asarray(h), jnp.asarray(m)), jnp.asarray(text))
    model = tci.load_combiner(best, "cpu", require_config=True)
    with torch.no_grad():
        got = model.combine_features((torch.from_numpy(h),
                                       torch.from_numpy(m)),
                                      torch.from_numpy(text))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_composed_validate_report_matches_jax(trained, tmp_path):
    args = ["--triplets", trained.tsv, "--features_root", trained.feats,
            "--id2name", trained.id2name, "--clip_checkpoint", trained.clip,
            "--combiner_checkpoint", os.path.join(trained.out, "model_best"),
            "--merges", trained.merges, "--batch_size", "5"]
    want = jcv.main(args + ["--output", str(tmp_path / "j.npy")])
    got = tcv.main(args + ["--output", str(tmp_path / "t.npy"),
                           "--device", "cpu"])
    assert got == want and got["n_queries"] == 12
    jo, to = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert jo.shape == to.shape == (12, 8)
    for k in (1, 5, 8):
        for a, b in zip(to[:, :k], jo[:, :k]):
            assert set(a) == set(b)


def test_composed_validate_refuses_a_checkpoint_without_config(tmp_path):
    from cross_modal_video_engine_tpu_torch.train.checkpoint import (
        save_checkpoint)
    cfg = tcomb.CombinerConfig(**COMB)
    save_checkpoint(str(tmp_path / "c"), fj.combiner_variables_to_jax(
        tcomb.random_state_dict(cfg, 1), cfg))
    with pytest.raises(ValueError, match="no CombinerConfig"):
        tci.load_combiner(str(tmp_path / "c"), "cpu", require_config=True)

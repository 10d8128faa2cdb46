"""The port's Recognizer2D with the TSN and TRN heads, and its BatchNorm
training, against the JAX package's, on the CPU at a small size (the
backbones of tests/test_torch_backbones2d.py: 4 frames of 32², batch 3;
TRN with hidden 8, bottleneck 12).

One state dict drawn from a numpy seed loads into the port as it is and
into the JAX package through the port's convert/from_jax.py (TRNHead has
no importer; for TSM with its TSNHead the converter's tree is the
importer's, convert_tsm with `cls_head.fc_cls`, exactly).

* Eval logits and `forward_test`'s softmax within FWD_TOL (1e-5) of the
  largest, f32, for TSM, TIN (both forms), MobileNetV2-TSM and TANet
  under TSNHead, and TSM under TRNHead in both relation types; TRN's
  evenly spaced eval tuples.
* Train mode: the random parts are handed to both packages.  TRN's
  tuple picks go to the port as `picks` (or in place of its draw) and
  to JAX in place of `jax.random.choice`; the dropout masks go to the
  port's `layers.Dropout` and to flax's Dropout in place of
  `jax.random.bernoulli`, one mask per shape.
* One step of `make_cls_train_step_stats` from the same weights in both
  packages (SGD with momentum, weight decay and the clip engaged) for
  TSM, TIN (mmaction's form), TSN with its head's dropout and
  TRNMultiScale with its picks and dropout: the loss within 1e-5
  relative, each gradient within GRAD_TOL (1e-4) of its tensor's largest
  and at cosine >= 0.9999 (a gradient that is rounding noise in both,
  below NOISE of the model's largest, within NOISE of it instead), each
  parameter and running statistic after the step within 1e-5 of its
  tensor's largest.  `bf16=True` against JAX's bf16 step on TSM.
* The caption step (`make_seq_train_step_stats`) of a RecognizerRelseq
  on TSM behind the temporal mean (seq_generate/tsm_relseq.py's model).
* The steps' refusals of the models they do not train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import recognition_train as jcli
from cross_modal_video_engine_tpu.convert import torch_import as ti
from cross_modal_video_engine_tpu.models import decoder_head as jdh
from cross_modal_video_engine_tpu.models import heads as jheads
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.cli import recognition_train as tcli
from cross_modal_video_engine_tpu_torch.models import layers as tlayers
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)
from test_torch_backbones2d import FAMILIES, T, _build, clips
from test_torch_resnet3d import japply, random_conv_state_dict
from torch_parity import capturing, max_rel, min_cosine, to_np

FWD_TOL, TRAIN_TOL = 1e-5, 1e-4
CLASSES, BATCH = 6, 3
LOSS_REL, GRAD_COS, GRAD_TOL = 1e-5, 0.9999, 1e-4
NOISE = 1e-5                 # of the model's largest gradient
PARAM_TOL = STATS_TOL = 1e-5
BF16_LOSS_REL, BF16_MARGIN = 2e-2, 0.05
CHAIN = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
             weight_decay=1e-2, grad_clip=0.5)
TRN = dict(num_segments=T, hidden_dim=8, bottleneck_dim=12,
           dropout_ratio=0.8)
HEADS = {"tsn": None, "trn": dict(TRN, relation_type="TRN"),
         "trn_multiscale": dict(TRN, relation_type="TRNMultiScale",
                                max_subsample=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def pair(backbone: str, head: str, seed: int = 5, dropout: float = 0.4):
    """(port Recognizer2D with a seeded state dict, its state dict, the JAX
    Recognizer2D, its variables through the port's converter)."""
    tcls, tcfg, jcls, jcfg, _, _ = FAMILIES[backbone]
    trn = HEADS[head]
    tm = trec.Recognizer2D(_build(tcls, tcfg), CLASSES, trn=trn,
                           dropout_ratio=dropout)
    sd = random_conv_state_dict(tm, seed)
    tm.load_state_dict(sd)
    jhead = (jheads.TSNHead(CLASSES, dropout_ratio=dropout) if trn is None
             else jheads.TRNHead(CLASSES, **trn))
    jm = jrec.Recognizer2D(jcls(jcfg), jhead)
    return tm, sd, jm, tconv.conv_recognizer_variables_to_jax(sd, tm)


def labels(seed: int = 300) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, CLASSES, BATCH)


@pytest.fixture
def same_random(monkeypatch):
    """same_random(picks={scale: indices}, masks={shape: bool array}):
    the TRN picks and dropout masks both packages use."""
    def install(picks=None, masks=None, head=None):
        if picks is not None:
            by_n = {len(head.combos(s)): np.asarray(p) for s, p in
                    picks.items()}
            monkeypatch.setattr(
                jax.random, "choice",
                lambda key, a, shape=(), replace=True, p=None, axis=0:
                jnp.asarray(by_n[int(a)], jnp.int32))
            monkeypatch.setattr(head, "draw_picks", lambda: picks)
        if masks is not None:
            monkeypatch.setattr(
                jax.random, "bernoulli",
                lambda key, p=0.5, shape=None: jnp.asarray(
                    masks[tuple(shape)]))

            def forward(self, x):
                if not self.training or self.p == 0.0:
                    return x
                keep = torch.from_numpy(masks[tuple(x.shape)])
                return torch.where(keep, x / (1.0 - self.p), 0.0)

            monkeypatch.setattr(tlayers.Dropout, "forward", forward)
    return install


def draw_masks(shapes, p, seed=9):
    rng = np.random.default_rng(seed)
    return {tuple(s): rng.random(s) >= p for s in shapes}


# -- forward ------------------------------------------------------------------

EVAL_CASES = [("tsm", "tsn"), ("tsm", "trn"), ("tsm", "trn_multiscale"),
              ("tin", "tsn"), ("tin_exact", "tsn"),
              ("mobilenetv2_tsm", "tsn"), ("tanet", "tsn")]


@pytest.mark.parametrize("backbone,head", EVAL_CASES)
def test_eval_logits_match_jax(backbone, head):
    tm, _, jm, variables = pair(backbone, head)
    x = clips(backbone, batch=BATCH)
    want = np.asarray(japply(jm, variables, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        probs = tm.forward_test(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (BATCH, CLASSES)
    assert max_rel(got, want) <= FWD_TOL
    wprobs = np.asarray(japply(jm, variables, jnp.asarray(x),
                               method="forward_test"))
    assert max_rel(probs, wprobs) <= FWD_TOL
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-6)


def test_tsn_head_converter_is_the_importer():
    tm, sd, _, variables = pair("tsm", "tsn")
    want = ti.convert_tsm(sd, FAMILIES["tsm"][3])
    assert jax.tree.structure(variables) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(variables), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("head", ["trn", "trn_multiscale"])
def test_trn_converts_both_ways(head):
    tm, sd, jm, variables = pair("tsm", head)
    names = set(variables["params"]["cls_head"])
    if head == "trn":
        assert names == {"fc_cls", "relation_fc1", "relation_fc2"}
    else:
        assert names == {"fc_cls"} | {f"fusion_s{s}_fc{k}"
                                      for s in (4, 3, 2) for k in (1, 2)}
    back = tconv.conv_recognizer_state_dict_from_jax(variables, tm)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_trn_eval_picks_are_evenly_spaced():
    tm, _, _, _ = pair("tsm", "trn_multiscale")
    head = tm.cls_head
    import itertools
    for scale in (3, 2):
        combos = list(itertools.combinations(range(T), scale))
        np.testing.assert_array_equal(head.combos(scale), np.asarray(combos))
        want = np.linspace(0, len(combos) - 1, 2).round().astype(int)
        np.testing.assert_array_equal(head.eval_picks(scale), want)


def test_trn_picks_come_from_the_generator():
    tm, _, _, _ = pair("tsm", "trn_multiscale")
    head = tm.cls_head
    draws = []
    for _ in range(2):
        head.generator = torch.Generator().manual_seed(4)
        draws.append(head.draw_picks())
    for scale in (3, 2):
        np.testing.assert_array_equal(draws[0][scale], draws[1][scale])
        p = draws[0][scale]
        assert len(p) == 2 and len(set(p.tolist())) == 2
        assert 0 <= p.min() and p.max() < len(head.combos(scale))


def test_trn_train_forward_with_the_same_picks_and_masks(same_random):
    tm, _, jm, variables = pair("tsm", "trn_multiscale")
    x = clips("tsm", batch=BATCH)
    picks = {3: np.array([3, 1]), 2: np.array([5, 0])}
    masks = draw_masks([(BATCH, T, tm.backbone.feat_dim)], 0.8)
    same_random(picks, masks, tm.cls_head)
    want, _ = japply(jm, variables, jnp.asarray(x), train=True,
                     mutable=["batch_stats"], rngs={
                         "dropout": jax.random.key(0),
                         "relation": jax.random.key(1)})
    tm.train()
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert max_rel(got, np.asarray(want)) <= TRAIN_TOL
    # the tuples are the picks', not the eval ones
    tm.eval()
    with torch.no_grad():
        evl = tm.cls_head(tm.backbone(torch.from_numpy(x)))
        picked = tm.cls_head(tm.backbone(torch.from_numpy(x)), picks=picks)
    assert not torch.allclose(evl, picked)


# -- train steps --------------------------------------------------------------

def _jax_state(variables, tx):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jrt.RecTrainState(params, tx.init(params),
                             jnp.zeros((), jnp.int32))


def _optimizers():
    jtx = capturing(jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(
        **CHAIN), total_steps=5))
    ttx = trt.make_rec_optimizer(trt.RecognitionTrainConfig(**CHAIN),
                                 total_steps=5)
    return jtx, ttx


def check_step(tm, jstate, jstats, tlogs, jlogs):
    """The port's step against JAX's from the same state (see the module
    docstring)."""
    jloss = float(jlogs["loss"])
    assert abs(float(tlogs["loss"]) - jloss) <= LOSS_REL * abs(jloss)
    jgrads = tconv.conv_recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.opt_state[0])}, tm)
    jparams = tconv.conv_recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, jstate.params),
         "batch_stats": jax.tree.map(np.asarray, jstats)}, tm)
    largest = max(float(g.abs().max()) for g in jgrads.values())
    for name, p in tm.named_parameters():
        g, w = to_np(p.grad), jgrads[name].numpy()
        if np.abs(w).max() < NOISE * largest:
            assert np.abs(g - w).max() <= NOISE * largest, name
        else:
            assert min_cosine(g.reshape(1, -1), w.reshape(1, -1)) \
                >= GRAD_COS, name
            assert max_rel(g, w) <= GRAD_TOL, name
        assert max_rel(to_np(p), jparams[name].numpy()) <= PARAM_TOL, name
    for name, b in tm.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            assert max_rel(b.numpy(), jparams[name].numpy()) <= STATS_TOL, \
                name


STEP_CASES = {"tsm": ("tsm", "tsn", 0.0), "tin_exact": ("tin_exact", "tsn",
                                                         0.0),
              "tsn_dropout": ("tsn", "tsn", 0.4),
              "trn_multiscale": ("tsm", "trn_multiscale", None)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_cls_stats_step_matches_jax(case, same_random):
    backbone, head, dropout = STEP_CASES[case]
    tm, _, jm, variables = pair(backbone, head, dropout=dropout or 0.0)
    feat = tm.backbone.feat_dim
    if head == "trn_multiscale":
        same_random({3: np.array([2, 0]), 2: np.array([1, 4])},
                    draw_masks([(BATCH, T, feat)], 0.8), tm.cls_head)
    elif dropout:
        same_random(masks=draw_masks([(BATCH, feat)], dropout))
    jtx, ttx = _optimizers()
    jstate, jstats = _jax_state(variables, jtx), variables["batch_stats"]
    x, lab = clips(backbone, batch=BATCH, seed=41), labels()
    jstate, jstats, jlogs = jrt.make_cls_train_step_stats(jm, jtx)(
        jstate, jstats, jnp.asarray(x), jnp.asarray(lab, jnp.int32),
        jax.random.key(0))
    tstate = trt.init_rec_state(tm, ttx)
    tstate, tlogs = trt.make_cls_train_step_stats(
        tm, generator=torch.Generator().manual_seed(0), device="cpu")(
        tstate, torch.from_numpy(x), torch.from_numpy(lab))
    check_step(tm, jstate, jstats, tlogs, jlogs)
    assert float(tlogs["top1_acc"]) == float(jlogs["top1_acc"])
    assert tstate.step == int(jstate.step) == 1


def test_bf16_stats_step_matches_jax():
    """bf16 (f32 masters and statistics) against JAX's bf16 step: the loss
    within 2e-2 relative of JAX's and of the f32 step's; the gradients by
    group (convs, BatchNorms, head) at a cosine to the f32 step's no more
    than BF16_MARGIN (0.05) below min(0.99, JAX's bf16 gradients' cosine to
    them).  On this model JAX's bf16 step is the closer one on the CPU
    (conv 0.945, BN 0.956, head 0.9995 against the port's 0.902, 0.928,
    0.9989; on the TPN of tests/test_torch_tpn.py the port's is): each of
    the port's bf16 ops rounds its output, as cuDNN's do on the card,
    where XLA's CPU fusions may keep f32 between the ops they fuse (not
    verified); a single bf16 conv or BatchNorm backward of the port rounds
    once (its error is one rounding of the f32 result)."""
    from test_torch_resnet3d_train import _group_cosines
    tm, _, jm, variables = pair("tsm", "tsn", dropout=0.0)
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    x, lab = clips("tsm", batch=BATCH, seed=42), labels(301)
    grads, losses = {}, {}
    for bf16 in (False, True):
        jtx, ttx = _optimizers()
        jstate, _, jlogs = jrt.make_cls_train_step_stats(jm, jtx, bf16=bf16)(
            _jax_state(variables, jtx), variables["batch_stats"],
            jnp.asarray(x), jnp.asarray(lab, jnp.int32), jax.random.key(0))
        tm.load_state_dict(sd)
        tstate, tlogs = trt.make_cls_train_step_stats(
            tm, bf16=bf16, device="cpu")(trt.init_rec_state(tm, ttx),
                                         torch.from_numpy(x),
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
    assert abs(port - jax_) <= BF16_LOSS_REL * abs(jax_)
    assert abs(port - losses[False][0]) <= BF16_LOSS_REL * abs(port)
    cos = _group_cosines(grads[True][0], {
        n: g.numpy() for n, g in grads[False][1].items()})
    jax_own = _group_cosines(
        {n: torch.as_tensor(g) for n, g in grads[True][1].items()},
        {n: g.numpy() for n, g in grads[False][1].items()})
    for group, c in cos.items():
        assert c >= min(0.99, jax_own[group]) - BF16_MARGIN, (cos, jax_own)


def test_tsm_relseq_caption_step_matches_jax():
    """seq_generate/tsm_relseq.py's model at a small size: TSM behind the
    temporal mean into the RNN decoder, one SeqMLL step."""
    tcls, tcfg, jcls, jcfg, _, _ = FAMILIES["tsm"]
    dec = dict(num_classes=5, in_channels=256, max_len=3,
               input_dropout_p=0.0)
    tm = trec.RecognizerRelseq(tcli._TemporalMean(_build(tcls, tcfg)),
                               RNNDecoderConfig(**dec))
    tm.load_state_dict(random_conv_state_dict(tm, 7))
    jm = jrec.RecognizerRelseq(jcli._TemporalMean(jcls(jcfg)),
                               jdh.RNNDecoderConfig(**dec))
    variables = tconv.conv_recognizer_variables_to_jax(tm.state_dict(), tm)
    assert "inner" in variables["params"]["backbone"]
    rng = np.random.default_rng(400)
    targets = (rng.random((BATCH, 3, 5)) < 0.4).astype(np.float32)
    mask = np.ones((BATCH, 3), np.float32)
    mask[0, 2] = 0.0
    x = clips("tsm", batch=BATCH, seed=43)
    jtx, ttx = _optimizers()
    jstate, jstats, jlogs = jrt.make_seq_train_step_stats(jm, jtx)(
        _jax_state(variables, jtx), variables["batch_stats"],
        jnp.asarray(x), jnp.asarray(targets), jnp.asarray(mask),
        jax.random.key(0))
    tstate, tlogs = trt.make_seq_train_step_stats(tm, device="cpu")(
        trt.init_rec_state(tm, ttx), torch.from_numpy(x),
        torch.from_numpy(targets), torch.from_numpy(mask))
    check_step(tm, jstate, jstats, tlogs, jlogs)


def test_steps_refuse_the_models_they_do_not_train():
    tm, _, _, _ = pair("tsm", "tsn")
    with pytest.raises(ValueError, match="make_cls_train_step_stats"):
        trt.make_cls_train_step(tm, device="cpu")
    with pytest.raises(ValueError, match="caption model"):
        trt.make_seq_train_step_stats(tm, device="cpu")
    with pytest.raises(ValueError, match="TPNRecognizer"):
        trt.make_tpn_train_step_stats(tm, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        trt.make_cls_train_step_stats(torch.nn.Linear(2, 2), device="cpu")

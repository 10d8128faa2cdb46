"""The AVA detection modules of the PyTorch port against the JAX package,
on the CPU at the JAX tests' small shapes (SlowOnly stage_blocks (1, 1, 1,
1), base_channels 8, 4 frames of 32², roi_size 2, 4 classes, ACRN out 8,
FBO latent 8 with one non-local layer, banks of 6 channels).

Tolerances, f32 on both sides: RoIAlign within 1e-5 of the largest
output; the detector's logits within 1e-5 of the largest; one train step
from the same state with the same dropout masks (handed to the port as
`draws`, to JAX in place of `jax.random.bernoulli`): the loss and label
accuracy within 1e-5 relative, each parameter and running statistic after
the step within 1e-5 of its tensor's largest.  The host code (metrics,
the results csv, the dataset, SampleAVAFrames, the assigner and packer,
the bank) is equal, bit for bit, and the bank's file members byte-equal.
"""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import detection_train as jcli
from cross_modal_video_engine_tpu.config import Config as JConfig
from cross_modal_video_engine_tpu.data import datasets_extra as jds
from cross_modal_video_engine_tpu.data import pipelines_extra as jpe
from cross_modal_video_engine_tpu.metrics import ava as jmet
from cross_modal_video_engine_tpu.models import ava_head as jah
from cross_modal_video_engine_tpu.models import lfb as jlfb
from cross_modal_video_engine_tpu.train import detection_trainer as jdt
from cross_modal_video_engine_tpu.train import recognition_trainer as jrt
from cross_modal_video_engine_tpu_torch.cli import detection_train as tcli
from cross_modal_video_engine_tpu_torch.config import Config
from cross_modal_video_engine_tpu_torch.convert import from_jax as cv
from cross_modal_video_engine_tpu_torch.data import datasets_extra as tds
from cross_modal_video_engine_tpu_torch.data.pipelines import build_pipeline
from cross_modal_video_engine_tpu_torch.metrics import ava as tmet
from cross_modal_video_engine_tpu_torch.models import ava_head as tah
from cross_modal_video_engine_tpu_torch.models import lfb as tlfb
from cross_modal_video_engine_tpu_torch.models.recognizer import (
    conv_init_state_dict)
from cross_modal_video_engine_tpu_torch.train import detection_trainer as tdt
from cross_modal_video_engine_tpu_torch.train import (
    recognition_trainer as trt)

from torch_parity import max_rel, random_variables, to_np

FWD_TOL, STEP_TOL = 1e-5, 1e-5
# the JAX RoIAlign compiled once per shape (eager, each call retraces)
JAX_ROI_ALIGN = jax.jit(jah.roi_align, static_argnums=(2, 3))
BACKBONE = dict(type="SlowOnly", stage_blocks=[1, 1, 1, 1], base_channels=8,
                conv1_kernel_t=1, stage_temporal_kernels=[1, 1, 3, 3],
                stage_spatial_strides=[1, 2, 2, 1])
HEAD = dict(num_classes=4, roi_size=2, sampling_ratio=1, dropout=0.5)
SHARED = {"plain": None,
          "acrn": dict(type="ACRN", out_channels=8),
          "fbo": dict(type="FBO", fbo_type="non_local", latent_channels=8,
                      num_non_local_layers=1)}
# rows (batch_idx, x1, y1, x2, y2): inside, across the border, outside the
# map, the whole frame, a degenerate box
ROIS = np.array([[0, .1, .1, .5, .6], [1, -.2, .3, .4, 1.3],
                 [1, 1.1, 1.2, 1.5, 1.4], [0, 0, 0, 1, 1],
                 [1, .3, .3, .3, .3], [0, .6, .2, .9, .9]], np.float32)
LT_ROWS = 6


@pytest.fixture(autouse=True)
def _torch_rng():
    with torch.random.fork_rng():
        yield


def _feats(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- RoIAlign -------------------------------------------------------------------

@pytest.mark.parametrize("out_size,ratio", [(2, 1), (8, 2), (3, 2)])
def test_roi_align_matches_jax(out_size, ratio):
    """Boxes inside, across and outside the map, and degenerate ones: the
    separable products against JAX's gather of four corners."""
    feat = _feats(1, 7, 9, 5)
    rng = np.random.default_rng(2)
    boxes = np.concatenate([rng.uniform(-3, 12, (20, 4)),
                            [[2, 2, 2, 2], [-5, -5, -1, -1],
                             [10, 8, 14, 12], [0, 0, 9, 7]]]).astype(
        np.float32)
    boxes[:20, 2:] = np.maximum(boxes[:20, 2:], boxes[:20, :2])
    want = np.asarray(JAX_ROI_ALIGN(jnp.asarray(feat), jnp.asarray(boxes),
                                    out_size, ratio))
    got = to_np(tah.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                              out_size, ratio))
    assert got.shape == want.shape == (24, out_size, out_size, 5)
    assert max_rel(got, want) <= FWD_TOL
    # the batched form picks each row's map
    maps = _feats(3, 2, 7, 9, 5)
    rois = ROIS.copy()
    per = [np.asarray(JAX_ROI_ALIGN(jnp.asarray(maps[int(r[0])]),
                                    jnp.asarray(r[None, 1:] * [9, 7, 9, 7]),
                                    out_size, ratio))[0] for r in rois]
    got = to_np(tah.roi_align_maps(torch.from_numpy(maps),
                                   torch.from_numpy(rois), out_size, ratio))
    assert max_rel(got, np.stack(per)) <= FWD_TOL


def test_bbox_loss_matches_jax():
    logits, labels = _feats(4, 6, 5), (_feats(5, 6, 5) > 0).astype(
        np.float32)
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for v in (valid, None):
        want = float(jah.ava_bbox_loss(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       None if v is None else jnp.asarray(v)))
        got = float(tah.ava_bbox_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      None if v is None else
                                      torch.from_numpy(v)))
        assert abs(got - want) <= 1e-6 * abs(want)


# -- the detectors through the converters, both ways ------------------------------

def _cfg(kind, **head):
    model = dict(backbone=BACKBONE, roi_head=dict(HEAD, **head))
    if SHARED[kind]:
        model["shared_head"] = SHARED[kind]
    return {"model": model}


def _pair(kind, seed=11, **head):
    """(JAX detector, its random variables, the port's detector loaded
    from them, clips, lt window or None)."""
    jm = jcli.build_detection_model(JConfig(_cfg(kind, **head)))
    tm = tcli.build_detection_model(Config(_cfg(kind, **head)), "cpu")
    clips = _feats(6, 2, 4, 32, 32, 3)
    lt = _feats(7, len(ROIS), LT_ROWS, 256) if kind == "fbo" else None
    v = random_variables(jax.tree.map(np.asarray, jm.init(
        jax.random.key(0), clips, ROIS, lt_feat=lt)), seed=seed)
    # running variances positive, near 1
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, x: 0.5 + np.abs(x) if path[-1].key == "var" else x,
        v["batch_stats"])
    tm.load_state_dict(cv.ava_detector_state_dict_from_jax(v, tm))
    return jm, v, tm, clips, lt


@pytest.mark.parametrize("kind", ["plain", "acrn", "fbo"])
def test_detector_matches_jax_both_ways(kind):
    jm, v, tm, clips, lt = _pair(kind)
    # the converter's tree is flax's: the shared head beside roi_head
    back = cv.ava_detector_variables_to_jax(tm.state_dict(), tm)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    top = set(v["params"])
    assert top == ({"backbone", "roi_head"} | ({"shared_head"}
                                                if kind != "plain" else set()))
    assert set(v["params"]["roi_head"]) == {"fc_cls"}
    if kind == "acrn":
        assert set(v["batch_stats"]["shared_head"]) == {"bn1", "bn2"}
    want = np.asarray(jm.apply(v, clips, ROIS, lt_feat=lt))
    tm.eval()
    with torch.no_grad():
        got = to_np(tm(torch.from_numpy(clips), torch.from_numpy(ROIS),
                       lt_feat=None if lt is None else torch.from_numpy(lt)))
    assert got.shape == want.shape == (len(ROIS), 4)
    assert max_rel(got, want) <= FWD_TOL
    # the st features the bank stores
    jfn = jdt.make_st_feature_fn(jm)
    want = np.asarray(jfn(v["params"], v["batch_stats"], clips, ROIS))
    got = to_np(tdt.make_st_feature_fn(tm)(clips, ROIS))
    assert max_rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("kind", ["plain", "acrn", "fbo"])
def test_training_init_has_flax_schemes(kind):
    """conv_init_state_dict covers every key: fc_cls normal(0.01), the
    FBO LayerNorms 1 and 0, BatchNorms 1, 0, 0, 1."""
    tm = tcli.build_detection_model(Config(_cfg(kind)), "cpu")
    sd = conv_init_state_dict(tm, 0)
    assert set(sd) == set(tm.state_dict())
    w = sd["roi_head.fc_cls.weight"]
    assert 0.005 < float(w.std()) < 0.02
    assert not sd["roi_head.fc_cls.bias"].any()
    if kind == "fbo":
        ln = "roi_head.shared_head.fbo.non_local_layer_1.ln"
        assert torch.equal(sd[ln + ".weight"], torch.ones(8))
        assert not sd[ln + ".bias"].any()
    if kind == "acrn":
        assert torch.equal(sd["roi_head.shared_head.bn1.running_var"],
                           torch.ones(8))


def _dropout_shapes(kind, n):
    c = 8
    head = (n, 256 + c) if kind == "fbo" else (n, 8 if kind == "acrn"
                                                 else 256)
    if kind == "fbo":
        return [(n, 1, c), (n, LT_ROWS, c), (n, 1, c), head]
    return [head]


@pytest.mark.parametrize("kind", ["plain", "acrn", "fbo"])
def test_train_step_matches_jax(kind, monkeypatch):
    """One SGD step (momentum, weight decay, the clip engaged) from the
    same state with the same masks: the loss, label_acc, every parameter
    and running statistic after it."""
    jm, v, tm, clips, lt = _pair(kind, seed=12)
    n = len(ROIS)
    rng = np.random.default_rng(13)
    labels = (rng.random((n, 4)) > 0.6).astype(np.float32)
    valid = np.array([1, 1, 1, 1, 0, 1], np.float32)
    masks = [rng.random(s) >= (0.5 if i == len(_dropout_shapes(kind, n)) - 1
                               else 0.2)
             for i, s in enumerate(_dropout_shapes(kind, n))]
    queue = list(masks)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None: jnp.asarray(
                            queue.pop(0)))
    tcfg = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9,
                weight_decay=1e-4, grad_clip=0.5)
    tx = jrt.make_rec_optimizer(jrt.RecognitionTrainConfig(**tcfg))
    jstate = jdt.DetTrainState(v["params"], tx.init(v["params"]), 0)
    jstep = jdt.make_det_train_step(jm, tx)
    jstate, jstats, jlogs = jstep(jstate, v["batch_stats"], clips, ROIS,
                                  labels, valid, jax.random.key(3), lt)
    assert not queue
    state = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig(**tcfg)))
    step = tdt.make_det_train_step(tm, device="cpu")
    _, logs = step(state, clips, ROIS, labels, valid, lt,
                   draws=[torch.from_numpy(m) for m in masks])
    for k in ("loss", "label_acc"):
        want = float(jlogs[k])
        assert abs(float(logs[k]) - want) <= 1e-5 * max(abs(want), 1e-3), k
    want = cv.ava_detector_state_dict_from_jax(
        jax.tree.map(np.asarray, {"params": jstate.params,
                                  "batch_stats": jstats}), tm)
    got = tm.state_dict()
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        assert max_rel(to_np(got[name]), w.numpy()) <= STEP_TOL, name


def test_handed_masks_are_counted():
    _, _, tm, clips, _ = _pair("plain")
    state = trt.init_rec_state(tm, trt.make_rec_optimizer(
        trt.RecognitionTrainConfig()))
    step = tdt.make_det_train_step(tm, device="cpu")
    n = len(ROIS)
    labels, valid = np.zeros((n, 4), np.float32), np.ones(n, np.float32)
    mask = np.ones((n, 256), bool)
    with pytest.raises(ValueError, match="more dropout masks"):
        step(state, clips, ROIS, labels, valid, draws=[mask, mask])
    with pytest.raises(ValueError, match="mask of"):
        step(state, clips, ROIS, labels, valid, draws=[mask[:, :3]])


# -- the bank -------------------------------------------------------------------------

def _builders(C=6, capacity=2):
    rows = [("v1", 900, np.ones((1, C))), ("v1", 901, 2 * np.ones((3, C))),
            ("v1", 901.5, _feats(20, 2, C)), ("v1", 905, 3 * np.ones((2, C))),
            ("v2", 900, 4 * np.ones((1, C))), ("v0", 3, _feats(21, 7, C))]
    j, t = jlfb.LFBBuilder(C, capacity), tlfb.LFBBuilder(C, capacity)
    for vid, ts, f in rows:
        j.add(vid, ts, f)
        t.add(vid, ts, f)
    return j, t


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_bank_build_window_and_files_match_jax(tmp_path):
    jb, tb = _builders()
    jbank, tbank = jb.build(seed=3), tb.build(seed=3, device="cpu")
    for k in ("features", "step_table", "start_sec", "counts"):
        np.testing.assert_array_equal(getattr(tbank, k).numpy(),
                                      np.asarray(getattr(jbank, k)))
    assert tbank.video_index == jbank.video_index
    vids = [jbank.video_index[v] for v in ("v1", "v1", "v2", "v0", "v1")]
    ts = [901, 899, 905, 4, 870]
    jsample = jax.jit(jbank.sample_batch, static_argnums=2)
    for w in (1, 4, 7):
        np.testing.assert_array_equal(
            tbank.sample_batch(vids, ts, w).numpy(),
            np.asarray(jsample(np.asarray(vids), np.asarray(ts), w)))
    np.testing.assert_array_equal(
        tbank.sample_window(0, 3, 4).numpy(),
        np.asarray(jbank.sample_window(0, 3, 4)))
    # the files: the same members, byte for byte, and each package loads
    # the other's
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jbank.save(jp)
    tbank.save(tp)
    assert _members(jp) == _members(tp)
    back = tlfb.LongTermFeatureBank.load(jp, device="cpu")
    jback = jlfb.LongTermFeatureBank.load(tp)
    assert back.video_index == jback.video_index == jbank.video_index
    np.testing.assert_array_equal(back.features.numpy(),
                                  np.asarray(jback.features))
    # sample_lt_features: known, unknown and padded keyframes
    lt = tdt.sample_lt_features(tbank, ["v1", "nope", "v2"], [901, 5, 900],
                                3, window_size=4, batch_size=5)
    want = jdt.sample_lt_features(jbank, ["v1", "nope", "v2"], [901, 5, 900],
                                  3, window_size=4, batch_size=5)
    assert lt.shape == (15, 8, 6)
    np.testing.assert_array_equal(lt.numpy(), want)


def test_build_lfb_matches_jax():
    """The bank-building pass over two batches with their meta."""
    jm, v, tm, clips, _ = _pair("plain")
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)
    rois = ROIS.copy()
    rois[:, 0] = np.repeat([0, 1], 3)
    batches = [dict(clips=clips, rois=rois, valid=valid,
                    video_id=["a", "b"], timestamp=[3, 7]),
               dict(clips=clips[::-1].copy(), rois=rois, valid=valid,
                    video_id=["a", "b"], timestamp=[4, 7])]
    jbank = jdt.build_lfb(jm, v["params"], v["batch_stats"], batches,
                          capacity=3, seed=1)
    tbank = tdt.build_lfb(tm, batches, capacity=3, seed=1)
    np.testing.assert_array_equal(tbank.step_table.numpy(),
                                  np.asarray(jbank.step_table))
    assert max_rel(tbank.features.numpy(),
                   np.asarray(jbank.features)) <= FWD_TOL


# -- proposals, packing and evaluation ---------------------------------------------

def test_assign_and_pack_match_jax():
    rng = np.random.default_rng(30)
    gt = np.array([[.1, .1, .5, .5], [.5, .5, .9, .9]], np.float32)
    gl = (rng.random((2, 5)) > 0.5).astype(np.float32)
    props = np.concatenate([gt + 0.005, rng.uniform(0, 1, (4, 4))]).astype(
        np.float32)
    cases = [(props, gt), (props[:0], gt), (props, gt[:0]),
             (props[:0], gt[:0])]
    items = []
    for p, g in cases:
        for add in (True, False):
            want = jdt.assign_proposals(p, g, gl[:len(g)], 5, 0.9, add)
            got = tdt.assign_proposals(p, g, gl[:len(g)], 5, 0.9, add)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        items.append(dict(clip=np.full((2, 4, 4, 3), len(items)),
                          boxes=got[0], labels=got[1]))
    for a, b in zip(tdt.pack_detection_batch(items, 3, 5),
                    jdt.pack_detection_batch(items, 3, 5)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdt._iou_xyxy(props, gt),
                                  jdt._iou_xyxy(props, gt))


def test_detection_results_match_jax():
    scores = np.random.default_rng(31).random((5, 4)).astype(np.float32)
    boxes = np.random.default_rng(32).random((5, 4)).astype(np.float32)
    for thr in (0.002, 0.5):
        for a, b in zip(tdt.detection_results(scores, boxes, 3, 4, thr),
                        jdt.detection_results(scores, boxes, 3, 4, thr)):
            np.testing.assert_array_equal(a, b)


# -- metrics -------------------------------------------------------------------------

def _ava_world(seed=40, n_keys=6, classes=(1, 2, 3, 5)):
    """Seeded GT and detections keyed by image: matches, near misses,
    duplicates, a class with no GT, a key with no GT."""
    rng = np.random.default_rng(seed)
    gt_b, gt_l, det_b, det_l, det_s = {}, {}, {}, {}, {}
    for k in range(n_keys):
        key = jmet.make_image_key(f"vid{k % 2}", 900 + k)
        g = rng.uniform(0, 0.5, (3, 2))
        boxes = np.concatenate([g, g + rng.uniform(0.2, 0.5, (3, 2))], 1)
        if k != 5:
            gt_b[key] = boxes[:, [1, 0, 3, 2]].tolist()
            gt_l[key] = [int(c) for c in rng.choice(classes[:3], 3)]
        d = np.concatenate([boxes, boxes + rng.normal(0, 0.05, boxes.shape),
                            rng.uniform(0, 1, (2, 4))])
        det_b[key] = d[:, [1, 0, 3, 2]].tolist()
        det_l[key] = [int(c) for c in rng.choice(classes, len(d))]
        det_s[key] = rng.random(len(d)).round(3).tolist()
    return gt_b, gt_l, det_b, det_l, det_s


def test_frame_map_matches_jax():
    world = _ava_world()
    cats = [{"id": 1, "name": "a"}, {"id": 3, "name": "c"}]
    for thr in (0.5, 0.3):
        want = jmet.ava_frame_map(*world, class_ids=range(1, 6),
                                  iou_thr=thr, categories=cats)
        got = tmet.ava_frame_map(*world, class_ids=range(1, 6),
                                 iou_thr=thr, categories=cats)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k] or (np.isnan(got[k])
                                         and np.isnan(want[k])), k
    p, r = np.array([1., .5, .67, .5]), np.array([.25, .25, .5, .5])
    assert tmet._voc_average_precision(p, r) == \
        jmet._voc_average_precision(p, r)
    d = np.array(world[2]["vid0,0900"])
    g = np.array(world[0]["vid0,0900"])
    np.testing.assert_array_equal(tmet._tp_fp_single(d, g, 0.5),
                                  jmet._tp_fp_single(d, g, 0.5))


def _ava_files(tmp_path):
    """An annotation csv, a label map, exclusions and seeded per-class
    results for the keyframes of the annotation."""
    ann = tmp_path / "ann.csv"
    rows = []
    for k in range(4):
        for e in range(2):
            for c in (1 + (k + e) % 3, 4):
                rows.append(f"v{k % 2},{900 + k},{0.1 + 0.2 * e:.3f},0.100,"
                            f"{0.4 + 0.2 * e:.3f},0.800,{c},{e}")
    rows.append("v1,0903,0.000,0.000,1.000,1.000,2")
    ann.write_text("\n".join(rows) + "\n")
    labels = tmp_path / "labels.pbtxt"
    labels.write_text("".join(f'item {{\n  name: "act{i}"\n  id: {i}\n}}\n'
                              for i in (1, 2, 3, 4)))
    excl = tmp_path / "excl.csv"
    excl.write_text("v1,0903\n")
    return str(ann), str(labels), str(excl)


def test_results_csv_bytes_and_ava_eval_match_jax(tmp_path):
    ann, labels, excl = _ava_files(tmp_path)
    jd, td = jds.AVADataset(ann, 5), tds.AVADataset(ann, 5)
    rng = np.random.default_rng(41)
    results = [[np.zeros((0, 5)) if c == 1 else rng.random((2, 5))
                for c in range(4)] for _ in range(len(jd))]
    jp, tp = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jmet.results2csv(jd, results, jp)
    tmet.results2csv(td, results, tp)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    custom = [0, 1, 2, 4]
    jmet.results2csv(jd, [r[:3] for r in results], jp, custom)
    tmet.results2csv(td, [r[:3] for r in results], tp, custom)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    assert tmet.det2csv(td, results) == jmet.det2csv(jd, results)
    for ex in (None, excl):
        for cc in (None, [0, 1, 2, 4]):
            want = jmet.ava_eval(tp, "mAP", labels, ann, ex, verbose=False,
                                 custom_classes=cc)
            got = tmet.ava_eval(tp, "mAP", labels, ann, ex, verbose=False,
                                custom_classes=cc)
            assert got == want or all(
                np.isnan(got[k]) and np.isnan(want[k]) for k in want)
    with open(labels) as f:
        want = jmet.read_labelmap(f)
    with open(labels) as f:
        assert tmet.read_labelmap(f) == want
    with open(excl) as f:
        assert tmet.read_exclusions(io.StringIO(f.read())) == \
            jmet.read_exclusions(open(excl))
    with open(ann) as f:
        a = f.read()
    assert tmet.read_csv(io.StringIO(a), {1, 2}) == \
        jmet.read_csv(io.StringIO(a), {1, 2})


# -- the dataset and SampleAVAFrames ---------------------------------------------------

def test_ava_dataset_matches_jax(tmp_path):
    ann, _, _ = _ava_files(tmp_path)
    for prefix in (None, "videos"):
        j, t = jds.AVADataset(ann, 5, prefix), tds.AVADataset(ann, 5, prefix)
        assert len(t) == len(j) == 4
        for i in range(len(j)):
            a, b = t[i], j[i]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("interval", [2, 3, 16])
def test_sample_ava_frames_matches_jax(test_mode, interval):
    """Train-mode jitter ((-fi) // 2 to (fi + 1) // 2, the op's seeded
    generator) and test-mode centres, clamped to the shot, over five
    calls of one op."""
    op = dict(type="SampleAVAFrames", clip_len=4, frame_interval=interval,
              test_mode=test_mode, seed=5)
    t = build_pipeline([op])
    j = jpe.SampleAVAFrames(**{k: v for k, v in op.items() if k != "type"})
    for i, ts in enumerate([0.2, 1.0, 2.7, 0.0, 3.3]):
        res = dict(fps=30, timestamp=ts, timestamp_start=0, start_index=i % 2,
                   total_frames=90, shot_info=(0, 90) if i % 3 else None)
        got, want = t(dict(res)), j(dict(res))
        np.testing.assert_array_equal(got["frame_inds"], want["frame_inds"])
        assert got["frame_inds"].dtype == want["frame_inds"].dtype
        np.testing.assert_array_equal(got["crop_quadruple"],
                                      want["crop_quadruple"])
        for k in ("clip_len", "frame_interval", "num_clips"):
            assert got[k] == want[k]

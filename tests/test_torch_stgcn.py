"""The port's skeleton models, pose ops and PoseDataset against the JAX
package's, on the CPU at a small size (channels (8, 16, 16), strides (1,
2, 1), 12 frames, two clips of two persons, COCO-17 and NTU-25 graphs).

One state dict drawn from a numpy seed (edge masks and PA drawn near 1 so
their orientation shows) loads into the port as it is and into the JAX
package through convert_stgcn and convert_agcn, which are the parity
bridge; the port's converters give the importers' trees bit for bit and
invert them exactly.

* Forward in eval and train mode, one and two persons: scores within
  1e-5 of the largest (f32); each running statistic after a train-mode
  forward within 1e-5 of its tensor's largest magnitude.
* One step's loss within 1e-5 relative and each gradient within 1e-4 of
  its tensor's largest (f32; train-mode BatchNorm's backward cancels
  more than the forward).
* `build_partitioned_adjacency` bit-equal to JAX for both layouts; the
  training init's constant entries; PoseC3D's 17-channel stem against
  the JAX ResNet3D on heatmaps.
* Every pose op and PoseDataset bit-equal to JAX on seeded inputs,
  UniformSampleFrames in test mode and with its train-mode draws handed
  to both (the op's `rng`), GeneratePoseTarget with and without limbs,
  several persons, and the flipped double.

Every torch draw happens under torch.random.fork_rng()
(tests/test_stgcn_conversion.py draws from the global RNG).
"""

import copy
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cross_modal_video_engine_tpu.convert import torch_import as ti
from cross_modal_video_engine_tpu.data import datasets_extra as jds
from cross_modal_video_engine_tpu.data import pipelines_extra as jpe
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import resnet3d as jr
from cross_modal_video_engine_tpu.models import stgcn as js
from cross_modal_video_engine_tpu_torch import convert as tconv
from cross_modal_video_engine_tpu_torch.data import datasets_extra as tds
from cross_modal_video_engine_tpu_torch.data import pipelines_extra as tpe
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import resnet3d as tr
from cross_modal_video_engine_tpu_torch.models import stgcn as ts
from torch_parity import max_rel

FWD_TOL = 1e-5               # of the largest score, f32
STATS_TOL = 1e-5             # of each statistic's largest magnitude
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4              # of each gradient's largest magnitude
# biases whose gradient is zero by structure (a train-mode BatchNorm right
# after them, or AGCN's conv_a bias, constant over the softmax's axis):
# rounding noise in either package, held to GRAD_TOL of the largest
# gradient of the model
ZERO_BY_STRUCTURE = re.compile(
    r"(st_gcn_networks\.\d+\.(tcn\.2|residual\.0)|agcn_networks\.\d+\."
    r"(gcn\.conv_[ad]\.\d|gcn\.down\.0|tcn\.0|residual\.0))\.bias$")
CLASSES = 5
SMALL = dict(channels=(8, 16, 16), temporal_strides=(1, 2, 1))
LAYOUTS = {"coco": 17, "ntu-rgb+d": 25}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Every float entry redrawn from a numpy seed (the graph buffer
    kept): convs at lecun-normal scale, BatchNorm scales, edge masks and
    PA near 1, biases and means small, variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point() or k.endswith(".A") or k == "A":
            out[k] = v.clone()
            continue
        shape, leaf = tuple(v.shape), k.rsplit(".", 1)[1]
        if leaf == "running_var":
            a = 0.5 + rng.random(shape)
        elif leaf in ("running_mean", "bias"):
            a = 0.05 * rng.standard_normal(shape)
        elif v.dim() == 1 or "edge_importance" in k or leaf == "PA":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = int(np.prod(shape[1:])) ** -0.5 * rng.standard_normal(shape)
        out[k] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def skeleton_pair(fam: str, layout: str = "coco", seed: int = 3,
                  dropout: float = 0.0):
    """(port SkeletonClassifier loaded with a seeded state dict, its state
    dict, the JAX SkeletonClassifier, its variables through the
    importer)."""
    cfg = getattr(ts, f"{fam}Config")(num_joints=LAYOUTS[layout],
                                      layout=layout, **SMALL)
    tm = ts.SkeletonClassifier(getattr(ts, fam)(cfg, device="cpu"), CLASSES,
                               dropout_ratio=dropout)
    sd = seeded_state_dict(tm, seed)
    tm.load_state_dict(sd)
    importer = ti.convert_stgcn if fam == "STGCN" else ti.convert_agcn
    variables, jcfg = importer(dict(sd))
    jm = js.SkeletonClassifier(getattr(js, fam)(jcfg), CLASSES)
    return tm, sd, jm, variables


def keypoints(shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{pre}/{k}"))
        else:
            out[f"{pre}/{k}"] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    a, b = flat(got), flat(want)
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


# -- the graph -------------------------------------------------------------------

@pytest.mark.parametrize("layout", [None, "coco", "ntu-rgb+d"])
def test_adjacency_is_bit_equal(layout):
    got = ts.build_partitioned_adjacency(layout=layout)
    want = js.build_partitioned_adjacency(layout=layout)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert ts.COCO_EDGES == js.COCO_EDGES and ts.NTU_EDGES == js.NTU_EDGES
    assert ts.GRAPH_LAYOUTS == js.GRAPH_LAYOUTS


# -- weights both ways -------------------------------------------------------------

@pytest.mark.parametrize("fam", ["STGCN", "AGCN"])
def test_converters_match_the_importers(fam):
    tm, sd, _, variables = skeleton_pair(fam)
    assert_trees_equal(tconv.conv_recognizer_variables_to_jax(sd, tm),
                       variables)
    back = tconv.conv_recognizer_state_dict_from_jax(variables, tm)
    assert set(back) | {"backbone.A"} == set(sd)
    assert all(torch.equal(v, sd[k]) for k, v in back.items())
    # the backbone alone, through the per-family forms
    bb_sd = {k[len("backbone."):]: v for k, v in sd.items()
             if k.startswith("backbone.")}
    fn = fam.lower()
    to_jax = getattr(tconv, f"{fn}_variables_to_jax")(bb_sd, tm.backbone.cfg)
    importer = ti.convert_stgcn if fam == "STGCN" else ti.convert_agcn
    want, _ = importer({"backbone." + k: v for k, v in bb_sd.items()})
    assert_trees_equal(to_jax, want)
    back = getattr(tconv, f"{fn}_state_dict_from_jax")(want, tm.backbone.cfg)
    assert all(torch.equal(v, bb_sd[k]) for k, v in back.items())


@pytest.mark.parametrize("fam", ["STGCN", "AGCN"])
def test_checkpoint_graph_builds_the_same_model(fam):
    """A config carrying the importer's adjacency (the converted
    checkpoint's config) builds the same graph buffer as the layout."""
    tm, sd, _, variables = skeleton_pair(fam, "ntu-rgb+d")
    importer = ti.convert_stgcn if fam == "STGCN" else ti.convert_agcn
    _, jcfg = importer(dict(sd))
    cfg = getattr(ts, f"{fam}Config")(
        num_joints=jcfg.num_joints, in_channels=jcfg.in_channels,
        channels=jcfg.channels, temporal_strides=jcfg.temporal_strides,
        adjacency=jcfg.adjacency)
    assert torch.equal(getattr(ts, fam)(cfg, device="cpu").A,
                       tm.backbone.A)


# -- forward ---------------------------------------------------------------------

@pytest.mark.parametrize("persons", [1, 2])
@pytest.mark.parametrize("fam,layout", [("STGCN", "coco"),
                                        ("AGCN", "ntu-rgb+d")])
def test_eval_and_train_forward_match_jax(fam, layout, persons):
    tm, _, jm, variables = skeleton_pair(fam, layout)
    V = LAYOUTS[layout]
    shape = (2, 12, V, 3) if persons == 1 else (2, persons, 12, V, 3)
    x = keypoints(shape)
    if persons == 1:       # the JAX BackboneClassifier takes one person
        jm = jrec.BackboneClassifier(jm.backbone, CLASSES, dropout_ratio=0.0)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert max_rel(got, np.asarray(want)) <= FWD_TOL
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want, upd = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    assert max_rel(got, np.asarray(want)) <= FWD_TOL
    stats = tconv.conv_batch_stats_from_jax(
        jax.tree.map(np.asarray, upd["batch_stats"]), tm)
    mine = tm.state_dict()
    for k, v in stats.items():
        if "running" in k:
            assert max_rel(mine[k].numpy(), v.numpy()) <= STATS_TOL, k


@pytest.mark.parametrize("fam", ["STGCN", "AGCN"])
def test_step_loss_and_gradients_match_jax(fam):
    tm, _, jm, variables = skeleton_pair(fam)
    x = keypoints((4, 2, 12, 17, 3), seed=2)
    labels = np.array([0, 3, 1, 3])

    def jloss(params):
        scores, upd = jm.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        logp = jax.nn.log_softmax(scores)
        return -jnp.mean(logp[jnp.arange(4), labels])

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        variables["params"])
    tm.train()
    loss = F.cross_entropy(tm(torch.from_numpy(x)),
                           torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * float(want_loss)
    want = tconv.conv_recognizer_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, want_grads)}, tm)
    largest = max(float(g.abs().max()) for g in want.values())
    for name, p in tm.named_parameters():
        if ZERO_BY_STRUCTURE.search(name):
            err = float((p.grad - want[name]).abs().max())
            assert err <= GRAD_TOL * largest, name
        else:
            assert max_rel(p.grad.numpy(), want[name].numpy()) <= GRAD_TOL, \
                name


def test_training_init_constants():
    for fam in ("STGCN", "AGCN"):
        cfg = getattr(ts, f"{fam}Config")(**SMALL)
        tm = ts.SkeletonClassifier(getattr(ts, fam)(cfg, device="cpu"), 4)
        sd = trec.conv_init_state_dict(tm, 0)
        tm.load_state_dict(sd)
        assert torch.equal(sd["backbone.A"], torch.from_numpy(
            np.swapaxes(js.build_partitioned_adjacency(), 1, 2).copy()
            if fam == "STGCN" else js.build_partitioned_adjacency()))
        for k, v in sd.items():
            if "edge_importance" in k:
                assert bool((v == 1).all()), k
            if k.endswith("gcn.PA") or k.endswith("gcn.bn.weight"):
                assert bool((v == np.float32(1e-6)).all()), k
        std = float(sd["cls_head.fc.weight"].std())
        assert 0.005 < std < 0.02


def test_posec3d_stem_takes_heatmap_channels():
    cfg = dict(stage_blocks=(1, 1), base_channels=8, conv1_kernel_t=1,
               stage_temporal_kernels=(1, 3), stage_spatial_strides=(1, 2))
    tm = tr.ResNet3D(tr.ResNet3DConfig(**cfg), device="cpu", in_channels=17)
    assert tm.conv1.conv.weight.shape[1] == 17
    rng = np.random.default_rng(5)
    sd = {k: (torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32) * (0.1 if v.dim() > 1 else 1.0)) if k.endswith("weight")
        else v.clone()) for k, v in tm.state_dict().items()}
    tm.load_state_dict(sd)
    variables = ti.convert_resnet3d({"backbone." + k: v
                                     for k, v in sd.items()},
                                    jr.ResNet3DConfig(**cfg))
    x = np.random.default_rng(6).random((2, 4, 16, 16, 17)).astype(
        np.float32)
    want = jr.ResNet3D(jr.ResNet3DConfig(**cfg)).apply(variables,
                                                       jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert max_rel(got, np.asarray(want)) <= FWD_TOL
    back = tconv.resnet3d_state_dict_from_jax(variables,
                                              tr.ResNet3DConfig(**cfg))
    assert torch.equal(back["conv1.conv.weight"], sd["conv1.conv.weight"])


# -- the pose ops and PoseDataset ----------------------------------------------------

def assert_results_equal(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, k
            assert np.array_equal(a, b, equal_nan=True), k
        elif isinstance(b, dict):
            assert_results_equal(a, b)
        else:
            assert type(a) is type(b) and a == b, k


def both(op_name, results, **kw):
    """The op of each package on its own deep copy of `results`."""
    got = getattr(tpe, op_name)(**kw)(copy.deepcopy(results))
    want = getattr(jpe, op_name)(**kw)(copy.deepcopy(results))
    assert_results_equal(got, want)
    return got


@pytest.mark.parametrize("total", [5, 30, 90])
@pytest.mark.parametrize("num_clips", [1, 3])
def test_uniform_sample_frames(total, num_clips):
    both("UniformSampleFrames", {"total_frames": total, "start_index": 1},
         clip_len=24, num_clips=num_clips, test_mode=True)
    if num_clips == 1:                   # train mode, the draws handed in
        ops = [mod.UniformSampleFrames(clip_len=24) for mod in (tpe, jpe)]
        for op in ops:
            op.rng = np.random.default_rng(7)
        got, want = (op({"total_frames": total}) for op in ops)
        assert_results_equal(got, want)


def pose_results(M=3, T=20, V=17, seed=8):
    rng = np.random.default_rng(seed)
    kp = (rng.random((M, T, V, 2)) * [60, 40] + [10, 5]).astype(np.float32)
    kp[0, 2, 3] = 0.0                   # a missing joint
    score = rng.random((M, T, V)).astype(np.float32)
    return {"keypoint": kp, "keypoint_score": score, "total_frames": T,
            "img_shape": (64, 80)}


def test_pose_ops_chain():
    r = pose_results()
    r = both("PaddingWithLoop", r, clip_len=28)
    r = both("PoseDecode", r)
    both("PoseDecode", dict(r, frame_inds=np.array([[3]]), offset=1))
    both("PoseNormalize", r)
    for kw in (dict(), dict(hw_ratio=1.0, allow_imgpad=False),
               dict(padding=0.5, threshold=100)):
        both("PoseCompact", dict(r, crop_quadruple=(0.1, 0.2, 0.5, 0.5)),
             **kw)
    for dataset, V in (("coco", 17), ("openpose-18", 18)):
        p = pose_results(V=V)
        both("JointToBone", dict(p, keypoint=np.concatenate(
            [p["keypoint"], p["keypoint_score"][..., None]], -1)),
            dataset=dataset)
    both("JointToBone", pose_results(V=25))
    for persons in (2, 5):
        both("FormatGCNInput", r, num_person=persons)


@pytest.mark.parametrize("kw", [dict(), dict(with_limb=True),
                                dict(with_kp=False, with_limb=True,
                                     use_score=False),
                                dict(double=True, sigma=1.2)])
def test_generate_pose_target(kw):
    r = pose_results(M=3, T=4, seed=9)
    r["keypoint"] = r["keypoint"] * 0.5         # on a 32x40 canvas
    r["img_shape"] = (32, 40)
    r["keypoint"][1, 0, 4] = r["keypoint"][1, 0, 5]   # a limb shorter than 1
    r["keypoint_score"][2, 1] = 0.0                     # an absent person
    got = both("GeneratePoseTarget", r, **kw)
    k = (17 if kw.get("with_kp", True) else 0) + (
        17 if kw.get("with_limb") else 0)
    assert got["imgs"].shape == ((8 if kw.get("double") else 4), 32, 40, k)
    assert got["imgs"].max() > 0.5


def test_load_kinetics_pose(tmp_path):
    rng = np.random.default_rng(10)
    frame_inds = np.array([0, 0, 0, 2, 2, 5, 5, 5, 5])
    kps = rng.random((len(frame_inds), 17, 3)).astype(np.float32) * 50
    path = tmp_path / "kp.pkl"
    with open(path, "wb") as f:
        pickle.dump(kps, f)
    base = {"filename": str(path), "frame_inds": frame_inds,
            "total_frames": 9, "img_shape": (60, 80), "box_score": 1.0}
    for kw in (dict(), dict(max_person=2), dict(squeeze=False,
                                                max_person=3)):
        both("LoadKineticsPose", base, **kw)
    both("LoadKineticsPose", dict(base, anno_inds=np.array([0, 3, 5, 6])),
         max_person=1)


def test_pose_dataset(tmp_path):
    rng = np.random.default_rng(11)
    annos = [{"keypoint": rng.random((1, 6, 17, 3)).astype(np.float32),
              "label": 0, "img_shape": (480, 640)},
             {"keypoint": rng.random((3, 30, 17, 3)).astype(np.float32),
              "label": 1},
             {"keypoint": rng.random((9, 17, 3)).astype(np.float32),
              "label": 2}]
    path = tmp_path / "p.pkl"
    with open(path, "wb") as f:
        pickle.dump(annos, f)
    for persons in (1, 2):
        t = tds.PoseDataset(str(path), clip_len=8, num_persons=persons)
        j = jds.PoseDataset(str(path), clip_len=8, num_persons=persons)
        assert len(t) == len(j)
        for i in range(len(j)):
            (a, la), (b, lb) = t[i], j[i]
            assert la == lb and a.dtype == b.dtype and np.array_equal(a, b)
            assert t.src_shape(i) == j.src_shape(i)
        for (a, la, na), (b, lb, nb) in zip(t.batches(2), j.batches(2)):
            assert na == nb and np.array_equal(a, b)
            assert np.array_equal(la, lb) and la.dtype == lb.dtype

"""The port's explain stack (explain/*.py, convert's ResidualHead pair)
against the JAX package's, on the CPU at a small size (4 frames of 16²,
patch 8, width 32, 2 heads, 3 layers, 6 classes, f32): random JAX
variables go through convert/from_jax.py into the port, and the same
numpy inputs go through both.  The joint model's attention runs the JAX
flash kernel in interpret mode and the port's plain version; the divided
model runs no kernel.

Tolerances: scores and captured tokens within 1e-5; gradients within
1e-4 of their largest magnitude; `grad_extract` also against a central
finite difference (as tests/test_explain.py checks the JAX one); the
numpy modules (CTV levels, TCAV, robustness, GradCAM, masking, probing)
equal to the JAX package's outputs on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu import explain as jexplain
from cross_modal_video_engine_tpu.explain import cbm as jcbm
from cross_modal_video_engine_tpu.explain import ctv as jctv
from cross_modal_video_engine_tpu.explain import gradcam as jgradcam
from cross_modal_video_engine_tpu.explain import grads as jgrads
from cross_modal_video_engine_tpu.explain import interventions as jint
from cross_modal_video_engine_tpu.explain import masking as jmask
from cross_modal_video_engine_tpu.explain import model_layers as jlayers
from cross_modal_video_engine_tpu.explain import pipeline as jpipe
from cross_modal_video_engine_tpu.explain import probing as jprobe
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu_torch import explain as texplain
from cross_modal_video_engine_tpu_torch.convert import (
    recognizer_state_dict_from_jax, residual_head_state_dict_from_jax,
    residual_head_variables_to_jax)
from cross_modal_video_engine_tpu_torch.explain import cbm as tcbm
from cross_modal_video_engine_tpu_torch.explain import ctv as tctv
from cross_modal_video_engine_tpu_torch.explain import gradcam as tgradcam
from cross_modal_video_engine_tpu_torch.explain import grads as tgrads
from cross_modal_video_engine_tpu_torch.explain import interventions as tint
from cross_modal_video_engine_tpu_torch.explain import masking as tmask
from cross_modal_video_engine_tpu_torch.explain import model_layers as tlayers
from cross_modal_video_engine_tpu_torch.explain import pipeline as tpipe
from cross_modal_video_engine_tpu_torch.explain import probing as tprobe
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from torch_parity import interpret_pallas, random_variables

SMALL = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
             num_heads=2, num_layers=3, drop_path_max=0.0)
BACKBONES = {
    "joint+flash": dict(SMALL, attention_type="joint_space_time",
                        use_flash_attention=True),
    "divided": dict(SMALL, attention_type="divided_space_time"),
}
CLASSES = 6
TOL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _interpret():
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    """One torch thread (the lane runs several xdist workers), and torch's
    global RNG and thread count left as found."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _videos(n, seed=13):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 4, 16, 16, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def pair(request):
    """(JAX Recognizer3D, its random variables, the port's model of the
    same weights)."""
    backbone = BACKBONES[request.param]
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**backbone),
                           num_classes=CLASSES)
    variables = random_variables(
        jm.init(jax.random.key(0), jnp.asarray(_videos(2))), 23)
    tm = trec.Recognizer3D(tts.TimeSformerConfig(**backbone),
                           num_classes=CLASSES, device="cpu")
    tm.load_state_dict(recognizer_state_dict_from_jax(
        variables, tm.backbone.cfg))
    return jm, variables, tm.requires_grad_(False)


def _close_grads(got, want):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * scale)


# -- gradients ---------------------------------------------------------------

@pytest.mark.parametrize("layers,target_class", [((0,), None), ((1,), 3),
                                                 ((0, 1), None)])
def test_grad_extract_matches_jax(pair, layers, target_class):
    jm, variables, tm = pair
    v = _videos(3)
    want = jgrads.grad_extract(jm, variables, jnp.asarray(v), layers,
                               target_class=target_class, jit=False)
    got = tgrads.grad_extract(tm, torch.from_numpy(v), layers,
                              target_class=target_class)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    assert sorted(got["activations"]) == sorted(got["gradients"]) == sorted(
        layers)
    for layer in layers:
        np.testing.assert_allclose(got["activations"][layer],
                                   want["activations"][layer], rtol=0,
                                   atol=TOL)
        assert got["gradients"][layer].dtype == np.float32
        _close_grads(got["gradients"][layer], want["gradients"][layer])


def test_grad_extract_matches_finite_difference(pair):
    _, _, tm = pair
    v = torch.from_numpy(_videos(2))
    out = tgrads.grad_extract(tm, v, [1])
    act, g, cls = out["activations"][1], out["gradients"][1], out["pred"]
    eps = 1e-3
    for b, t, d in ((0, 0, 0), (1, 5, 7), (0, 16, 31)):
        s = []
        for sign in (1, -1):
            a = act.copy()
            a[b, t, d] += sign * eps
            with torch.no_grad():
                s.append(tm.score_from_layer(torch.from_numpy(a), 1)
                         [b, cls[b]].item())
        fd = (s[0] - s[1]) / (2 * eps)
        np.testing.assert_allclose(g[b, t, d], fd, rtol=5e-2, atol=1e-3)


def test_grad_extract_targets_the_capture_forwards_class(pair, monkeypatch):
    """The class comes from the capture forward's scores, not from the
    recomputation's: a recomputation that negates the scores changes
    the argmax but not the class, and the gradient is the negated one."""
    _, _, tm = pair
    v = torch.from_numpy(_videos(3))
    plain = tgrads.grad_extract(tm, v, [1])
    orig = tm.score_from_layer
    monkeypatch.setattr(tm, "score_from_layer",
                        lambda tokens, layer: -orig(tokens, layer))
    flipped = tgrads.grad_extract(tm, v, [1])
    with torch.no_grad():
        want = tm(v).argmax(-1).numpy()
    np.testing.assert_array_equal(flipped["pred"], want)
    np.testing.assert_array_equal(plain["pred"], want)
    np.testing.assert_allclose(flipped["gradients"][1],
                               -plain["gradients"][1], rtol=0, atol=1e-7)


def test_grad_extract_ignores_the_callers_grad_mode(pair):
    """Under the caller's no_grad the gradient is still taken; frozen
    parameters get none."""
    _, _, tm = pair
    v = torch.from_numpy(_videos(2))
    want = tgrads.grad_extract(tm, v, [0])
    with torch.no_grad():
        got = tgrads.grad_extract(tm, v, [0])
    np.testing.assert_array_equal(got["gradients"][0], want["gradients"][0])
    assert all(p.grad is None and not p.requires_grad
               for p in tm.parameters())


def test_bf16_model_gives_f32_gradients(pair):
    """forward_from casts the fp32 tokens to bf16: the gradient flows back
    through the cast and comes back in fp32, near the f32 model's."""
    _, _, tm = pair
    bf = trec.Recognizer3D(
        tts.TimeSformerConfig(**{**vars(tm.backbone.cfg),
                                 "dtype": "bfloat16"}),
        num_classes=CLASSES, device="cpu")
    bf.load_state_dict({k: v.to(torch.bfloat16) if v.dtype.is_floating_point
                        and k.startswith("backbone.") else v
                        for k, v in tm.state_dict().items()})
    v = torch.from_numpy(_videos(2))
    got = tgrads.grad_extract(bf.requires_grad_(False), v, [1],
                              target_class=2)
    want = tgrads.grad_extract(tm, v, [1], target_class=2)
    g, w = got["gradients"][1], want["gradients"][1]
    assert g.dtype == np.float32 and got["activations"][1].dtype == np.float32
    cos = float((g * w).sum() / np.linalg.norm(g) / np.linalg.norm(w))
    assert cos > 0.99


def test_normalized_cls_grad_matches_jax():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((3, 9, 8)).astype(np.float32)
    np.testing.assert_array_equal(tgrads.normalized_cls_grad(g),
                                  jgrads.normalized_cls_grad(g))
    zero = np.zeros((2, 4, 8), np.float32)
    np.testing.assert_array_equal(tgrads.normalized_cls_grad(zero), zero[0, 0])


# -- interventions -------------------------------------------------------------

@pytest.mark.parametrize("indices", [[1, 3, -1], [], [0]])
def test_zero_out_tokens_matches_jax(pair, indices):
    jm, variables, tm = pair
    v = _videos(2)
    want = jint.zero_out_tokens(jm, variables, jnp.asarray(v), 1, indices)
    got = tint.zero_out_tokens(tm, torch.from_numpy(v), 1, indices)
    assert sorted(got) == sorted(want)
    for key in ("scores", "scores_zeroed", "delta"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=TOL)
    for key in ("pred", "pred_zeroed"):
        np.testing.assert_array_equal(got[key], want[key])
    if not indices:
        np.testing.assert_array_equal(got["delta"], 0)


def test_zero_out_tokens_leaves_the_captured_tokens(pair, monkeypatch):
    """The zeroed tokens are a copy: the captured tensor keeps its
    values."""
    _, _, tm = pair
    seen = []
    orig = tm.forward_with_capture

    def keep(videos, layers):
        scores, cap = orig(videos, layers)
        seen.append((cap, {k: t.clone() for k, t in cap.items()}))
        return scores, cap

    monkeypatch.setattr(tm, "forward_with_capture", keep)
    tint.zero_out_tokens(tm, torch.from_numpy(_videos(2)), 1, [0, 2])
    (cap, before), = seen
    assert torch.equal(cap[1], before[1]) and cap[1][:, 0].abs().sum() > 0


def test_temporal_shuffle_contrast_matches_jax(pair):
    jm, variables, tm = pair
    frames = _videos(1)[0]

    def jembed(stack):
        _, cap = jm.apply(variables, jnp.asarray(stack), (2,),
                          method="forward_with_capture")
        return np.asarray(cap[2][:, 0])

    def tembed(stack):            # a tensor: the port takes it as is
        with torch.no_grad():
            _, cap = tm.forward_with_capture(torch.from_numpy(stack), (2,))
        return cap[2][:, 0]

    want = jint.temporal_shuffle_contrast(jembed, frames, 5, seed=4)
    got = tint.temporal_shuffle_contrast(tembed, frames, 5, seed=4)
    assert sorted(got) == sorted(want)
    for g, w in zip(got["perms"], want["perms"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got["similarities"], want["similarities"],
                               rtol=0, atol=TOL)
    for key in ("mean_similarity", "temporal_sensitivity"):
        assert abs(got[key] - want[key]) <= TOL


# -- concept vectors and their statistics --------------------------------------

def _instances(seed=41, d=8):
    rng = np.random.default_rng(seed)
    return {"dog": [rng.standard_normal(d) + 5 for _ in range(4)],
            "cat": [rng.standard_normal(d) - 5 for _ in range(5)],
            "car": [rng.standard_normal(d)],
            "cup": [rng.standard_normal(d) for _ in range(2)]}


def test_build_instance_ctvs_matches_jax(pair):
    jm, variables, tm = pair
    raw = _videos(1)[0]
    masked = {"dog": raw * 0.5, "cat": raw * 0.0, "car": raw[::-1].copy()}
    calls = []

    def jembed(stack):
        _, cap = jm.apply(variables, jnp.asarray(stack), (2,),
                          method="forward_with_capture")
        return np.asarray(cap[2][:, 0])

    def tembed(stack):
        calls.append(len(stack))
        with torch.no_grad():
            _, cap = tm.forward_with_capture(torch.from_numpy(stack), (2,))
        return cap[2][:, 0].numpy()

    want = jctv.build_instance_ctvs(jembed, raw, masked)
    got = tctv.build_instance_ctvs(tembed, raw, masked)
    assert calls == [4] and sorted(got) == sorted(want) == sorted(masked)
    for name in masked:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=TOL)


@pytest.mark.parametrize("n_clusters", [1, 2, 3])
def test_concept_levels_match_jax(n_clusters):
    inst = _instances()
    for fn in ("symbolic_concept_vectors",):
        (gm, gn), (wm, wn) = (getattr(tctv, fn)(inst),
                              getattr(jctv, fn)(inst))
        assert gn == wn and gm.dtype == np.float32
        np.testing.assert_array_equal(gm, wm)
    gm, gn = tctv.cluster_concept_vectors(inst, n_clusters, seed=5)
    wm, wn = jctv.cluster_concept_vectors(inst, n_clusters, seed=5)
    assert gn == wn and gm.dtype == np.float32
    np.testing.assert_array_equal(gm, wm)


def test_concept_scores_top_tcav_robustness_match_jax():
    rng = np.random.default_rng(8)
    mat = rng.standard_normal((7, 8)).astype(np.float32)
    grad = rng.standard_normal(8).astype(np.float32)
    names = [f"c{i}" for i in range(7)]
    s = tctv.concept_scores(mat, grad)
    np.testing.assert_array_equal(s, jctv.concept_scores(mat, grad))
    for k in (1, 3, 7):
        assert tctv.top_concepts(s, names, k) == jctv.top_concepts(s, names,
                                                                    k)
    per_class = {"run": [rng.standard_normal(7) for _ in range(3)],
                 "swim": [np.zeros(7), rng.standard_normal(7)], "sit": []}
    assert (tctv.tcav_statistics(per_class, names)
            == jctv.tcav_statistics(per_class, names))
    inst = _instances()
    assert tctv.concept_robustness(inst) == jctv.concept_robustness(inst)


def test_gradcam_matches_jax():
    rng = np.random.default_rng(6)
    b, t, grid, d = 2, 3, 2, 16
    act = rng.standard_normal((b, 1 + grid * grid * t, d)).astype(np.float32)
    grad = rng.standard_normal(act.shape).astype(np.float32)
    got = tgradcam.gradcam_from_tokens(act, grad, t, grid)
    np.testing.assert_array_equal(got, jgradcam.gradcam_from_tokens(
        act, grad, t, grid))
    assert got.shape == (b, t, grid, grid) and got.dtype == np.float32
    frame = rng.integers(0, 256, (20, 24, 3), np.uint8)
    np.testing.assert_array_equal(
        tgradcam.overlay_heatmap(frame, got[0, 1], alpha=0.3),
        jgradcam.overlay_heatmap(frame, got[0, 1], alpha=0.3))


def test_linear_probe_matches_jax():
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((120, 6))
    labels = {"signal": (emb[:, 0] > 0).astype(int),
              "noise": rng.integers(0, 2, 120),
              "constant": np.zeros(120, int)}
    got = tprobe.linear_probe_concepts(emb, labels, seed=2)
    want = jprobe.linear_probe_concepts(emb, labels, seed=2)
    assert sorted(got) == sorted(want)
    assert got["signal"] == want["signal"] > 0.9
    assert got["noise"] == want["noise"]
    assert np.isnan(got["constant"]) and np.isnan(want["constant"])


# -- masking ----------------------------------------------------------------------

BOXES = [(2, 3, 9, 7), (-5, -4, 4, 3), (10, 6, 40, 30), (-9, 2, -1, 8),
         (3, -8, 6, -2), (5.7, 1.2, 8.9, 4.5)]


@pytest.mark.parametrize("box", BOXES)
def test_box_mask_and_draw_box_match_jax(box):
    """Both corners are clamped into the frame: a negative x2/y2 masks
    nothing, as in JAX."""
    rng = np.random.default_rng(1)
    frame = rng.integers(1, 256, (12, 16, 3), np.uint8)
    got = tmask.box_mask(frame.copy(), box)
    np.testing.assert_array_equal(got, jmask.box_mask(frame.copy(), box))
    np.testing.assert_array_equal(
        tmask.draw_box(frame.copy(), box, (0, 255, 0), 1),
        jmask.draw_box(frame.copy(), box, (0, 255, 0), 1))


def _detections(t, seed=2):
    """Per-frame (n, 6) x1,y1,x2,y2,conf,cls: class 0 in every frame,
    class 1 in 4 frames, class 2 in 6."""
    rng = np.random.default_rng(seed)
    dets = []
    for i in range(t):
        rows = [[1, 1, 6, 5, 0.9, 0]]
        if i < 4:
            rows.append([4, 2, 12, 9, 0.8, 1])
        if i % 2:
            rows.append(list(rng.integers(0, 8, 2)) + [14, 11, 0.7, 2])
        dets.append(np.asarray(rows, np.float32))
    return dets


@pytest.mark.parametrize("min_frames", [0, 3, 4, 10])
def test_per_class_masked_videos_matches_jax(min_frames):
    rng = np.random.default_rng(4)
    frames = rng.integers(1, 256, (12, 12, 16, 3), np.uint8)
    dets = _detections(12)
    names = ["person", "dog", "ball"]
    got = tmask.per_class_masked_videos(frames, dets, names, min_frames)
    want = jmask.per_class_masked_videos(frames, dets, names, min_frames)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    assert ("dog" in got) == (4 > min_frames)


@pytest.mark.parametrize("n_frames", [5, 16, 21])
def test_detect_video_pads_the_tail_as_jax(n_frames):
    """The detector always sees batch_size frames (the tail padded with
    the last frame) and the padding's detections are dropped."""
    frames = np.arange(n_frames, dtype=np.uint8)[:, None, None, None] \
        * np.ones((1, 2, 2, 3), np.uint8)

    def detector(seen):
        def fn(chunk):
            seen.append(len(chunk))
            return [np.asarray([[0, 0, 1, 1, 1.0, float(f[0, 0, 0])]])
                    for f in chunk]
        return fn

    seen_t, seen_j = [], []
    got = tmask.detect_video(detector(seen_t), frames, batch_size=8)
    want = jmask.detect_video(detector(seen_j), frames, batch_size=8)
    assert seen_t == seen_j and set(seen_t) == {8}
    assert len(got) == n_frames
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the concept-bottleneck head ----------------------------------------------------

def test_residual_head_through_the_converter():
    cfg = dict(embed_dim=8, n_concepts=4, num_classes=3, hidden=6)
    jhead = jcbm.ResidualHead(jcbm.ConceptBottleneckConfig(**cfg))
    rng = np.random.default_rng(10)
    e = rng.standard_normal((5, 8)).astype(np.float32)
    c = rng.standard_normal((5, 4)).astype(np.float32)
    variables = random_variables(jhead.init(jax.random.key(0), e, c), 11)
    want = jhead.apply(variables, e, c)
    thead = tcbm.ResidualHead(tcbm.ConceptBottleneckConfig(**cfg),
                              device="cpu")
    sd = residual_head_state_dict_from_jax(variables)
    thead.load_state_dict(sd)
    with torch.no_grad():
        got = thead(torch.from_numpy(e), torch.from_numpy(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)
    back = residual_head_variables_to_jax(thead.state_dict())
    want_leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w)
    assert tcbm.ConceptBottleneckConfig() == tcbm.ConceptBottleneckConfig(
        **vars(jcbm.ConceptBottleneckConfig()))


@pytest.mark.parametrize("name,layers", [("timesformer", 12),
                                         ("vit_b", 24), ("swin_t", 4),
                                         ("SlowFast", 4), ("x3d_m", 5)])
def test_model_layers_match_jax(name, layers):
    assert (tlayers.get_model_layers(name, layers)
            == jlayers.get_model_layers(name, layers))


def test_model_layers_unknown_family_raises():
    with pytest.raises(KeyError, match="no layer map"):
        tlayers.get_model_layers("tsm_r50")


def test_package_exports_match_jax():
    names = {n for n in dir(jexplain) if not n.startswith("_")
             and callable(getattr(jexplain, n))}
    assert names <= {n for n in dir(texplain) if not n.startswith("_")}
    assert tgrads.add_capture_methods(trec.Recognizer3D) is trec.Recognizer3D


# -- the whole pipeline -----------------------------------------------------------

def _banks(d=32, seed=12):
    rng = np.random.default_rng(seed)
    return {"symbolic": (rng.standard_normal((5, d)).astype(np.float32),
                         [f"obj{i}" for i in range(5)]),
            "cluster": (rng.standard_normal((9, d)).astype(np.float32),
                        [f"obj{i}#c{j}" for i in range(3)
                         for j in range(3)])}


def _preprocess(clip_u8):
    """uint8 (T, H, W, 3) -> the model's normalized float32 clip."""
    return (clip_u8.astype(np.float32) - 127.5) / 127.5


def _fake_detector(chunk):
    """Class 0 in every frame, class 1 in frames whose first pixel is
    odd (a deterministic function of the pixels, like a detector)."""
    out = []
    for f in chunk:
        rows = [[2, 2, 9, 9, 0.9, 0]]
        if int(f[0, 0, 0]) % 2:
            rows.append([0, 4, 16, 12, 0.6, 1])
        out.append(np.asarray(rows, np.float32))
    return out


@pytest.mark.parametrize("with_detector", [False, True])
def test_explain_video_matches_jax(pair, with_detector):
    jm, variables, tm = pair
    rng = np.random.default_rng(14)
    raw = rng.integers(0, 256, (4, 16, 16, 3), np.uint8)
    batch = _preprocess(raw)[None]
    kw = {}
    if with_detector:
        kw = dict(detector_fn=_fake_detector, raw_frames_u8=raw,
                  class_names=["person", "ball"], preprocess_fn=_preprocess,
                  min_frames=1)
    jbanks = {k: jpipe.ConceptBank(*v) for k, v in _banks().items()}
    tbanks = {k: tpipe.ConceptBank(*v) for k, v in _banks().items()}
    want = jpipe.explain_video(jm, variables, jnp.asarray(batch), 1, jbanks,
                               topk=3, **kw)
    got = tpipe.explain_video(tm, batch, 1, tbanks, topk=3, **kw)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=TOL)
    _close_grads(got["grad_probe"], want["grad_probe"])
    for level in tbanks:
        _close_grads(got[f"{level}_scores"], want[f"{level}_scores"])
        assert ([n for n, _ in got[f"{level}_top"]]
                == [n for n, _ in want[f"{level}_top"]])
    if with_detector:
        assert got["detected_concepts"] == want["detected_concepts"]
        assert sorted(got["video_ctvs"]) == ["ball", "person"]
        for name, ctv in want["video_ctvs"].items():
            np.testing.assert_allclose(got["video_ctvs"][name], ctv, rtol=0,
                                       atol=TOL)
        assert ([n for n, _ in got["video_ctv_top"]]
                == [n for n, _ in want["video_ctv_top"]])


def test_explain_video_without_preprocess_raises_as_jax(pair):
    """Masked clips without a preprocess_fn raise ValueError in both
    packages; with no masked clip (every class under min_frames) there is
    nothing to embed and no error."""
    jm, variables, tm = pair
    raw = np.random.default_rng(15).integers(0, 256, (4, 16, 16, 3),
                                             np.uint8)
    batch = _preprocess(raw)[None]
    for fn, model_args in ((tpipe.explain_video, (tm,)),
                           (jpipe.explain_video, (jm, variables))):
        with pytest.raises(ValueError, match="preprocess_fn"):
            fn(*model_args, batch, 1, {}, detector_fn=_fake_detector,
               raw_frames_u8=raw, min_frames=1)
    out = tpipe.explain_video(tm, torch.from_numpy(batch), 1, {},
                              detector_fn=_fake_detector, raw_frames_u8=raw,
                              min_frames=10)
    assert out["detected_concepts"] == [] and "video_ctvs" not in out

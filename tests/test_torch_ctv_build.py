"""The port's concept-bank build (cli/ctv_build.py), explain_video with the
real detector and the sklearn-free k-means (explain/ctv.kmeans) against
the JAX package, cv2 and scikit-learn on the CPU.

A joint space-time TimeSformer with flash attention (4 frames of 16²,
patch 8, width 32, 2 heads, 2 layers, f32; the JAX flash kernel in
interpret mode) and a YOLOv5 of width 0.125 whose two firing classes fire
on every frame, both from numpy seeds; seeded videos of 24 frames of
64x96 reach both packages' decode stage through its `reader`.

Tolerances: the banks' names equal and their matrices within 1e-4 of
their largest magnitude; explain_video's detected concepts equal and its
video CTVs within the same bound; k-means labels equal to scikit-learn's
and centres within 1e-5."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

from cross_modal_video_engine_tpu.cli import ctv_build as jcb
from cross_modal_video_engine_tpu.convert import convert_yolov5
from cross_modal_video_engine_tpu.explain import ctv as jctv
from cross_modal_video_engine_tpu.explain import pipeline as jpipe
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.models import yolo as jyolo
from cross_modal_video_engine_tpu_torch.bench.serve import SeededVideo
from cross_modal_video_engine_tpu_torch.cli import ctv_build as tcb
from cross_modal_video_engine_tpu_torch.cli.explain_demo import (
    load_concept_banks)
from cross_modal_video_engine_tpu_torch.convert import (
    recognizer_state_dict_from_jax, yolo_variables_to_jax)
from cross_modal_video_engine_tpu_torch.data.pipelines import build_pipeline
from cross_modal_video_engine_tpu_torch.explain import ctv as tctv
from cross_modal_video_engine_tpu_torch.explain import masking as tmask
from cross_modal_video_engine_tpu_torch.explain import pipeline as tpipe
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
from cross_modal_video_engine_tpu_torch.train.checkpoint import (
    save_checkpoint)
from torch_parity import interpret_pallas, random_variables

TS = dict(num_frames=4, img_size=16, patch_size=8, embed_dims=32,
          num_heads=2, num_layers=2, drop_path_max=0.0,
          attention_type="joint_space_time", use_flash_attention=True)
CLASSES = 5
YOLO = tyolo.YoloConfig(num_classes=6, depth_multiple=0.33,
                        width_multiple=0.125, img_size=64)
FIRE = (1, 4)
NAMES = [f"concept{i}" for i in range(YOLO.num_classes)]
PIPE = [dict(type="DecordInit"),
        dict(type="SampleFrames", clip_len=4, frame_interval=4, num_clips=1,
             test_mode=True),
        dict(type="DecordDecode"),
        dict(type="Resize", scale=(-1, 16)),
        dict(type="CenterCrop", crop_size=16),
        dict(type="Normalize", mean=[127.5] * 3, std=[127.5] * 3),
        dict(type="FormatShape", input_format="NTHWC")]
VIDEOS = {f"v{i}.mp4": SeededVideo(40 + i, frames=24, height=64, width=96)
          for i in range(4)}
REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _interpret():
    with pytest.MonkeyPatch.context() as mp:
        interpret_pallas(mp)
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def _jax_reads(monkeypatch, videos):
    """The JAX package's DecordInit opens `videos[filename]` (its
    open_video replaced for the test)."""
    from cross_modal_video_engine_tpu.io import video_decode as jvd
    monkeypatch.setattr(jvd, "open_video", videos.__getitem__)


@pytest.fixture(scope="module")
def world():
    """(JAX recognizer, its variables, the port's recognizer; the JAX
    detector function, the port's detector)."""
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**TS), num_classes=CLASSES)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3), jnp.float32)), 31)
    tm = trec.Recognizer3D(tts.TimeSformerConfig(**TS), num_classes=CLASSES,
                           device="cpu")
    tm.load_state_dict(recognizer_state_dict_from_jax(variables,
                                                      tm.backbone.cfg))
    sd = tyolo.random_state_dict(YOLO, seed=5, fire=FIRE)
    det = tyolo.YoloV5(YOLO, device="cpu")
    det.load_state_dict(sd)
    yv = convert_yolov5(sd, YOLO)
    jcfg = jyolo.YoloConfig(num_classes=6, depth_multiple=0.33,
                            width_multiple=0.125, img_size=64)
    apply = jax.jit(lambda p, x: jyolo.decode_predictions(
        jyolo.YoloV5(jcfg).apply(p, x), jcfg))

    def jax_detector(frames_u8):
        x = jnp.asarray(frames_u8.astype(np.float32) / 255.0)
        return jyolo.postprocess(np.asarray(apply(yv, x)))

    return jm, variables, tm.requires_grad_(False), jax_detector, det


def _close(got, want, rel=REL):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _same_banks(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith("_names"):
            assert list(got[k]) == list(want[k]), k
        else:
            assert got[k].shape == want[k].shape, k
            _close(got[k], want[k])


def test_build_ctv_banks_matches_jax(world, monkeypatch):
    """min_frames stays at its default of 10 while a video decodes 4
    frames: both packages cap it at 3, so the concepts pass."""
    jm, variables, tm, jax_detector, det = world
    names = sorted(VIDEOS)
    _jax_reads(monkeypatch, VIDEOS)
    want = jcb.build_ctv_banks(jm, variables, names, jax_detector, NAMES, 1,
                               pipeline=PIPE, n_clusters=2)
    times = {}
    got = tcb.build_ctv_banks(tm, names, tcb.make_detector_fn(det), NAMES, 1,
                              pipeline=PIPE, n_clusters=2,
                              reader=VIDEOS.__getitem__, times=times)
    _same_banks(got, want)
    assert list(got["symbolic_names"]) == [NAMES[c] for c in FIRE]
    assert len(got["cluster_names"]) == 2 * len(FIRE)
    assert set(times) == {"decode", "detection", "masking", "embedding",
                          "clustering"}


def test_frames_off_the_32_grid_are_refused(world, monkeypatch):
    """360x480 frames: the JAX package's detector fails in its PANet
    concatenation; the port refuses them before the detector runs.
    352x480 frames pass."""
    jm, variables, tm, jax_detector, det = world
    calls = []

    def counting(frames):
        calls.append(frames.shape)
        return tcb.make_detector_fn(det)(frames)

    for hw, ok in (((360, 480), False), ((352, 480), True)):
        videos = {"a.mp4": SeededVideo(3, frames=12, height=hw[0],
                                       width=hw[1])}
        if ok:
            banks = tcb.build_ctv_banks(tm, ["a.mp4"], counting, NAMES, 1,
                                        pipeline=PIPE,
                                        reader=videos.__getitem__)
            assert calls and banks["instance_matrix"].shape[0] == len(FIRE)
            continue
        _jax_reads(monkeypatch, videos)
        with pytest.raises(TypeError, match="oncatenate"):
            jcb.build_ctv_banks(jm, variables, ["a.mp4"], jax_detector,
                                NAMES, 1, pipeline=PIPE)
        with pytest.raises(ValueError, match="multiples of 32"):
            tcb.build_ctv_banks(tm, ["a.mp4"], counting, NAMES, 1,
                                pipeline=PIPE, reader=videos.__getitem__)
        assert not calls


def test_the_detector_fn_is_detect_py_s_protocol(world):
    """ctv_build's detector: conf 0.25, the argmax class (not multi-label),
    NMS at 0.45, at most 300 boxes; a tail chunk is padded to 16 frames by
    repeating the last one (explain/masking.detect_video)."""
    det = world[4]
    frames = np.stack([VIDEOS["v1.mp4"].frame(i) for i in range(20)])
    seen = []
    fn = tcb.make_detector_fn(det)
    dets = tmask.detect_video(lambda f: seen.append(f) or fn(f), frames)
    assert [len(f) for f in seen] == [16, 16] and len(dets) == 20
    np.testing.assert_array_equal(seen[1][4:], np.repeat(frames[-1:], 12, 0))
    with torch.no_grad():
        preds = tyolo.decode_predictions(
            det(torch.from_numpy(frames[:16]).float() / 255.0), YOLO).numpy()
    want = tyolo.postprocess(preds, 0.25, 0.45, 300, multi_label=False)
    for g, w in zip(dets[:16], want):
        np.testing.assert_array_equal(g, w)


def test_ctv_build_cli_writes_banks_explain_loads(world, tmp_path,
                                                  monkeypatch):
    """main() from a JAX-format classifier checkpoint and a JAX-format
    detector checkpoint (both written by the port's save_checkpoint) on
    the CPU; the npz loads through explain_demo.load_concept_banks."""
    _, variables, tm, _, det = world
    monkeypatch.setattr(tcb, "DEFAULT_PIPELINE", PIPE)
    ckpt, yolo_ckpt = str(tmp_path / "rec"), str(tmp_path / "yolo")
    save_checkpoint(ckpt, variables, {"backbone": TS,
                                      "num_classes": CLASSES})
    save_checkpoint(yolo_ckpt, yolo_variables_to_jax(det.state_dict(), YOLO),
                    YOLO)
    (tmp_path / "list.txt").write_text("\n".join(sorted(VIDEOS)))
    (tmp_path / "names.json").write_text(json.dumps(NAMES))
    out = str(tmp_path / "banks.npz")
    banks = tcb.main(["--checkpoint", ckpt, "--video_list",
                      str(tmp_path / "list.txt"), "--detector_checkpoint",
                      yolo_ckpt, "--class_names", str(tmp_path /
                                                      "names.json"),
                      "--output", out, "--target_layer", "1", "--device",
                      "cpu"], reader=VIDEOS.__getitem__)
    loaded = load_concept_banks(out)
    assert sorted(loaded) == ["cluster", "instance", "symbolic"]
    for level, bank in loaded.items():
        np.testing.assert_array_equal(bank.matrix, banks[f"{level}_matrix"])
        assert bank.names == list(banks[f"{level}_names"])
    direct = tcb.build_ctv_banks(tm, sorted(VIDEOS),
                                 tcb.make_detector_fn(det), NAMES, 1,
                                 pipeline=PIPE, reader=VIDEOS.__getitem__)
    _same_banks(banks, direct)


def test_explain_video_with_the_detector_matches_jax(world):
    jm, variables, tm, jax_detector, det = world
    video = VIDEOS["v0.mp4"]
    decode = build_pipeline([dict(PIPE[0], reader=lambda _: video)]
                            + PIPE[1:3])
    raw = np.stack(decode({"filename": "v0.mp4", "start_index": 0})["imgs"])
    tail = build_pipeline(PIPE[3:])

    def prep(clip):
        return np.asarray(tail({"imgs": list(clip), "clip_len": len(clip),
                                "num_clips": 1})["imgs"][0], np.float32)

    batch = prep(raw)[None]
    bank = np.random.default_rng(2).standard_normal((3, 32)).astype(
        np.float32)
    kw = dict(target_layer=1, raw_frames_u8=raw, class_names=NAMES,
              preprocess_fn=prep, min_frames=3, topk=2)
    want = jpipe.explain_video(
        jm, variables, jnp.asarray(batch),
        concept_banks={"symbolic": jpipe.ConceptBank(bank, ["a", "b", "c"])},
        detector_fn=jax_detector, **kw)
    got = tpipe.explain_video(
        tm, batch,
        concept_banks={"symbolic": tpipe.ConceptBank(bank, ["a", "b", "c"])},
        detector_fn=tcb.make_detector_fn(det), **kw)
    assert got["detected_concepts"] == want["detected_concepts"] == [
        NAMES[c] for c in FIRE]
    for name, vec in want["video_ctvs"].items():
        _close(got["video_ctvs"][name], vec)
    assert [n for n, _ in got["video_ctv_top"]] == [
        n for n, _ in want["video_ctv_top"]]


def _kmeans_data(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "separated":
        centres = rng.standard_normal((3, 48)) * 10
        return (centres[rng.integers(0, 3, 30)]
                + rng.standard_normal((30, 48))).astype(np.float32)
    n = int(rng.integers(6, 40))
    dtype = np.float32 if seed % 2 else np.float64
    return rng.standard_normal((n, 24)).astype(dtype)


@pytest.mark.parametrize("kind", ["separated", "random"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [2, 3])
def test_kmeans_matches_sklearn(kind, seed, k):
    x = _kmeans_data(kind, seed)
    ref = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(x)
    centres, labels, _ = tctv.kmeans(x, k, seed)
    np.testing.assert_array_equal(labels, ref.labels_)
    assert centres.dtype == ref.cluster_centers_.dtype == x.dtype
    np.testing.assert_allclose(centres, ref.cluster_centers_, rtol=0,
                               atol=1e-5)


def test_cluster_concept_vectors_equal_before():
    """The same banks as the JAX package's sklearn clustering."""
    rng = np.random.default_rng(7)
    inst = {f"c{i}": [rng.standard_normal(16).astype(np.float32)
                      for _ in range(n)] for i, n in enumerate((1, 2, 5, 9))}
    got, got_names = tctv.cluster_concept_vectors(inst, 3)
    want, want_names = jctv.cluster_concept_vectors(inst, 3)
    assert got_names == want_names
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

"""The port's caption inference path against the JAX package's, on the
CPU at a small size (2 layers, width 64, 4 heads, 8x32² clips, 5
classes): `convert.recognizer_variables_to_jax`, `api.init_recognizer`
on a checkpoint the JAX package wrote, `api.inference_recognizer`, the
`caption_inference` and `caption_test` CLIs on videos written with
OpenCV; and that every f32 entry point (the training CLIs too) turns
TF32 off.

The JAX flash kernel runs in interpret mode, the port's flash attention
its plain version.  Tolerances: f32 probabilities and scores within 1e-4
(summation order); the greedy decode's steps equal (the fixtures' seeds
leave every probability at least 1e-3 from the 0.5 threshold, asserted,
where a 1e-4 difference cannot flip a label); seq_mAP within 1e-6; the
JAX -> port -> JAX weight round trip bit for bit.  bf16 (after the
inference cast): backbone features by cosine >= 0.999, step-0
probabilities within 2e-2."""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu import api as japi
from cross_modal_video_engine_tpu.cli import caption_inference as jci
from cross_modal_video_engine_tpu.cli import caption_test as jct
from cross_modal_video_engine_tpu.io.video_decode import write_test_video
from cross_modal_video_engine_tpu.models import decoder_head as jdec
from cross_modal_video_engine_tpu.models import recognizer as jrec
from cross_modal_video_engine_tpu.models import timesformer as jts
from cross_modal_video_engine_tpu.train.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from cross_modal_video_engine_tpu_torch import api
from cross_modal_video_engine_tpu_torch.cli import caption_inference as tci
from cross_modal_video_engine_tpu_torch.cli import caption_test as tct
from cross_modal_video_engine_tpu_torch.convert import (
    recognizer_state_dict_from_jax, recognizer_variables_to_jax,
    yolo_variables_to_jax)
from cross_modal_video_engine_tpu_torch.models import recognizer as trec
from cross_modal_video_engine_tpu_torch.models import timesformer as tts
from cross_modal_video_engine_tpu_torch.models.decoder_head import (
    RNNDecoderConfig)
from cross_modal_video_engine_tpu_torch.train.checkpoint import (
    save_checkpoint)
from torch_parity import interpret_pallas, min_cosine, random_variables, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TS = dict(num_frames=8, img_size=32, patch_size=8, embed_dims=64,
          num_heads=4, num_layers=2, attention_type="joint_space_time",
          use_flash_attention=True, drop_path_max=0.0)
DEC = dict(num_classes=5, in_channels=64, max_len=4, threshold=0.5)
# the caption test pipeline at 8x32²: two clips a video, short side 36
PIPE = [dict(type="DecordInit"),
        dict(type="SampleFrames", clip_len=8, frame_interval=2, num_clips=2,
             test_mode=True),
        dict(type="DecordDecode"), dict(type="Resize", scale=(-1, 36)),
        dict(type="CenterCrop", crop_size=32),
        dict(type="Normalize", mean=[127.5] * 3, std=[127.5] * 3),
        dict(type="FormatShape", input_format="NTHWC")]
TOL, MARGIN = 1e-4, 1e-3


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


def write_videos(root, n, seed=5, shape=(30, 40, 54)):
    """n mp4 videos of random uint8 frames, written with OpenCV."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(root, f"v{i}.mp4")
        write_test_video(p, rng.integers(0, 256, shape + (3,), np.uint8))
        paths.append(p)
    return paths


def jax_caption_checkpoint(path, seed=12, backbone=TS, decoder=DEC):
    """A caption checkpoint the JAX package writes (its save_checkpoint)
    of random weights from a numpy seed; returns its variables."""
    jm = jrec.Recognizer3DRelseq(jts.TimeSformerConfig(**backbone),
                                 jdec.RNNDecoderConfig(**decoder))
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 8, 32, 32, 3), jnp.float32)), seed)
    jax_save_checkpoint(path, variables, {"backbone": dict(backbone),
                                          "decoder": dict(decoder)})
    return variables


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Four videos and the JAX package's caption checkpoint."""
    root = str(tmp_path_factory.mktemp("caption"))
    videos = write_videos(root, 4)
    ckpt = os.path.join(root, "ckpt")
    jax_caption_checkpoint(ckpt)
    return root, videos, ckpt


# -- the weights, both ways ---------------------------------------------------

VARIANTS = [("divided_space_time", 1), ("joint_space_time", 1),
            ("space_only", 1), ("joint_space_time", 2)]


@pytest.mark.parametrize("head", ["classifier", "caption"])
@pytest.mark.parametrize("attention,tubelet", VARIANTS)
def test_recognizer_variables_round_trip_bit_for_bit(attention, tubelet,
                                                     head):
    cfg = jts.TimeSformerConfig(num_frames=4, img_size=16, patch_size=8,
                                embed_dims=32, num_heads=2, num_layers=2,
                                attention_type=attention,
                                tubelet_size=tubelet)
    jm = (jrec.Recognizer3D(cfg, num_classes=5) if head == "classifier" else
          jrec.Recognizer3DRelseq(cfg, jdec.RNNDecoderConfig(
              num_classes=5, in_channels=32, max_len=3)))
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 4, 16, 16, 3), jnp.float32)), 3)
    back = recognizer_variables_to_jax(
        recognizer_state_dict_from_jax(variables, cfg), cfg)
    want = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), path


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port writes a caption checkpoint in the JAX format (its own
    save_checkpoint); the JAX package's init_recognizer serves it."""
    cfg = tts.TimeSformerConfig(**TS)
    sd = trec.random_state_dict(cfg, 9, decoder_cfg=RNNDecoderConfig(**DEC))
    ckpt = str(tmp_path / "port_ckpt")
    save_checkpoint(ckpt, recognizer_variables_to_jax(sd, cfg),
                    {"backbone": TS, "decoder": DEC})
    jm, jvars, jcfg = japi.init_recognizer(ckpt)
    assert jcfg == {"backbone": TS, "decoder": DEC}
    model, _ = api.init_recognizer(ckpt, device="cpu")
    v = np.random.default_rng(4).standard_normal(
        (3, 8, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(jvars, jnp.asarray(v), num_segs=3,
                               method="forward_test"))
    with torch.no_grad():
        got = model.forward_test(torch.from_numpy(v), num_segs=3)
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=TOL)
    for k, t in model.state_dict().items():
        assert torch.equal(t, sd[k]), k


# -- init_recognizer, caption_video, inference_recognizer ----------------------

def test_caption_video_matches_jax(world):
    """End to end on an OpenCV-written video from the JAX package's own
    checkpoint, f32 with flash attention on."""
    _, videos, ckpt = world
    jm, jvars, _ = japi.init_recognizer(ckpt)
    model, cfg_d = api.init_recognizer(ckpt, device="cpu")
    assert cfg_d["decoder"] == DEC and not model.training
    assert model.backbone.cfg.use_flash_attention
    for video in videos:
        want_steps, want = jci.caption_video(jm, jvars, video, PIPE)
        got_steps, got = tci.caption_video(model, video, PIPE)
        # each clip's greedy decode, and their mean, clear the threshold
        per_clip = jm.apply(jvars, jnp.asarray(api.run_pipeline(PIPE, video)))
        assert np.abs(np.asarray(per_clip) - 0.5).min() > MARGIN
        assert np.abs(want - 0.5).min() > MARGIN
        assert got.shape == (DEC["max_len"], DEC["num_classes"])
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert got_steps == [[int(i) for i in s] for s in want_steps]


def test_caption_inference_cli_matches_jax(world, tmp_path, monkeypatch,
                                           capsys):
    _, videos, ckpt = world
    names = str(tmp_path / "names.json")
    with open(names, "w") as f:
        json.dump([f"label{i}" for i in range(DEC["num_classes"])], f)
    monkeypatch.setattr(jci, "DEFAULT_PIPELINE", PIPE)
    monkeypatch.setattr(tci, "DEFAULT_PIPELINE", PIPE)
    argv = ["--checkpoint", ckpt, "--video", videos[2], "--label_names",
            names, "--threshold", "0.45"]
    want = jci.main(argv)
    jax_out = capsys.readouterr().out
    got = tci.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out == jax_out
    assert got == [[int(i) for i in s] for s in want]
    assert len(got) == DEC["max_len"]


# a classifier at 224² (patch 56, so 16 patches a frame): `centercrop=False`
# resizes to 224 x 224, as the JAX function does
TS_224 = dict(TS, img_size=224, patch_size=56)
PIPE_224 = [dict(c, scale=(-1, 256)) if c["type"] == "Resize" else
            dict(c, crop_size=224) if c["type"] == "CenterCrop" else dict(c)
            for c in PIPE]


@pytest.fixture(scope="module")
def classifier(tmp_path_factory):
    """A Recognizer3D checkpoint (joint, flash) the JAX package wrote."""
    root = str(tmp_path_factory.mktemp("classifier"))
    jm = jrec.Recognizer3D(jts.TimeSformerConfig(**TS_224), num_classes=6)
    variables = random_variables(jm.init(
        jax.random.key(0), jnp.zeros((1, 8, 224, 224, 3), jnp.float32)), 17)
    ckpt = os.path.join(root, "ckpt")
    jax_save_checkpoint(ckpt, variables, {"backbone": TS_224,
                                          "num_classes": 6})
    video = write_videos(root, 1, seed=6)[0]
    return ckpt, video


@pytest.mark.parametrize("kwargs", [
    {}, {"outputs": [0, 1]}, {"centercrop": False},
    {"shuffle_idx": [7, 6, 5, 4, 3, 2, 1, 0] * 2, "outputs": [1]},
    {"return_scores": False, "outputs": [0]}],
    ids=["scores", "outputs", "no-centercrop", "shuffle", "no-scores"])
def test_inference_recognizer_matches_jax(classifier, kwargs):
    ckpt, video = classifier
    jm, jvars, _ = japi.init_recognizer(ckpt)
    model, _ = api.init_recognizer(ckpt, device="cpu")
    pipe = [dict(c) for c in PIPE_224]
    want, want_cap = japi.inference_recognizer(jm, jvars, video,
                                               pipeline=pipe, **kwargs)
    got, got_cap = api.inference_recognizer(model, video, pipeline=pipe,
                                            **kwargs)
    assert pipe == PIPE_224                 # the caller's dicts untouched
    if kwargs.get("return_scores", True):
        assert got.shape == (2, 6) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    else:
        assert got is None and want is None
    assert sorted(got_cap) == sorted(want_cap) == sorted(
        kwargs.get("outputs", []))
    for k in want_cap:
        np.testing.assert_allclose(got_cap[k], want_cap[k], rtol=0, atol=TOL)


def test_inference_recognizer_shuffle_needs_a_resize(classifier):
    ckpt, video = classifier
    model, _ = api.init_recognizer(ckpt, device="cpu")
    with pytest.raises(ValueError, match="Resize"):
        api.inference_recognizer(model, video, shuffle_idx=[0],
                                 pipeline=[c for c in PIPE
                                           if c["type"] != "Resize"])


def test_init_recognizer_bf16_checkpoint_matches_jax(tmp_path):
    """A checkpoint whose backbone says bfloat16: both packages cast the
    f32 tree at load and compute in bf16."""
    bb = dict(TS, dtype="bfloat16")
    ckpt = str(tmp_path / "bf16")
    jax_caption_checkpoint(ckpt, seed=11, backbone=bb)
    jm, jvars, _ = japi.init_recognizer(ckpt)
    model, _ = api.init_recognizer(ckpt, device="cpu")
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and not p.requires_grad, name
    v = np.random.default_rng(8).standard_normal(
        (2, 8, 32, 32, 3)).astype(np.float32)
    want_feat = jm.apply(jvars, jnp.asarray(v), method="extract_feat")
    want = np.asarray(jm.apply(jvars, jnp.asarray(v)))
    with torch.no_grad():
        got_feat = model.extract_feat(torch.from_numpy(v))
    _, got = api.caption_clips(model, torch.from_numpy(v), num_segs=1)
    assert min_cosine(to_np(got_feat), want_feat) >= 0.999
    np.testing.assert_allclose(to_np(got[:, 0]), want[:, 0], rtol=0,
                               atol=2e-2)


def test_init_recognizer_refusals(tmp_path, world):
    _, _, ckpt = world
    with pytest.raises(ValueError, match="state_dict"):
        api.init_recognizer({"backbone": TS, "decoder": DEC})
    # 'CLIP' builds no caption backbone: both packages refuse it
    other = str(tmp_path / "clip")
    jax_save_checkpoint(other, {"params": {}},
                        {"backbone": {"type": "CLIP"}, "decoder": DEC})
    with pytest.raises(ValueError, match="unknown backbone type"):
        api.init_recognizer(other, device="cpu")
    with pytest.raises(ValueError, match="unknown backbone type"):
        japi.init_recognizer(other)
    # a 3D-CNN checkpoint without a decoder: both packages refuse it
    cls = str(tmp_path / "x3d_cls")
    jax_save_checkpoint(cls, {"params": {}},
                        {"backbone": {"type": "X3D"}, "num_classes": 4})
    with pytest.raises(ValueError, match="caption model"):
        api.init_recognizer(cls, device="cpu")
    with pytest.raises(AssertionError):
        japi.init_recognizer(cls)
    # device=None is the card: on a machine without one, torch refuses
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            api.init_recognizer(ckpt)


# -- caption_test --------------------------------------------------------------

def write_split(root, videos):
    """A 4-video label-sequence split of `videos` (one directory) and a
    config under root that evaluates it with PIPE, 3 videos a batch (the
    last batch padded)."""
    ann = os.path.join(root, "val.txt")
    labels = ["1,2->0->4", "3->3,1", "0,4->2->1->4", "2"]
    with open(ann, "w") as f:
        f.write("\n".join(f"{os.path.basename(v)} {lab}"
                          for v, lab in zip(videos, labels)))
    cfg = os.path.join(root, "cfg.py")
    with open(cfg, "w") as f:
        f.write(f"data = dict(videos_per_gpu=3, pipeline={PIPE!r},\n"
                f"            val=dict(ann_file={ann!r}, "
                f"data_prefix={os.path.dirname(videos[0])!r}))\n")
    return cfg


def write_train_config(root, videos, kind):
    """A one-epoch training config over `videos` for the caption trainer
    (kind 'caption': write_split's label sequences, the TS backbone with
    DEC) or the recognition trainer ('recognition': classes 0-3)."""
    data = os.path.dirname(videos[0])
    if kind == "caption":
        ann = os.path.join(root, "val.txt")
        write_split(root, videos)
        model = f"dict(backbone={TS!r}, decoder={DEC!r})"
    else:
        ann = os.path.join(root, "cls.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"{os.path.basename(v)} {i}"
                              for i, v in enumerate(videos)))
        model = f"dict(backbone={TS!r}, num_classes=4)"
    cfg = os.path.join(root, f"{kind}_train.py")
    split = f"dict(ann_file={ann!r}, data_prefix={data!r})"
    with open(cfg, "w") as f:
        f.write(f"model = {model}\n"
                f"data = dict(videos_per_gpu=2, pipeline={PIPE!r},\n"
                f"            train={split}, val={split})\n"
                f"total_epochs = 1\n")
    return cfg


def test_caption_test_matches_jax(world, tmp_path, capsys):
    root, videos, ckpt = world
    cfg = write_split(str(tmp_path), videos)
    want = jct.main([cfg, "--checkpoint", ckpt,
                     "--out", str(tmp_path / "jax.npz")])
    got = tct.main([cfg, "--checkpoint", ckpt, "--device", "cpu",
                    "--out", str(tmp_path / "port.npz"),
                    "--cfg-options", "data.videos_per_gpu=3"])
    assert got["num_videos"] == want["num_videos"] == 4
    for key in ("seq_mAP", "seq_mAP_labeled_classes"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    j, t = np.load(str(tmp_path / "jax.npz")), np.load(
        str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(t["labels"], j["labels"])
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=0, atol=TOL)
    np.testing.assert_allclose(t["per_class_ap"], j["per_class_ap"],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tct.eval_labels(np.ones((3, 4)), np.array([1, 0, 0])),
        jct.eval_labels(np.ones((3, 4)), np.array([1, 0, 0])))


# -- TF32 off in every f32 entry point ------------------------------------------

@pytest.fixture(scope="module")
def linas(tmp_path_factory):
    """A tiny LINAS collection and checkpoint (the port's bench fixtures)."""
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.models.dual_encoding import (
        DualEncodingConfig)
    root = str(tmp_path_factory.mktemp("linas"))
    cfg = DualEncodingConfig(
        visual_feat_dim=12, visual_rnn_size=6, visual_kernel_num=4,
        vocab_size=50, bow_vocab_size=30, word_dim=8, text_rnn_size=6,
        text_kernel_num=4, hidden_size=8, common_dim=16)
    bserve.write_collection(root, cfg, 6, caps_per_video=2, max_frames=6)
    ckpt = os.path.join(root, "ckpt")
    bserve.write_checkpoint(ckpt, cfg)
    return root, ckpt, cfg, bserve


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    """Tiny composed-retrieval fixtures (RN tower, conv4x4 Combiner)."""
    from cross_modal_video_engine_tpu_torch.bench import serve as bserve
    from cross_modal_video_engine_tpu_torch.models import clip_resnet as trn
    from cross_modal_video_engine_tpu_torch.models import combiner as tcomb
    rn = trn.CLIPResNetConfig(embed_dim=24, vision_layers=(1, 1, 1, 1),
                              vision_width=16, image_resolution=64,
                              context_length=12, vocab_size=800,
                              text_width=16, text_heads=2, text_layers=1)
    comb = tcomb.CombinerConfig(clip_feature_dim=24, projection_dim=16,
                                hidden_dim=20, middle_mix="conv4x4")
    root = str(tmp_path_factory.mktemp("composed"))
    return bserve.write_composed_fixtures(root, rn, comb, 3)


@pytest.fixture(scope="module")
def detector(tmp_path_factory):
    """Tiny detector fixtures: a yolov5-layout val directory of two .npy
    images with its config and a `best/` directory; a detector checkpoint,
    a classifier checkpoint, a video list, class names and seeded videos
    for ctv_build (64x64 frames)."""
    import dataclasses
    from cross_modal_video_engine_tpu_torch.bench.serve import SeededVideo
    from cross_modal_video_engine_tpu_torch.models import yolo as tyolo
    from cross_modal_video_engine_tpu_torch.train.resume import (
        save_train_state)
    root = tmp_path_factory.mktemp("detector")
    cfg = tyolo.YoloConfig(num_classes=3, width_multiple=0.125, img_size=64)
    det = tyolo.YoloV5(cfg, device="cpu")
    det.load_state_dict(tyolo.random_state_dict(cfg, 2, fire=(0, 2)))
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i in range(2):
        np.save(root / "images" / f"{i}.npy",
                np.full((48, 64, 3), 60 * i, np.uint8))
        (root / "labels" / f"{i}.txt").write_text("0 0.5 0.5 0.4 0.3\n")
    model = {k: v for k, v in dataclasses.asdict(cfg).items()
             if k in ("num_classes", "width_multiple", "img_size")}
    config = root / "cfg.py"
    config.write_text(f"model = {model!r}\ndata = dict(val=dict(img_dir="
                      f"{str(root / 'images')!r}, label_dir="
                      f"{str(root / 'labels')!r}), batch_size=2)\n")
    save_train_state(str(root / "best"), {"detector": det})
    save_checkpoint(str(root / "yolo"), yolo_variables_to_jax(
        det.state_dict(), cfg), cfg)
    ts = dict(TS, num_frames=8)
    save_checkpoint(str(root / "rec"), recognizer_variables_to_jax(
        trec.random_state_dict(tts.TimeSformerConfig(**ts), 4,
                               num_classes=4), tts.TimeSformerConfig(**ts)),
        {"backbone": ts, "num_classes": 4})
    videos = {f"v{i}.mp4": SeededVideo(i, frames=40, height=64, width=64)
              for i in range(2)}
    (root / "list.txt").write_text("\n".join(videos))
    (root / "names.json").write_text(json.dumps(["a", "b", "c"]))
    return root, videos


def _ctv_build(detector, tmp_path):
    from cross_modal_video_engine_tpu_torch.cli import ctv_build
    root, videos = detector
    pipe = ctv_build.DEFAULT_PIPELINE
    # one clip: ctv_build embeds each video's frames as one clip
    ctv_build.DEFAULT_PIPELINE = [
        dict(c, num_clips=1) if c["type"] == "SampleFrames" else c
        for c in PIPE]
    try:
        ctv_build.main([
            "--checkpoint", str(root / "rec"), "--video_list",
            str(root / "list.txt"), "--detector_checkpoint",
            str(root / "yolo"), "--class_names", str(root / "names.json"),
            "--output", str(tmp_path / "banks.npz"), "--device", "cpu"],
            reader=videos.__getitem__)
    finally:
        ctv_build.DEFAULT_PIPELINE = pipe


def _linas_main(linas, module, extra):
    root, ckpt, _, bserve = linas
    return module.main(["--checkpoint", ckpt, "--rootpath", root,
                        "--visual_feature", bserve.FEATURE, "--device",
                        "cpu"] + extra)


def _retrieval_trainer(linas, tmp_path):
    from cross_modal_video_engine_tpu_torch.cli import retrieval_trainer
    root, _, cfg, bserve = linas
    sizes = {k: getattr(cfg, k) for k in (
        "visual_rnn_size", "visual_kernel_num", "word_dim", "text_rnn_size",
        "text_kernel_num", "hidden_size", "common_dim")}
    retrieval_trainer.main([
        "--rootpath", root, "--trainCollection", bserve.COLLECTION,
        "--valCollection", bserve.COLLECTION, "--visual_feature",
        bserve.FEATURE, "--out_dir", str(tmp_path / "train"),
        "--batch_size", "4", "--num_epochs", "1", "--support_set_number",
        "2", "--visual_feat_dim", str(cfg.visual_feat_dim),
        "--config_json", json.dumps(sizes), "--device", "cpu"])


def _yolo_train(detector, tmp_path, classify=False):
    """One epoch of one step of yolo_train (the detector fixture's two
    images as the train split) or of yolo_cls_train (two classes of one
    image each), width 0.125 at 64 px, f32."""
    from cross_modal_video_engine_tpu_torch.cli import (yolo_cls_train,
                                                        yolo_train)
    root, _ = detector
    model = ("model = dict(num_classes={}, width_multiple=0.125, "
             "img_size=64)\n")
    config = tmp_path / "yolo_cfg.py"
    if classify:
        for c in ("a", "b"):
            (tmp_path / "folder" / c).mkdir(parents=True)
            np.save(tmp_path / "folder" / c / "0.npy",
                    np.full((40, 50, 3), 90, np.uint8))
        config.write_text(model.format(2) + "data = dict(train_dir="
                          f"{str(tmp_path / 'folder')!r}, batch_size=2)\n")
        yolo_cls_train.main([str(config), "--work_dir",
                             str(tmp_path / "cls_work"), "--total_epochs",
                             "1", "--device", "cpu"])
        return
    config.write_text(model.format(3) + "data = dict(train=dict(img_dir="
                      f"{str(root / 'images')!r}, label_dir="
                      f"{str(root / 'labels')!r}), batch_size=2)\n"
                      "autoanchor = False\n")
    yolo_train.main([str(config), "--work_dir", str(tmp_path / "yolo_work"),
                     "--total_epochs", "1", "--device", "cpu"])


def _route(builder, **args):
    handler = builder(argparse.Namespace(device="cpu", **args))
    handler.batcher.close()


def _cnn_recognition_test(videos, tmp):
    """recognition_test.main on a CNN classifier's checkpoint (a tiny TSM
    at its training init), which the CLI rebuilds from the config."""
    from cross_modal_video_engine_tpu_torch.cli import (recognition_test,
                                                        recognition_train)
    from cross_modal_video_engine_tpu_torch.config import Config
    cfg = write_train_config(str(tmp), videos, "recognition")
    tsm = dict(type="TSM", stage_blocks=[1, 1, 1, 1], base_channels=4)
    text = open(cfg).read().replace(repr(TS), repr(tsm))
    open(cfg, "w").write(text)
    model = recognition_train.build_recognition_model(Config.fromfile(cfg),
                                                      "cpu")
    ckpt = str(tmp / "tsm")
    save_checkpoint(ckpt, recognition_train.recognizer_variables(model),
                    {"backbone": tsm, "num_classes": 4})
    return recognition_test.main([cfg, "--checkpoint", ckpt, "--device",
                                  "cpu"])


def _recipe_train(w, extra: str):
    """recognition_train.main on the recognition config with a recipe
    (multigrid or OmniSource) appended."""
    from cross_modal_video_engine_tpu_torch.cli import recognition_train
    cfg = write_train_config(str(w["tmp"]), w["caption"][1], "recognition")
    with open(cfg, "a") as f:
        f.write(extra)
    return recognition_train.main([cfg, "--work_dir",
                                   str(w["tmp"] / "recipe_work"),
                                   "--device", "cpu"])


def _localization_train(tmp):
    """localization_train.main on a TEM config over four seeded videos of
    16 snippets."""
    from cross_modal_video_engine_tpu_torch.cli import localization_train
    rng = np.random.default_rng(8)
    feats = tmp / "loc_feats"
    feats.mkdir()
    ann = {}
    for i in range(4):
        np.save(feats / f"v{i}.npy",
                rng.standard_normal((16, 8)).astype(np.float32))
        ann[f"v{i}"] = {"duration": 10.0, "annotations": [
            {"segment": [2.0, 6.0], "label": 1}]}
    (tmp / "loc_ann.json").write_text(json.dumps(ann))
    data = (f"dict(ann_file=r'{tmp / 'loc_ann.json'}', "
            f"feature_prefix=r'{feats}')")
    (tmp / "loc.py").write_text(
        "model = dict(type='TEM', temporal_dim=16, feat_dim=8, hidden=8)\n"
        f"data = dict(train={data}, val={data})\n"
        "total_epochs = 1\nbatch_size = 2\n")
    return localization_train.main([str(tmp / "loc.py"), "--work_dir",
                                    str(tmp / "loc_work"), "--device",
                                    "cpu"])


def _detection(tmp, entry):
    """The AVA CLIs on the CPU over two seeded videos (a decord-alike
    reader): detection_train for one epoch of a tiny SlowOnly detector,
    detection_test on its model_best, ava_proposals with a seeded
    YOLOv5."""
    from cross_modal_video_engine_tpu_torch.bench.serve import SeededVideo
    from cross_modal_video_engine_tpu_torch.cli import (
        ava_proposals, detection_test, detection_train)
    videos = {f"v{i}.mp4": SeededVideo(80 + i, frames=20, height=32,
                                       width=32) for i in range(2)}
    (tmp / "ava.csv").write_text("v0.mp4,0.5,0.1,0.1,0.6,0.7,1,0\n"
                                 "v1.mp4,0.8,0.2,0.3,0.9,0.9,2,0\n")
    if entry == "ava_proposals":
        from cross_modal_video_engine_tpu_torch.convert import (
            yolo_variables_to_jax)
        from cross_modal_video_engine_tpu_torch.models import yolo
        from cross_modal_video_engine_tpu_torch.train.checkpoint import (
            save_checkpoint)
        ycfg = yolo.YoloConfig(num_classes=2, depth_multiple=0.33,
                               width_multiple=0.125, img_size=32)
        save_checkpoint(str(tmp / "yolo"), yolo_variables_to_jax(
            yolo.random_state_dict(ycfg, seed=1), ycfg), ycfg)
        return ava_proposals.main(
            ["--ann_file", str(tmp / "ava.csv"), "--yolo_checkpoint",
             str(tmp / "yolo"), "--out", str(tmp / "props.json"),
             "--img_size", "32", "--device", "cpu"],
            reader=videos.__getitem__)
    data = f"dict(ann_file=r'{tmp / 'ava.csv'}')"
    (tmp / "det.py").write_text(
        "model = dict(backbone=dict(type='SlowOnly', stage_blocks=[1, 1, 1, "
        "1], base_channels=8, stage_spatial_strides=[1, 2, 2, 1]), "
        "roi_head=dict(num_classes=3, roi_size=2, sampling_ratio=1), "
        "train_cfg=dict(max_boxes=2))\n"
        f"data = dict(train={data}, val={data}, fps=10, pipeline=["
        "dict(type='DecordInit'), dict(type='SampleAVAFrames', clip_len=2, "
        "frame_interval=2, test_mode=True), dict(type='DecordDecode'), "
        "dict(type='Normalize', mean=[127.5]*3, std=[127.5]*3), "
        "dict(type='FormatShape', input_format='NTHWC')], "
        "videos_per_gpu=2)\n"
        "total_epochs = 1\n")
    work = str(tmp / "det_work")
    if entry == "detection_train":
        return detection_train.main([str(tmp / "det.py"), "--work_dir", work,
                                     "--device", "cpu"],
                                    reader=videos.__getitem__)
    detection_train.main([str(tmp / "det.py"), "--work_dir", work,
                          "--device", "cpu"], reader=videos.__getitem__)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    return detection_test.main([str(tmp / "det.py"), "--checkpoint",
                                os.path.join(work, "model_best"), "--out",
                                str(tmp / "det.csv"), "--device", "cpu"],
                               reader=videos.__getitem__)


def _entry_points():
    from cross_modal_video_engine_tpu_torch.cli import (
        caption_train, composed_inference, dump_features, recognition_test,
        recognition_train, retrieval_inference, retrieval_tester, serve,
        yolo_val)
    from cross_modal_video_engine_tpu_torch.cli.common import (
        restore_dual_encoding)
    return {
        "restore_dual_encoding": lambda w: restore_dual_encoding(
            w["linas"][1], device="cpu"),
        "retrieval_inference.main": lambda w: _linas_main(
            w["linas"], retrieval_inference,
            ["--collection", w["linas"][3].COLLECTION, "--input", "w00001"]),
        "retrieval_tester.main": lambda w: _linas_main(
            w["linas"], retrieval_tester,
            ["--testCollection", w["linas"][3].COLLECTION, "--output_dir",
             str(w["tmp"] / "tester")]),
        "retrieval_trainer": lambda w: _retrieval_trainer(w["linas"],
                                                          w["tmp"]),
        "build_retrieval_handler": lambda w: _route(
            serve.build_retrieval_handler, retrieval_checkpoint=w["linas"][1],
            rootpath=w["linas"][0], collection=w["linas"][3].COLLECTION,
            visual_feature=w["linas"][3].FEATURE),
        "load_clip_tower": lambda w: composed_inference.load_clip_tower(
            w["composed"].clip_checkpoint, "cpu"),
        "build_composed_handler": lambda w: _route(
            serve.build_composed_handler, **vars(w["composed"])),
        "init_recognizer": lambda w: api.init_recognizer(w["caption"][2],
                                                         device="cpu"),
        "caption_inference.main": lambda w: tci.main([
            "--checkpoint", w["caption"][2], "--video", w["caption"][1][0],
            "--device", "cpu"]),
        "caption_test.main": lambda w: tct.main([
            write_split(str(w["tmp"]), w["caption"][1]), "--checkpoint",
            w["caption"][2], "--device", "cpu"]),
        "build_caption_handler": lambda w: _route(
            serve.build_caption_handler, caption_checkpoint=w["caption"][2]),
        "caption_train.main": lambda w: caption_train.main([
            write_train_config(str(w["tmp"]), w["caption"][1], "caption"),
            "--work_dir", str(w["tmp"] / "caption_work"), "--device",
            "cpu"]),
        "recognition_train.main": lambda w: recognition_train.main([
            write_train_config(str(w["tmp"]), w["caption"][1],
                               "recognition"),
            "--work_dir", str(w["tmp"] / "recognition_work"), "--device",
            "cpu"]),
        "recognition_test.main": lambda w: recognition_test.main([
            write_train_config(str(w["tmp"]), w["caption"][1],
                               "recognition"),
            "--checkpoint", str(w["detector"][0] / "rec"), "--device",
            "cpu"]),
        "recognition_test.main[cnn]": lambda w: _cnn_recognition_test(
            w["caption"][1], w["tmp"]),
        "recognition_train.main[multigrid]": lambda w: _recipe_train(
            w, "multigrid = dict(base_batch=2, buckets=[[2, 8, 32]], "
               "final_epochs=1)\n"),
        "recognition_train.main[omnisource]": lambda w: _recipe_train(
            w, "omnisource = dict(train_ratio=[2])\n"),
        "yolo_val.main": lambda w: yolo_val.main([
            str(w["detector"][0] / "cfg.py"), "--checkpoint",
            str(w["detector"][0] / "best"), "--device", "cpu"]),
        "ctv_build.main": lambda w: _ctv_build(w["detector"], w["tmp"]),
        "yolo_train.main": lambda w: _yolo_train(w["detector"], w["tmp"]),
        "yolo_cls_train.main": lambda w: _yolo_train(w["detector"], w["tmp"],
                                                     classify=True),
        "localization_train.main": lambda w: _localization_train(w["tmp"]),
        "detection_train.main": lambda w: _detection(w["tmp"],
                                                     "detection_train"),
        "detection_test.main": lambda w: _detection(w["tmp"],
                                                    "detection_test"),
        "ava_proposals.main": lambda w: _detection(w["tmp"],
                                                   "ava_proposals"),
        "dump_features.main": lambda w: dump_features.main([
            write_train_config(str(w["tmp"]), w["caption"][1],
                               "recognition"),
            "--checkpoint", str(w["detector"][0] / "rec"), "--layers", "0",
            "--mode", "both", "--out", str(w["tmp"] / "feats.pkl"),
            "--device", "cpu"]),
        "skeleton_train.main": lambda w: _skeleton(w["tmp"]),
    }


def _skeleton(tmp):
    """One epoch of the ST-GCN recipe on test_skeleton_train_cli's
    fixture."""
    from cross_modal_video_engine_tpu_torch.cli import skeleton_train
    from test_skeleton_train_cli import _cfg, _pose_fixture
    cfg = _cfg(tmp, _pose_fixture(tmp, n=4),
               "dict(backbone=dict(type='STGCN', num_joints=17, "
               "channels=[8, 8], temporal_strides=[1, 2]), num_classes=2)",
               epochs=1)
    skeleton_train.main([cfg, "--work_dir", str(tmp / "skeleton"),
                         "--device", "cpu"])


ENTRY_POINTS = ["restore_dual_encoding", "retrieval_inference.main",
                "retrieval_tester.main", "retrieval_trainer",
                "build_retrieval_handler", "load_clip_tower",
                "build_composed_handler", "init_recognizer",
                "caption_inference.main", "caption_test.main",
                "build_caption_handler", "caption_train.main",
                "recognition_train.main", "yolo_val.main", "ctv_build.main",
                "yolo_train.main", "yolo_cls_train.main",
                "recognition_test.main", "recognition_test.main[cnn]",
                "recognition_train.main[multigrid]",
                "recognition_train.main[omnisource]",
                "localization_train.main", "detection_train.main",
                "detection_test.main", "ava_proposals.main",
                "dump_features.main", "skeleton_train.main"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_f32_entry_points_turn_tf32_off(entry, world, linas, composed,
                                        detector, tmp_path, monkeypatch,
                                        capsys):
    """With both TF32 flags set (torch's cuDNN default, and a caller's
    matmul setting), each entry point leaves them off, so its f32 convs,
    GRUs and products run in f32 on the card.  The flags are restored."""
    monkeypatch.setattr(tci, "DEFAULT_PIPELINE", PIPE)
    from cross_modal_video_engine_tpu_torch.cli import serve  # noqa: F401
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        _entry_points()[entry]({"linas": linas, "composed": composed,
                                "caption": world, "detector": detector,
                                "tmp": tmp_path})
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    capsys.readouterr()

"""The port's convert_checkpoint CLI against the JAX CLI, for all 20
types, on tiny reference-grammar checkpoints on the CPU.

Each case writes one `.pth` (the port model's state dict drawn from a
numpy seed, in the reference grammar: mmaction's, OpenAI's, ultralytics',
LINAS's list of per-tower state dicts with its pickled `opt`) under the
wrapper key the JAX arm reads, runs both CLIs on it with the same
arguments, and holds the two directories to each other: `params.msgpack`
byte for byte (the same tree, leaf for leaf, with bit-equal arrays and
dtypes: both packages write flax's msgpack of the sorted tree) and
`config.json` equal.  The alternative grammars are cases of their own:
TSM's torchvision layout and `conv1.conv.net` nesting, VideoMAE's
original layout with its `head`, its `module` / `model` / `state_dict`
wrappers and a backbone alone, X3D's bias-free fc1, a ResNet3D's
non-local blocks, backbone-only checkpoints of each family that has a
head, YOLOv5 detect and segment weights.  TSM's non-local weights and an
unknown type are refused by both.  `--device cpu` builds the port's
models here; the card is the default.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from cross_modal_video_engine_tpu.cli import convert_checkpoint as jcli
from cross_modal_video_engine_tpu_torch.cli import convert_checkpoint as tcli
from cross_modal_video_engine_tpu_torch.convert import from_jax
from cross_modal_video_engine_tpu_torch.models import (backbones2d, clip,
                                                       clip_resnet, combiner,
                                                       dual_encoding,
                                                       recognizer, resnet3d,
                                                       stgcn, tanet,
                                                       timesformer,
                                                       tin_mobilenet,
                                                       videomae_vit, yolo)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_own_rng():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.random.fork_rng(devices=[]):
        yield
    torch.set_num_threads(threads)


def seeded(model: torch.nn.Module, seed: int = 3) -> dict:
    """The model's state dict with every float entry drawn from a numpy
    seed (the graph and anchors buffers kept)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        if not v.is_floating_point() or k.endswith((".A", "anchors")):
            out[k] = v.clone()
            continue
        a = (0.5 + rng.random(tuple(v.shape)) if k.endswith("running_var")
             else 0.1 * rng.standard_normal(tuple(v.shape)))
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


def prefixed(sd: dict, prefix: str = "backbone.") -> dict:
    return {prefix + k: v for k, v in sd.items()}


def run_both(tmp_path, kind: str, ckpt, config=None, extra=()):
    """Both CLIs on one .pth; returns (port dir, JAX dir)."""
    src = str(tmp_path / "src.pth")
    torch.save(ckpt, src)
    args = ["--type", kind, "--src", src] + list(extra)
    if config is not None:
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps(config))
        args += ["--config", str(path)]
    port, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    tcli.main(args + ["--dst", port, "--device", "cpu"])
    jcli.main(args + ["--dst", jax_dir])
    return port, jax_dir


def assert_same_dirs(port, jax_dir):
    with open(os.path.join(port, "params.msgpack"), "rb") as f:
        a = f.read()
    with open(os.path.join(jax_dir, "params.msgpack"), "rb") as f:
        b = f.read()
    if a != b:          # name the first leaf that differs
        from cross_modal_video_engine_tpu_torch.io import flax_msgpack

        def flat(t, pre=""):
            if not isinstance(t, dict):
                return {pre: t}
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{pre}/{k}").items()}

        ta, tb = (flat(flax_msgpack.restore(x)) for x in (a, b))
        assert set(ta) == set(tb), sorted(set(ta) ^ set(tb))[:8]
        for k in ta:
            x, y = ta[k], tb[k]
            assert x.dtype == y.dtype and torch.equal(x, y), k
        raise AssertionError("params.msgpack differ")
    with open(os.path.join(port, "config.json")) as f:
        ca = json.load(f)
    with open(os.path.join(jax_dir, "config.json")) as f:
        cb = json.load(f)
    assert ca == cb


# -- the CNN families: (--type, module, backbone, config class, config,
# the head kind: 'fc_cls' | 'x3d' | None)
CNN = {
    "resnet3d": (resnet3d, "ResNet3D", "ResNet3DConfig",
                 dict(stage_blocks=[1, 1, 1, 1], base_channels=8,
                      conv1_kernel_t=5, stage_temporal_kernels=[3, 3, 3, 3])),
    "slowfast": (resnet3d, "SlowFast", "SlowFastConfig",
                 dict(depth_blocks=[1, 1, 1, 1], base_channels=8, alpha=4,
                      beta_inv=4)),
    "x3d": (resnet3d, "X3D", "X3DConfig",
            dict(stage_blocks=[1, 2, 1, 1], stage_channels=[8, 16, 24, 32],
                 feat_dim=48)),
    "csn": (resnet3d, "CSN", "CSNConfig",
            dict(stage_blocks=[1, 1, 1, 1], base_channels=8, mode="ip")),
    "tsm": (backbones2d, "TSMResNet", "TSMConfig",
            dict(stage_blocks=[1, 1, 1, 1], base_channels=8)),
    "tin": (tin_mobilenet, "TINResNetExact", "TINExactConfig",
            dict(stage_blocks=[1, 1, 1, 1], base_channels=8)),
    "r2plus1d": (backbones2d, "R2Plus1D", "R2Plus1DConfig",
                 dict(stage_blocks=[1, 1, 1, 1], base_channels=8)),
    "mobilenetv2_tsm": (tin_mobilenet, "MobileNetV2TSM",
                        "MobileNetV2TSMConfig",
                        dict(stages=[[1, 8, 1, 1], [6, 16, 2, 2]],
                             last_channels=32)),
    "tanet": (tanet, "TANet", "TANetConfig",
              dict(stage_blocks=[1, 1, 1, 1], base_channels=8)),
}


def cnn_checkpoint(kind: str, head: bool, **cfg_over):
    mod, cls, cfg_cls, kw = CNN[kind]
    kw = dict(kw, **cfg_over)
    cfg_kw = {k: (tuple(tuple(s) for s in v) if k == "stages" else
                  tuple(v) if isinstance(v, list) else v)
              for k, v in kw.items()}
    backbone = getattr(mod, cls)(getattr(mod, cfg_cls)(**cfg_kw),
                                 device="cpu")
    model = backbone
    if head:
        model = tcli._wrap(kind, backbone, {
            "cls_head.fc_cls.weight": torch.zeros(5, 1),
            "cls_head.fc1.weight": torch.zeros(16, 1),
            "cls_head.fc2.weight": torch.zeros(5, 1)})
    sd = seeded(model)
    if not head:
        sd = prefixed(sd)
    return sd, {"backbone": kw, "num_classes": 5 if head else None}


@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("kind", list(CNN))
def test_cnn_families(tmp_path, kind, head):
    sd, config = cnn_checkpoint(kind, head)
    assert_same_dirs(*run_both(tmp_path, kind, {"state_dict": sd}, config))


def test_resnet3d_non_local_blocks_found_by_their_keys(tmp_path):
    """The config names no non-local block; the checkpoint carries one,
    which both packages import."""
    sd, config = cnn_checkpoint("resnet3d", True,
                                non_local=[[0], [1], [0], [0]])
    config["backbone"].pop("non_local")
    assert any(".non_local_block." in k for k in sd)
    assert_same_dirs(*run_both(tmp_path, "resnet3d", sd, config))


def test_x3d_head_without_fc1_bias(tmp_path):
    sd, config = cnn_checkpoint("x3d", True)
    del sd["cls_head.fc1.bias"]
    assert_same_dirs(*run_both(tmp_path, "x3d", sd, config))


def torchvision_layout(sd: dict) -> dict:
    """mmaction's ConvModule keys of a ResNet as torchvision names them."""
    import re
    out = {}
    for k, v in sd.items():
        k = re.sub(r"conv1\.conv\.weight$", "conv1.weight", k) \
            if k.startswith("backbone.conv1.") else k
        k = re.sub(r"^backbone\.conv1\.bn\.", "backbone.bn1.", k)
        k = re.sub(r"(layer\d+\.\d+)\.conv(\d)\.conv\.weight$",
                   r"\1.conv\2.weight", k)
        k = re.sub(r"(layer\d+\.\d+)\.conv(\d)\.bn\.", r"\1.bn\2.", k)
        k = k.replace("downsample.conv.", "downsample.0.")
        k = k.replace("downsample.bn.", "downsample.1.")
        out[k] = v
    return out


@pytest.mark.parametrize("grammar", ["torchvision", "shift_net"])
def test_tsm_other_grammars(tmp_path, grammar):
    sd, config = cnn_checkpoint("tsm", True)
    if grammar == "torchvision":
        sd = torchvision_layout(sd)
        sd["backbone.fc.weight"] = torch.zeros(3, 4)   # an ImageNet head
        assert "backbone.bn1.weight" in sd
    else:
        sd = {k.replace("layer1.0.conv1.conv.weight",
                        "layer1.0.conv1.conv.net.weight"): v
              for k, v in sd.items()}
    assert_same_dirs(*run_both(tmp_path, "tsm", {"state_dict": sd}, config))


def test_tsm_non_local_weights_are_refused_by_both(tmp_path):
    sd, config = cnn_checkpoint("tsm", True)
    sd["backbone.layer1.0.non_local_block.g.conv.weight"] = torch.zeros(1)
    src = str(tmp_path / "src.pth")
    torch.save(sd, src)
    (tmp_path / "cfg.json").write_text(json.dumps(config))
    args = ["--type", "tsm", "--src", src, "--config",
            str(tmp_path / "cfg.json")]
    msgs = []
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(ValueError) as info:
            main(args + ["--dst", str(tmp_path / "d")] + extra)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_c3d(tmp_path):
    model = backbones2d.C3D(fc_dim=16, exact_head=True, device="cpu")
    sd = prefixed(seeded(model))
    assert_same_dirs(*run_both(tmp_path, "c3d", sd))


# -- the graph families ------------------------------------------------------------

@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("kind", ["stgcn", "agcn"])
def test_graph_families(tmp_path, kind, head):
    cfg = (stgcn.STGCNConfig if kind == "stgcn" else stgcn.AGCNConfig)(
        num_joints=25, layout="ntu-rgb+d", channels=(8, 16, 16),
        temporal_strides=(1, 2, 1))
    backbone = (stgcn.STGCN if kind == "stgcn" else stgcn.AGCN)(
        cfg, device="cpu")
    sd = (seeded(stgcn.SkeletonClassifier(backbone, 4)) if head
          else prefixed(seeded(backbone)))
    assert_same_dirs(*run_both(tmp_path, kind, {"state_dict": sd}))


# -- the transformers ----------------------------------------------------------------

TS = dict(num_frames=2, img_size=16, patch_size=8, embed_dims=16, num_heads=2,
          num_layers=2)


@pytest.mark.parametrize("head", [True, False])
def test_timesformer(tmp_path, head):
    cfg = timesformer.TimeSformerConfig(**TS)
    model = recognizer.Recognizer3D(cfg, 4, device="cpu")
    sd = seeded(model)
    if not head:
        sd = {k: v for k, v in sd.items() if k.startswith("backbone.")}
    config = {"backbone": TS, "num_classes": 4}
    assert_same_dirs(*run_both(tmp_path, "timesformer", sd, config))


MAE = dict(num_frames=4, img_size=16, patch_size=8, tubelet_size=2,
           embed_dims=16, num_heads=2, num_layers=2)


@pytest.mark.parametrize("layout", ["original", "module", "model",
                                    "mmaction", "backbone_only"])
def test_videomae_grammars(tmp_path, layout):
    backbone = videomae_vit.VideoMAEViT(videomae_vit.VideoMAEConfig(**MAE),
                                        device="cpu")
    sd = seeded(recognizer.BackboneClassifier(backbone, 4))
    if layout == "mmaction":
        ckpt = {"state_dict": sd}
    else:
        top = {k[len("backbone."):]: v for k, v in sd.items()
               if k.startswith("backbone.")}
        if layout != "backbone_only":
            top["head.weight"] = sd["cls_head.fc_cls.weight"]
            top["head.bias"] = sd["cls_head.fc_cls.bias"]
        ckpt = {layout: top} if layout in ("module", "model") else top
    config = {"num_frames": 4, "img_size": 16, "num_heads": 2}
    assert_same_dirs(*run_both(tmp_path, "videomae", ckpt, config))


# -- CLIP, the composed-retrieval towers, LINAS, YOLO ---------------------------------

CLIP_TINY = dict(embed_dim=16, image_resolution=32, vision_width=32,
                 vision_layers=2, vision_heads=2, patch_size=16,
                 context_length=8, vocab_size=64, text_width=16,
                 text_heads=2, text_layers=1)


@pytest.mark.parametrize("wrapper", [False, True])
def test_clip(tmp_path, wrapper):
    sd = clip.random_state_dict(clip.CLIPConfig(**CLIP_TINY), seed=2)
    sd.update(input_resolution=torch.tensor(32),
              context_length=torch.tensor(8), vocab_size=torch.tensor(64))
    ckpt = {"state_dict": sd} if wrapper else sd
    assert_same_dirs(*run_both(tmp_path, "clip", ckpt, CLIP_TINY))


def test_clip_resnet(tmp_path):
    cfg = clip_resnet.CLIPResNetConfig(
        embed_dim=16, vision_layers=(1, 1, 1, 1), vision_width=8,
        image_resolution=64, context_length=8, vocab_size=64, text_width=64,
        text_heads=1, text_layers=1)
    sd = clip_resnet.random_state_dict(cfg, seed=4)
    assert_same_dirs(*run_both(tmp_path, "clip_resnet", sd,
                               {"middle_stage": 2}))


@pytest.mark.parametrize("key", ["Combiner", "state_dict"])
def test_combiner(tmp_path, key):
    cfg = combiner.CombinerConfig(clip_feature_dim=16, projection_dim=32,
                                  hidden_dim=64, n_heads=2,
                                  middle_mix="conv4x4")
    sd = combiner.random_state_dict(cfg, seed=5)
    assert_same_dirs(*run_both(tmp_path, "combiner", {key: sd}))


LINAS_OPT = dict(visual_feat_dim=12, visual_rnn_size=8, visual_kernel_num=4,
                 visual_kernel_sizes="2-3", vocab_size=30, bow_vocab_size=20,
                 word_dim=6, text_rnn_size=8, text_kernel_num=4,
                 text_kernel_sizes="2-3", hidden_size=8,
                 visual_mapping_layers="0-16", dropout=0.2)


@pytest.mark.parametrize("style", ["distill_from_best_model", "GT"])
def test_linas(tmp_path, style):
    opt = argparse.Namespace(style=style, **LINAS_OPT)
    cfg = tcli.linas_config_from_opt(opt)
    sd = dual_encoding.seeded_state_dict(cfg, seed=6)
    ckpt = {"model": from_jax.reference_state_dicts(sd), "opt": opt,
            "epoch": 3, "best_rsum": 1.5}
    assert_same_dirs(*run_both(tmp_path, "linas", ckpt))


def test_linas_config_json(tmp_path):
    cfg = tcli.linas_config_from_opt(argparse.Namespace(**LINAS_OPT))
    sd = dual_encoding.seeded_state_dict(cfg, seed=7)
    import dataclasses
    blob = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}
    ckpt = {"model": from_jax.reference_state_dicts(sd),
            "opt": argparse.Namespace()}
    assert_same_dirs(*run_both(tmp_path, "linas", ckpt, blob))


@pytest.mark.parametrize("masks", [0, 4])
def test_yolov5(tmp_path, masks):
    cfg = yolo.YoloConfig(num_classes=3, depth_multiple=0.33,
                          width_multiple=0.125, img_size=64, masks=masks,
                          protos=16 if masks else 0)
    sd = yolo.random_state_dict(cfg, seed=8)
    assert_same_dirs(*run_both(tmp_path, "yolov5", {"model": sd}))


def test_yolov5_cls(tmp_path):
    cfg = yolo.YoloConfig(num_classes=4, depth_multiple=0.33,
                          width_multiple=0.125, img_size=32)
    sd = yolo.random_state_dict(cfg, seed=9, classifier=True)
    assert_same_dirs(*run_both(tmp_path, "yolov5_cls", sd))


def test_every_type_is_ported_and_unknown_types_are_refused(tmp_path):
    import inspect
    import re
    choices = re.search(r"choices=\[(.*?)\]", inspect.getsource(jcli.main),
                        re.S).group(1)
    assert tuple(re.findall(r'"(\w+)"', choices)) == tcli.TYPES
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit):
            main(["--type", "nope", "--src", "x", "--dst",
                  str(tmp_path / "d")] + extra)

"""Torch checkpoint -> checkpoint in the JAX package's format.

Counterpart of cross_modal_video_engine_tpu/cli/convert_checkpoint.py,
with its 20 types and arguments:

  python -m cross_modal_video_engine_tpu_torch.cli.convert_checkpoint \\
      --type TYPE --src model.pth --dst ckpt_dir [--config config.json] \\
      [--device cpu]

The `.pth` is read with `torch.load(map_location="cpu",
weights_only=False)`, the state dict taken from the wrapper keys the JAX
arm reads, and the config derived as the JAX arm derives it (the port's
own copies of `linas_config_from_opt`, `clip_resnet_config_from_sd`,
`combiner_config_from_sd`, `yolo_config_from_torch`,
`yolo_cls_config_from_torch`, `videomae_config_from_sd` and the ST-GCN /
AGCN graph and stride inference).  The reference state dict is mapped to
the port model's canonical keys where the JAX importer accepts another
grammar (TSM's torchvision layout and `conv1.conv.net` nesting, VideoMAE's
original layout with its `head`, X3D's bias-free fc1, LINAS's list of
per-tower state dicts, a backbone without its head, a ResNet3D's
non-local blocks found by their keys), then loaded strictly into the
port's model, built on `--device` (the card by default).  The directory
is written through the port's `*_to_jax` converters and
`train/checkpoint.save_checkpoint`, with the config blob and meta of the
JAX arm: the same tree, leaf for leaf, and the same config.json.
Unknown types are refused as argparse refuses them.

Types: linas, clip, clip_resnet, combiner, timesformer, yolov5,
yolov5_cls, resnet3d, slowfast, videomae, x3d, csn, tsm, tin, c3d,
r2plus1d, mobilenetv2_tsm, stgcn, agcn, tanet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import from_jax
from ..train.checkpoint import save_checkpoint
from ..utils.device import resolve_device

TYPES = ("linas", "clip", "clip_resnet", "combiner", "timesformer",
         "yolov5", "yolov5_cls", "resnet3d", "slowfast", "videomae", "x3d",
         "csn", "tsm", "tin", "c3d", "r2plus1d", "mobilenetv2_tsm", "stgcn",
         "agcn", "tanet")


def _np(t) -> np.ndarray:
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def _parse_sizes(s):
    return tuple(int(x) for x in str(s).split("-"))


def _read_json(path: Optional[str]) -> Dict:
    if not path:
        return {}
    with open(path) as f:
        return json.load(f)


def _state_dict(obj):
    """An nn.Module's state dict, or the dict itself."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


# -- the config derivations (copies of the JAX package's) ----------------------

def linas_config_from_opt(opt):
    """The reference argparse namespace embedded in a LINAS checkpoint ->
    DualEncodingConfig (JAX cli/convert_checkpoint.py)."""
    from ..models.dual_encoding import DualEncodingConfig

    def g(k, d=None):
        return getattr(opt, k, d)

    return DualEncodingConfig(
        visual_feat_dim=g("visual_feat_dim", 2048),
        visual_rnn_size=g("visual_rnn_size", 512),
        visual_kernel_num=g("visual_kernel_num", 512),
        visual_kernel_sizes=_parse_sizes(g("visual_kernel_sizes", "2-3-4-5")),
        vocab_size=g("vocab_size", 7807),
        bow_vocab_size=g("bow_vocab_size", 7183),
        word_dim=g("word_dim", 500),
        text_rnn_size=g("text_rnn_size", 512),
        text_kernel_num=g("text_kernel_num", 512),
        text_kernel_sizes=_parse_sizes(g("text_kernel_sizes", "2-3-4")),
        hidden_size=g("hidden_size", 1024),
        common_dim=_parse_sizes(g("visual_mapping_layers", "0-1536"))[-1],
        text_resblock_number=g("text_resblock_number", 0),
        dropout=g("dropout", 0.2),
        concate=g("concate", "full"),
        gru_pool=g("gru_pool", "mean"),
        style=g("style", "distill_from_best_model"),
        teacher_model=g("teacher_model", "GT"),
        student_model=g("student_model", "de+map"),
    )


def clip_resnet_config_from_sd(sd: Dict) -> Dict[str, Any]:
    """CLIPResNetConfig keywords read off an OpenAI CLIP-RN state dict's
    shapes (the reference clip.load's build_model)."""
    def n_blocks(layer):
        i = 0
        while f"visual.layer{layer}.{i}.conv1.weight" in sd:
            i += 1
        return i

    width = int(sd["visual.conv1.weight"].shape[0]) * 2
    text_width = int(_np(sd["ln_final.weight"]).shape[0])
    t = 0
    while f"transformer.resblocks.{t}.ln_1.weight" in sd:
        t += 1
    spatial = int(round(
        (_np(sd["visual.attnpool.positional_embedding"]).shape[0] - 1)
        ** 0.5))
    return dict(
        embed_dim=int(_np(sd["text_projection"]).shape[1]),
        vision_layers=tuple(n_blocks(i) for i in (1, 2, 3, 4)),
        vision_width=width,
        image_resolution=spatial * 32,
        context_length=int(_np(sd["positional_embedding"]).shape[0]),
        vocab_size=int(_np(sd["token_embedding.weight"]).shape[0]),
        text_width=text_width,
        text_heads=text_width // 64,
        text_layers=t,
    )


def combiner_config_from_sd(sd: Dict) -> Dict[str, Any]:
    return dict(
        clip_feature_dim=int(_np(sd["output_layer.weight"]).shape[0]),
        projection_dim=int(_np(sd["text_projection_layer.weight"]).shape[0]),
        hidden_dim=int(_np(sd["combiner_layer.weight"]).shape[0]),
        middle_mix="conv4x4",
    )


def _count(sd: Dict, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def yolo_config_from_torch(model_or_sd):
    """(DetectionModel | state dict) -> (YoloConfig, flat state dict): nc,
    multiples and anchors from the shapes (and the model's yaml when it
    has one), nm / npr from a Segment head's proto convs, the anchors
    from grid units back to pixels."""
    from ..models.yolo import YoloConfig
    if hasattr(model_or_sd, "state_dict"):
        m = model_or_sd.float()
        sd = dict(m.state_dict())
        yaml = dict(getattr(m, "yaml", {}) or {})
    else:
        sd, yaml = dict(model_or_sd), {}
    det = max(int(k.split(".")[1]) for k in sd
              if k.startswith("model.") and k.endswith(".anchors"))
    no = int(_np(sd[f"model.{det}.m.0.weight"]).shape[0])
    nm = npr = 0
    if f"model.{det}.proto.cv3.conv.weight" in sd:
        nm = int(_np(sd[f"model.{det}.proto.cv3.conv.weight"]).shape[0])
        npr = int(_np(sd[f"model.{det}.proto.cv1.conv.weight"]).shape[0])
    nc = yaml.get("nc", no // 3 - 5 - nm)
    wm = float(yaml.get("width_multiple",
                        _np(sd["model.0.conv.weight"]).shape[0] / 64.0))
    dm = float(yaml.get("depth_multiple",
                        _count(sd, "model.2.m.{}.cv1.conv.weight") / 3.0))
    anch = _np(sd[f"model.{det}.anchors"]).astype(np.float64)
    anchors = tuple(
        tuple(tuple(float(v) for v in a) for a in anch[i] * s)
        for i, s in enumerate((8, 16, 32)))
    return YoloConfig(num_classes=int(nc), depth_multiple=dm,
                      width_multiple=wm, anchors=anchors, masks=nm,
                      protos=npr), sd


def yolo_cls_config_from_torch(model_or_sd):
    """(ClassificationModel | state dict) -> (YoloConfig, state dict)."""
    from ..models.yolo import YoloConfig
    sd = dict(model_or_sd.float().state_dict()
              if hasattr(model_or_sd, "state_dict") else model_or_sd)
    return YoloConfig(
        num_classes=int(_np(sd["model.9.linear.weight"]).shape[0]),
        depth_multiple=_count(sd, "model.2.m.{}.cv1.conv.weight") / 3.0,
        width_multiple=float(_np(sd["model.0.conv.weight"]).shape[0]
                             / 64.0)), sd


def graph_config_from_sd(sd: Dict, family: str, p: str = "backbone."):
    """The ST-GCN or AGCN config of a reference checkpoint: the graph
    from the buffer `A` (swapped to A[k, target, source] for ST-GCN, as
    it is for AGCN), the blocks counted, the widths from their temporal
    convs, stride 2 where the width changes, the input channels from
    block 0."""
    from ..models.stgcn import AGCNConfig, STGCNConfig
    A = _np(sd[p + "A"])
    stgcn = family == "stgcn"
    net = "st_gcn_networks" if stgcn else "agcn_networks"
    first = "gcn.conv.weight" if stgcn else "gcn.PA"
    n = _count(sd, p + net + ".{}." + first)
    tcn = "tcn.2.weight" if stgcn else "tcn.0.weight"
    channels = tuple(int(_np(sd[f"{p}{net}.{i}.{tcn}"]).shape[0])
                     for i in range(n))
    strides = tuple(2 if i > 0 and channels[i] != channels[i - 1] else 1
                    for i in range(n))
    graph = np.swapaxes(A, 1, 2) if stgcn else A
    stem = "gcn.conv.weight" if stgcn else "gcn.conv_d.0.weight"
    cls = STGCNConfig if stgcn else AGCNConfig
    return cls(num_joints=int(A.shape[1]),
               in_channels=int(_np(sd[f"{p}{net}.0.{stem}"]).shape[1]),
               channels=channels, temporal_strides=strides,
               adjacency=tuple(tuple(tuple(float(v) for v in row)
                                     for row in sub) for sub in graph))


# -- loading into the port's models ------------------------------------------------

def _load_strict(model: torch.nn.Module, sd: Dict[str, Any]) -> None:
    """sd into the model, every key matched both ways; the BatchNorms'
    `num_batches_tracked` (which no JAX importer reads) taken as 0 where
    the checkpoint has none."""
    own = model.state_dict()
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    for k, v in own.items():
        if k.endswith("num_batches_tracked") and k not in sd:
            sd[k] = torch.zeros_like(v, device="cpu")
    model.load_state_dict(sd, strict=True)


def _split(sd: Dict, prefix: str = "backbone.",
           head: str = "cls_head.") -> Tuple[Dict, Dict]:
    """(the backbone's keys without the prefix, the head's keys as they
    are); every other key (a torchvision fc, a data preprocessor) is left
    out, as the JAX importers leave it."""
    bb = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    hd = {k: v for k, v in sd.items() if k.startswith(head)}
    return bb, hd


def _tsm_canonical(bb: Dict) -> Dict:
    """TSM's other grammars mapped to mmaction's ConvModule keys:
    torchvision's (conv1 / bn1 / layer*.convK / bnK / downsample.{0,1},
    its `fc` classifier left out as the importer leaves it) and the shift
    wrapper's conv*.conv.net nesting.  Non-local weights
    are refused, as the JAX importer refuses them."""
    if any(".non_local_block." in k for k in bb):
        raise ValueError(
            "TSM checkpoint carries non_local_block weights (a *_nl "
            "config); TSMResNet has no non-local support yet — refusing "
            "to import a numerically different backbone silently")
    out = {}
    torchvision = "conv1.weight" in bb
    for k, v in bb.items():
        if torchvision and k.startswith("fc."):    # its ImageNet classifier
            continue
        if torchvision:
            k = re.sub(r"^conv1\.weight$", "conv1.conv.weight", k)
            k = re.sub(r"^bn1\.", "conv1.bn.", k)
            k = re.sub(r"(layer\d+\.\d+)\.conv(\d)\.weight$",
                       r"\1.conv\2.conv.weight", k)
            k = re.sub(r"(layer\d+\.\d+)\.bn(\d)\.", r"\1.conv\2.bn.", k)
            k = re.sub(r"downsample\.0\.", "downsample.conv.", k)
            k = re.sub(r"downsample\.1\.", "downsample.bn.", k)
        else:
            k = k.replace(".conv.net.weight", ".conv.weight")
        out[k] = v
    return out


# the CNN families: --type -> (module, backbone class, config class)
CNN_TYPES = {
    "resnet3d": ("resnet3d", "ResNet3D", "ResNet3DConfig"),
    "slowfast": ("resnet3d", "SlowFast", "SlowFastConfig"),
    "x3d": ("resnet3d", "X3D", "X3DConfig"),
    "csn": ("resnet3d", "CSN", "CSNConfig"),
    "tsm": ("backbones2d", "TSMResNet", "TSMConfig"),
    "tin": ("tin_mobilenet", "TINResNetExact", "TINExactConfig"),
    "r2plus1d": ("backbones2d", "R2Plus1D", "R2Plus1DConfig"),
    "mobilenetv2_tsm": ("tin_mobilenet", "MobileNetV2TSM",
                        "MobileNetV2TSMConfig"),
    "tanet": ("tanet", "TANet", "TANetConfig"),
}


def _non_local_flags(bb: Dict, cfg):
    """A ResNet3D config whose non-local flags follow the blocks that
    carry non_local_block weights (the JAX importer reads them by their
    keys, whatever the config says)."""
    flags = tuple(
        tuple(int(any(k.startswith(f"layer{s}.{j}.non_local_block.")
                      for k in bb)) for j in range(blocks))
        for s, blocks in enumerate(cfg.stage_blocks, start=1))
    if not any(any(f) for f in flags):
        return cfg
    return dataclasses.replace(cfg, non_local=flags)


def _cnn_arm(kind: str, sd: Dict, blob: Dict, dev):
    import importlib
    mod_name, cls_name, cfg_name = CNN_TYPES[kind] if kind != "c3d" else (
        "backbones2d", "C3D", None)
    mod = importlib.import_module(f"..models.{mod_name}", __package__)
    bb, head = _split(sd)
    if kind == "c3d":
        backbone = mod.C3D(fc_dim=bb["fc6.weight"].shape[0],
                           exact_head=True, device=dev)
    else:
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in blob.get("backbone", {}).items()}
        if kind == "mobilenetv2_tsm":
            kw = {k: tuple(tuple(s) for s in v) if k == "stages" else v
                  for k, v in blob.get("backbone", {}).items()}
        cfg = getattr(mod, cfg_name)(**kw)
        if kind == "tsm":
            bb = _tsm_canonical(bb)
        if kind == "resnet3d":
            cfg = _non_local_flags(bb, cfg)
        backbone = getattr(mod, cls_name)(cfg, device=dev)
    if kind == "x3d" and "cls_head.fc1.weight" in head:
        # X3DHead's fc1 has no bias in mmaction's x3d configs: zero
        head.setdefault("cls_head.fc1.bias", torch.zeros(
            head["cls_head.fc1.weight"].shape[0]))
    head_key = "cls_head.fc1.weight" if kind == "x3d" else \
        "cls_head.fc_cls.weight"
    model = backbone
    if head_key in head:
        model = _wrap(kind, backbone, head)
        bb = {"backbone." + k: v for k, v in bb.items()}
        bb.update(head)
    _load_strict(model, bb)
    return from_jax.conv_recognizer_variables_to_jax(model.state_dict(),
                                                     model)


def _wrap(kind: str, backbone, head: Dict):
    """The recognizer the JAX importer's {backbone, cls_head} tree
    belongs to, sized by the head's weights."""
    from ..models import recognizer
    if kind == "x3d":
        mid, _ = head["cls_head.fc1.weight"].shape
        classes = head["cls_head.fc2.weight"].shape[0]
        return recognizer.X3DClassifier(backbone, classes, mid_channels=mid)
    classes = head["cls_head.fc_cls.weight"].shape[0]
    if kind in ("tsm", "tin", "mobilenetv2_tsm", "tanet"):
        return recognizer.Recognizer2D(backbone, classes)
    return recognizer.BackboneClassifier(backbone, classes)


def _timesformer_arm(sd: Dict, blob: Dict, dev):
    from ..models.recognizer import Recognizer3D
    from ..models.timesformer import TimeSformer, TimeSformerConfig
    cfg = TimeSformerConfig(**blob["backbone"])
    bb, head = _split(sd, head="cls_head.fc_cls.")
    if head:
        model = Recognizer3D(cfg, num_classes=head[
            "cls_head.fc_cls.weight"].shape[0], device=dev)
        _load_strict(model, dict({"backbone." + k: v for k, v in bb.items()},
                                 **head))
        return from_jax.recognizer_variables_to_jax(model.state_dict(), cfg)
    model = TimeSformer(cfg, device=dev)
    _load_strict(model, bb)
    return {"params": {"backbone": from_jax._timesformer_to_jax(
        {"backbone." + k: v for k, v in model.state_dict().items()}, cfg)}}


def _videomae_arm(sd: Dict, blob: Dict, dev):
    from ..models.recognizer import BackboneClassifier
    from ..models.videomae_vit import (VideoMAEConfig, VideoMAEViT,
                                       videomae_config_from_sd)
    kwargs = videomae_config_from_sd(
        sd, num_frames=blob.get("num_frames", 16),
        img_size=blob.get("img_size", 224), num_heads=blob.get("num_heads"))
    fields = {f.name for f in dataclasses.fields(VideoMAEConfig)}
    kwargs.update({k: v for k, v in blob.items()
                   if k in fields
                   and k not in ("num_frames", "img_size", "num_heads")})
    # the original layout at the top level with its `head`, or mmaction's
    # under `backbone.` with `cls_head.fc_cls`
    p = ("backbone." if ("patch_embed.proj.weight" not in sd
                         and "backbone.patch_embed.proj.weight" in sd)
         else "")
    bb = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)
          and k[len(p):].split(".")[0] in ("patch_embed", "blocks",
                                            "fc_norm")}
    if p + "head.weight" in sd:
        head = {"weight": sd[p + "head.weight"], "bias": sd[p + "head.bias"]}
    elif "cls_head.fc_cls.weight" in sd:
        head = {"weight": sd["cls_head.fc_cls.weight"],
                "bias": sd["cls_head.fc_cls.bias"]}
    else:
        head = None
    backbone = VideoMAEViT(VideoMAEConfig(**kwargs), device=dev)
    model = backbone
    if head is not None:
        model = BackboneClassifier(backbone, head["weight"].shape[0])
        bb = {"backbone." + k: v for k, v in bb.items()}
        bb.update({f"cls_head.fc_cls.{k}": v for k, v in head.items()})
    _load_strict(model, bb)
    variables = from_jax.transformer_variables_to_jax(model.state_dict(),
                                                      model)
    return variables, {"backbone": kwargs}


def _graph_arm(kind: str, sd: Dict, dev):
    from ..models.stgcn import AGCN, STGCN, SkeletonClassifier
    cfg = graph_config_from_sd(sd, kind)
    backbone = (STGCN if kind == "stgcn" else AGCN)(cfg, device=dev)
    bb, head = _split(sd, head="cls_head.fc.")
    model = backbone
    if "cls_head.fc.weight" in head:
        model = SkeletonClassifier(backbone,
                                   head["cls_head.fc.weight"].shape[0])
        bb = dict({"backbone." + k: v for k, v in bb.items()}, **head)
    _load_strict(model, bb)
    variables = from_jax.conv_recognizer_variables_to_jax(
        model.state_dict(), model)
    config = {"backbone": {"type": kind.upper(),
                           "num_joints": cfg.num_joints,
                           "in_channels": cfg.in_channels,
                           "channels": list(cfg.channels),
                           "temporal_strides": list(cfg.temporal_strides),
                           "adjacency": [[list(r) for r in s]
                                         for s in cfg.adjacency]}}
    return variables, config


def convert(kind: str, ckpt, src: str, config_path: Optional[str] = None,
            device=None) -> Tuple[Dict, Any, Dict]:
    """(variables, config, meta) of the JAX arm `kind` for the loaded
    checkpoint `ckpt`; the model is built on `device` (None: the card)."""
    dev = resolve_device(device)
    meta = {"source": src}
    blob = _read_json(config_path)
    if kind == "linas":
        from ..models.dual_encoding import DualEncoding, DualEncodingConfig
        cfg = (DualEncodingConfig(**blob) if config_path
               else linas_config_from_opt(ckpt["opt"]))
        sd = {f"{tower}.{k}": v for tower, sub in zip(
            from_jax.REFERENCE_ORDER, ckpt["model"]) if sub
            for k, v in sub.items()}
        model = DualEncoding(cfg, device=dev)
        _load_strict(model, sd)
        variables = from_jax.dual_encoding_variables_to_jax(
            model.state_dict())
        return variables, cfg, {"epoch": ckpt.get("epoch"),
                                "best_rsum": ckpt.get("best_rsum"),
                                "source": src}
    if kind == "timesformer":
        sd = ckpt.get("state_dict", ckpt)
        assert config_path, ("--config json required: TimeSformerConfig "
                             "fields under 'backbone' + 'num_classes'")
        return (_timesformer_arm(sd, blob, dev),
                {"backbone": blob["backbone"],
                 "num_classes": blob["num_classes"]}, meta)
    if kind == "clip_resnet":
        from ..models.clip_resnet import CLIPResNetConfig, CLIPResNetModel
        sd = _state_dict(ckpt.get("state_dict", ckpt))
        cfg = CLIPResNetConfig(**dict(clip_resnet_config_from_sd(sd),
                                      **blob))
        model = CLIPResNetModel(cfg, device=dev)
        _load_strict(model, sd)
        return (from_jax.clip_resnet_variables_to_jax(model.state_dict(),
                                                      cfg), cfg,
                dict(meta, model_type="clip_resnet"))
    if kind == "combiner":
        from ..models.combiner import Combiner, CombinerConfig
        sd = _state_dict(ckpt.get("Combiner", ckpt.get("state_dict", ckpt)))
        cfg = CombinerConfig(**dict(combiner_config_from_sd(sd), **blob))
        model = Combiner(cfg, device=dev)
        _load_strict(model, sd)
        return (from_jax.combiner_variables_to_jax(model.state_dict(), cfg),
                cfg, meta)
    if kind in CNN_TYPES or kind == "c3d":
        sd = ckpt.get("state_dict", ckpt)
        config = ({"backbone": {"type": "C3D", "exact_head": True}}
                  if kind == "c3d" else
                  {"backbone": blob.get("backbone", {}),
                   "num_classes": blob.get("num_classes")})
        return _cnn_arm(kind, sd, blob, dev), config, meta
    if kind == "videomae":
        sd = ckpt.get("module", ckpt.get("model", ckpt.get("state_dict",
                                                           ckpt)))
        variables, config = _videomae_arm(sd, blob, dev)
        return variables, config, meta
    if kind in ("stgcn", "agcn"):
        variables, config = _graph_arm(kind, ckpt.get("state_dict", ckpt),
                                       dev)
        return variables, config, meta
    if kind in ("yolov5", "yolov5_cls"):
        from ..models.yolo import YoloClassifier, YoloV5
        derive = (yolo_config_from_torch if kind == "yolov5"
                  else yolo_cls_config_from_torch)
        cfg, sd = derive(ckpt.get("model", ckpt))
        model = (YoloV5 if kind == "yolov5" else YoloClassifier)(cfg,
                                                                 device=dev)
        _load_strict(model, sd)
        to_jax = (from_jax.yolo_variables_to_jax if kind == "yolov5"
                  else from_jax.yolo_cls_variables_to_jax)
        return to_jax(model.state_dict(), cfg), cfg, meta
    # clip: an OpenAI-layout ViT CLIP
    from ..models.clip import CLIPConfig, CLIPModel
    sd = _state_dict(ckpt.get("state_dict", ckpt))
    assert config_path, "--config (CLIPConfig json) required for clip"
    cfg = CLIPConfig(**blob)
    model = CLIPModel(cfg, device=dev)
    # clip.load's build_model drops these three ints; so do the importers
    _load_strict(model, {k: v for k, v in sd.items() if k not in (
        "input_resolution", "context_length", "vocab_size")})
    return from_jax.clip_variables_to_jax(model.state_dict(), cfg), cfg, meta


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--type", required=True, choices=list(TYPES))
    parser.add_argument("--src", required=True)
    parser.add_argument("--dst", required=True)
    parser.add_argument("--config", default=None,
                        help="json config overriding/replacing embedded opt")
    parser.add_argument("--device", default=None,
                        help="where the model is built; default: the CUDA "
                             "device")
    args = parser.parse_args(argv)
    ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
    variables, config, meta = convert(args.type, ckpt, args.src, args.config,
                                      args.device or device)
    save_checkpoint(args.dst, variables, config, meta)
    print(f"converted {args.type} checkpoint -> {args.dst}")


if __name__ == "__main__":
    main()

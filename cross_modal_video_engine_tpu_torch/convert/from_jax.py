"""JAX package parameters -> the port's state dict.

Each function turns a JAX model's variables, given as numpy arrays, into
the state dict that the port's counterpart loads, so both packages
compute the same function.

* `clip_state_dict_from_jax` is the exact inverse of
  cross_modal_video_engine_tpu.convert.torch_import.convert_clip_vit
  (with its `_resblock`): the OpenAI CLIP layout.
* `recognizer_state_dict_from_jax` covers Recognizer3D and
  Recognizer3DRelseq on a TimeSformer backbone.  A divided space-time
  backbone gets exactly the mmaction keys that `convert_timesformer`
  reads (attention in_proj as `_mha_from_inproj` splits it), and the
  caption head exactly those `convert_rnn_decoder_head` reads, so on
  those the function inverts the importers.  Joint and space-only
  blocks, which no importer reads, get mmcv BaseTransformerLayer's keys
  for the order (norm, self_attn, norm, ffn):
  `transformer_layers.layers.{i}.norms.0`, `.attentions.0.attn`,
  `.norms.1`, `.ffns.0.layers.0.0`, `.ffns.0.layers.1`.  A tubelet
  patch embed is the Conv3d `patch_embed.projection`.  A bf16-configured
  JAX checkpoint gives f32 tensors too: the port's TimeSformer keeps f32
  masters whatever its config says.  The shuffle recognizers hold the
  same tree (`shuffle_recognizer_{state_dict_from,variables_to}_jax`).
* `dual_encoding_state_dict_from_jax` maps a JAX LINAS DualEncoding's
  variables onto the port's state dict, which carries the reference torch
  model's keys under the tower names (convert_linas_dual_encoding's
  input); `dual_encoding_variables_to_jax` is its inverse and
  `reference_state_dicts` splits the port's state dict into the reference
  checkpoint's list of sub state dicts.
* `linas_train_state_to_jax` and `linas_train_state_from_jax` carry the
  LINAS trainer's whole state across: the model's state dict with the
  optimizer's count, learning rate and moments (`OptaxOptimizer.
  named_state`), as the tree the JAX package's TrainState serializes to
  (`{"params", "batch_stats", "opt_state"}`, the optimizer as optax's
  inject_hyperparams(chain(clip_by_global_norm, adam | rmsprop)) state);
  `linas_mask_state_to_jax` and `linas_mask_state_from_jax` do the same
  for the 'adapt' mask (pa with its chain(clip, adam) state).
* `clip_resnet_state_dict_from_jax` inverts convert_clip_resnet (params
  and the BatchNorms' `batch_stats`); `combiner_state_dict_from_jax`
  inverts convert_combiner for middle_mix='conv4x4' and maps the 'dense'
  tree (`m_remained` a Dense) onto the same keys with `m_remained` a
  Linear.  `clip_variables_to_jax`, `clip_resnet_variables_to_jax` and
  `combiner_variables_to_jax` go the other way, so the port writes
  checkpoints the JAX package loads (`train/checkpoint.save_checkpoint`).
* `residual_head_state_dict_from_jax` and `residual_head_variables_to_jax`
  carry the explain stack's concept-bottleneck head (explain/cbm.py)
  both ways.
* `rec_train_state_to_jax` and `rec_train_state_from_jax` carry the
  recognition and caption trainers' state across: the recognizer's state
  dict, the optimizer's count and moments, and the step, as the tree the
  JAX package's RecTrainState serializes to (`{"params", "opt_state",
  "step"}`, the optimizer as `make_rec_optimizer`'s optax chain state).
* `caption_transformer_state_dict_from_jax` and
  `caption_transformer_variables_to_jax` carry the word-level caption
  decoder both ways (its parameters keep their JAX names and layouts);
  `recognizer_caption_state_dict_from_jax` and
  `recognizer_caption_variables_to_jax` do the same for
  Recognizer3DCaption (the TimeSformer backbone plus `caption_head`).
* `{resnet3d,csn,slowfast,x3d}_state_dict_from_jax` and
  `*_variables_to_jax` carry a 3D-CNN backbone's params and batch_stats
  both ways (its config names the tree); `conv_recognizer_state_dict_
  from_jax` and `conv_recognizer_variables_to_jax` do it for any of them
  alone or under BackboneClassifier, X3DClassifier or RecognizerRelseq,
  given the port's model (a meta-device copy will do).  The keys are
  mmaction's, those the convert_{resnet3d,csn,slowfast,x3d} importers
  read, so these invert the importers.  `rec_train_state_{to,from}_jax`
  take such a model in place of the TimeSformer config.  The same
  functions carry the per-frame and light 3D backbones (TSM/TSN,
  TINResNetExact, MobileNetV2-TSM, TANet, C3D, R(2+1)D: the keys the
  convert_{tsm,tin,mobilenetv2_tsm,tanet,c3d,r2plus1d} importers read),
  Recognizer2D with its TSNHead or TRNHead, and TPNRecognizer with the
  TPN neck (convert_tpn's keys), in both directions.  No importer reads
  the plain TIN (`TINResNet`: `interlace{i}.{off_fc1,off_fc2,gate_fc}`
  -> `interlace_{i}`), TRNHead (mmaction's `consensus.classifier.{1,3}`
  -> `relation_fc{1,2}`, `consensus.fc_fusion_scales.{i}.{1,3}` ->
  `fusion_s{S-i}_fc{1,2}`) or TPNRecognizer's `cls_head.fc_cls` (the
  JAX Dense `cls_head`); these functions are their bridge.
* The same functions carry the skeleton models (models/stgcn.py: ST-GCN
  and AGCN alone or under SkeletonClassifier) in the keys convert_stgcn
  and convert_agcn read: a 1x1 Conv2d that is a Dense in JAX (gcn,
  conv_{a,b,d}, down, the head's `cls_head.fc` as `cls_head/fc_cls`) as
  its kernel, the edge masks and PA as they are; the graph buffer is not
  in the tree (the JAX config carries it: with the batch_stats, the state
  dict takes it from the model's config).  `{stgcn,agcn}_*` are the
  per-family forms.
* `transformer_state_dict_from_jax` and `transformer_variables_to_jax`
  carry the transformer and CLIP backbones both ways, alone or under
  BackboneClassifier, RecognizerRelseq or Recognizer3DCLIP (the CNN
  functions route such a model to them): Swin3D in the keys
  convert_swin3d reads, VideoMAEViT in convert_videomae's, a CLIP
  VisionTower's blocks in convert_clip_vit's; MViT and VideoCLIP, which
  no importer reads, in keys that follow the JAX tree.
  `{swin3d,mvit,videomae,videoclip}_*` and `clip_recognizer_*` are the
  per-family forms (a config, or the CLIP config and the class count).
* `yolo_train_state_to_jax` and `yolo_train_state_from_jax` carry the
  detector trainers' YoloTrainState (params, batch_stats, velocity, EMA
  params and statistics, the update count) both ways.
* `yolo_state_dict_from_jax` and `yolo_cls_state_dict_from_jax` invert
  convert_yolov5 and convert_yolov5_cls (the ultralytics layout, the
  anchors buffer in grid units); `yolo_variables_to_jax` and
  `yolo_cls_variables_to_jax` go the other way, so a detector checkpoint
  either package writes loads in the other.
* `{bmn,tem,pem,ssn_head}_state_dict_from_jax` and `*_variables_to_jax`
  carry the localizers (models/{bmn,bsn,ssn}.py) both ways.  Their
  parameters keep the JAX module names: a flax Conv kernel (k..., in/g,
  out) is the torch weight (out, in/g, k...), a Dense kernel (in, out)
  the Linear weight (out, in); no importer reads these families.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    """A numpy array or tensor (any float dtype) as a CPU f32 tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _ln(sd: Dict[str, torch.Tensor], name: str, p: Dict[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(p["ln"]["scale"])
    sd[f"{name}.bias"] = _t(p["ln"]["bias"])


def _linear(sd: Dict[str, torch.Tensor], name: str,
            p: Dict[str, Any]) -> None:
    """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _mha(sd: Dict[str, torch.Tensor], name: str, at: Dict[str, Any]) -> None:
    """q/k/v/out Dense params -> nn.MultiheadAttention's in_proj layout."""
    sd[f"{name}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(at[n]["kernel"]).T
         for n in ("q_proj", "k_proj", "v_proj")], 0))
    sd[f"{name}.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(at[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]))
    _linear(sd, f"{name}.out_proj", at["out_proj"])


def _resblock(sd: Dict[str, torch.Tensor], prefix: str,
              p: Dict[str, Any]) -> None:
    _ln(sd, f"{prefix}.ln_1", p["ln_1"])
    _ln(sd, f"{prefix}.ln_2", p["ln_2"])
    _mha(sd, f"{prefix}.attn", p["attn"])
    _linear(sd, f"{prefix}.mlp.c_fc", p["c_fc"])
    _linear(sd, f"{prefix}.mlp.c_proj", p["c_proj"])


def clip_state_dict_from_jax(variables_np: Dict[str, Any],
                             cfg) -> Dict[str, torch.Tensor]:
    """variables_np: the JAX CLIPModel's variables (with or without the
    top-level "params" key) as numpy arrays.  cfg: a CLIPConfig of either
    package.  Returns an fp32 OpenAI-layout CLIP state dict."""
    params = variables_np.get("params", variables_np)
    vis, txt = params["visual"], params["text"]
    sd: Dict[str, torch.Tensor] = {
        # flax conv kernel (p, p, 3, W) -> torch Conv2d weight (W, 3, p, p)
        "visual.conv1.weight": _t(
            np.asarray(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1)),
        "visual.class_embedding": _t(vis["class_embedding"]),
        "visual.positional_embedding": _t(vis["positional_embedding"]),
        "visual.proj": _t(vis["proj"]),
        "token_embedding.weight": _t(txt["token_embedding"]),
        "positional_embedding": _t(txt["positional_embedding"]),
        "text_projection": _t(txt["text_projection"]),
        "logit_scale": _t(params["logit_scale"]),
    }
    _ln(sd, "visual.ln_pre", vis["ln_pre"])
    _ln(sd, "visual.ln_post", vis["ln_post"])
    _ln(sd, "ln_final", txt["ln_final"])
    for i in range(cfg.vision_layers):
        _resblock(sd, f"visual.transformer.resblocks.{i}",
                  vis["transformer"][f"resblock_{i}"])
    for i in range(cfg.text_layers):
        _resblock(sd, f"transformer.resblocks.{i}",
                  txt["transformer"][f"resblock_{i}"])
    return sd


def _timesformer_block(sd: Dict[str, torch.Tensor], prefix: str,
                       p: Dict[str, Any], divided: bool) -> None:
    if divided:
        _ln(sd, f"{prefix}.attentions.0.norm", p["temporal_norm"])
        _mha(sd, f"{prefix}.attentions.0.attn", p["temporal_attn"])
        _linear(sd, f"{prefix}.attentions.0.temporal_fc", p["temporal_fc"])
        _ln(sd, f"{prefix}.attentions.1.norm", p["spatial_norm"])
        _mha(sd, f"{prefix}.attentions.1.attn", p["spatial_attn"])
        _ln(sd, f"{prefix}.ffns.0.norm", p["ffn_norm"])
    else:
        _ln(sd, f"{prefix}.norms.0", p["norm1"])
        _mha(sd, f"{prefix}.attentions.0.attn", p["attn"])
        _ln(sd, f"{prefix}.norms.1", p["norm2"])
    _linear(sd, f"{prefix}.ffns.0.layers.0.0", p["ffn_fc1"])
    _linear(sd, f"{prefix}.ffns.0.layers.1", p["ffn_fc2"])


def timesformer_state_dict_from_jax(params: Dict[str, Any], cfg,
                                    prefix: str = "backbone."
                                    ) -> Dict[str, torch.Tensor]:
    """The JAX TimeSformer's params (numpy) -> the port's keys under
    `prefix`.  cfg: a TimeSformerConfig of either package."""
    kernel = np.asarray(params["patch_embed"]["kernel"])
    # flax conv kernel (..., 3, D) -> torch (D, 3, ...)
    perm = (4, 3, 0, 1, 2) if kernel.ndim == 5 else (3, 2, 0, 1)
    sd: Dict[str, torch.Tensor] = {
        f"{prefix}patch_embed.projection.weight": _t(kernel.transpose(perm)),
        f"{prefix}patch_embed.projection.bias": _t(
            params["patch_embed"]["bias"]),
    }
    names = ["cls_token", "pos_embed"]
    if cfg.attention_type != "space_only":
        names.append("time_embed")
    for n in names:
        sd[prefix + n] = _t(params[n])
    for i in range(cfg.num_layers):
        _timesformer_block(sd, f"{prefix}transformer_layers.layers.{i}",
                           params[f"block_{i}"],
                           cfg.attention_type == "divided_space_time")
    _ln(sd, f"{prefix}norm", params["norm"])
    return sd


def recognizer_state_dict_from_jax(variables_np: Dict[str, Any],
                                   backbone_cfg) -> Dict[str, torch.Tensor]:
    """A JAX Recognizer3D's or Recognizer3DRelseq's variables (numpy, with
    or without the top-level "params" key) -> the port's fp32 state
    dict."""
    params = variables_np.get("params", variables_np)
    sd = timesformer_state_dict_from_jax(params["backbone"], backbone_cfg)
    head = params["cls_head"]
    if "fc_cls" in head:
        _linear(sd, "cls_head.fc_cls", head["fc_cls"])
        return sd
    _decoder_from_jax(sd, head)
    return sd


_DECODER_RNN = (("weight_ih_l0", "rnn_wi", True),
                ("bias_ih_l0", "rnn_bi", False),
                ("weight_hh_l0", "rnn_wh", True),
                ("bias_hh_l0", "rnn_bh", False))


def _decoder_from_jax(sd: Dict[str, torch.Tensor], head: Dict[str, Any]
                      ) -> None:
    """The JAX RNNDecoderHead's params -> `cls_head.*` (the keys
    convert_rnn_decoder_head reads)."""
    sd["cls_head.start_emb.weight"] = _t(head["start_emb"])
    for torch_name, jax_name, transpose in _DECODER_RNN:
        a = np.asarray(head[jax_name])
        sd[f"cls_head.rnn.{torch_name}"] = _t(a.T if transpose else a)
    sd["cls_head.out.weight"] = _t(np.asarray(head["out_kernel"]).T)
    sd["cls_head.out.bias"] = _t(head["out_bias"])


def _decoder_to_jax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    head = {"start_emb": _np32(sd["cls_head.start_emb.weight"]),
            "out_kernel": _np32(sd["cls_head.out.weight"]).T,
            "out_bias": _np32(sd["cls_head.out.bias"])}
    for torch_name, jax_name, transpose in _DECODER_RNN:
        a = _np32(sd[f"cls_head.rnn.{torch_name}"])
        head[jax_name] = a.T if transpose else a
    return head


# -- LINAS DualEncoding -----------------------------------------------------
# The port's DualEncoding carries the reference torch model's keys under
# its tower names; the flax tree names the same weights as the JAX model
# does.  These three functions map one onto the other both ways and hand
# out the reference checkpoint's list of sub state dicts.

# the reference BaseModel.state_dict order (LINAS-engine/model.py:385-403),
# the list convert_linas_dual_encoding reads
REFERENCE_ORDER = ("vid_encoding", "text_encoding", "vid_mapping",
                   "text_mapping", "student_text_mapping",
                   "student_text_encoding", "student_vid_mapping",
                   "student_vid_encoding")


_f32 = _t


def _np32(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _gru_from_jax(sd, prefix: str, p) -> None:
    for jax_dir, suffix in (("fwd", ""), ("bwd", "_reverse")):
        sd[f"{prefix}weight_ih_l0{suffix}"] = _f32(p[f"{jax_dir}_wi"]).t()
        sd[f"{prefix}weight_hh_l0{suffix}"] = _f32(p[f"{jax_dir}_wh"]).t()
        sd[f"{prefix}bias_ih_l0{suffix}"] = _f32(p[f"{jax_dir}_bi"])
        sd[f"{prefix}bias_hh_l0{suffix}"] = _f32(p[f"{jax_dir}_bh"])


def _dense_from_jax(sd, prefix: str, p) -> None:
    sd[f"{prefix}weight"] = _f32(p["kernel"]).t()
    sd[f"{prefix}bias"] = _f32(p["bias"])


def _encoding_from_jax(sd, prefix: str, p, kernel_sizes) -> None:
    if "embed" in p:
        sd[f"{prefix}embed.weight"] = _f32(p["embed"]["embedding"])
    _gru_from_jax(sd, f"{prefix}rnn.", p["rnn"])
    for i, w in enumerate(kernel_sizes):
        conv = p["convs"][f"conv_w{w}"]
        # flax (w, C, K) -> the reference Conv2d's (K, 1, w, C)
        sd[f"{prefix}convs1.{i}.weight"] = \
            _f32(conv["kernel"]).permute(2, 0, 1)[:, None]
        sd[f"{prefix}convs1.{i}.bias"] = _f32(conv["bias"])
    for name in ("k", "q"):
        if name in p:
            _dense_from_jax(sd, f"{prefix}{name}.", p[name])


def _mapping_from_jax(sd, prefix: str, p, stats) -> None:
    m = p["mapping"]
    i = 1
    while f"fc{i}" in m:
        _dense_from_jax(sd, f"{prefix}mapping.fc{i}.", m[f"fc{i}"])
        i += 1
    if "bn_1" in m:
        bn = f"{prefix}mapping.bn_1."
        sd[bn + "weight"] = _f32(m["bn_1"]["scale"])
        sd[bn + "bias"] = _f32(m["bn_1"]["bias"])
        if not stats:               # a tree of parameters only
            return
        sd[bn + "running_mean"] = _f32(stats["mapping"]["bn_1"]["mean"])
        sd[bn + "running_var"] = _f32(stats["mapping"]["bn_1"]["var"])
        sd[bn + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def dual_encoding_state_dict_from_jax(variables_np: Dict[str, Any], cfg
                                      ) -> Dict[str, torch.Tensor]:
    """A JAX DualEncoding's variables ({"params", "batch_stats"}, leaves
    numpy arrays or tensors) -> the port's f32 state dict.  cfg: a
    DualEncodingConfig of either package."""
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    for name in REFERENCE_ORDER:
        if name not in params:
            continue
        if name.endswith("mapping"):
            _mapping_from_jax(sd, f"{name}.", params[name],
                              stats.get(name, {}))
        else:
            sizes = (cfg.visual_kernel_sizes if "vid" in name
                     else cfg.text_kernel_sizes)
            _encoding_from_jax(sd, f"{name}.", params[name], sizes)
    return sd


def dual_encoding_variables_to_jax(state_dict: Dict[str, torch.Tensor]
                                   ) -> Dict[str, Any]:
    """The inverse: the port's state dict -> the JAX DualEncoding's
    variables as numpy f32 arrays, {"params": ..., "batch_stats": ...},
    which the JAX package's save_checkpoint and the port's write alike."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in state_dict.items():
        tower, rest = key.split(".", 1)
        p = params.setdefault(tower, {})
        parts = rest.split(".")
        if parts[0] == "rnn":
            name = parts[1]
            jax_dir = "bwd" if name.endswith("_reverse") else "fwd"
            kind = {"weight_ih": "wi", "weight_hh": "wh", "bias_ih": "bi",
                    "bias_hh": "bh"}[name.rsplit("_l0", 1)[0]]
            a = _np32(t)
            p.setdefault("rnn", {})[f"{jax_dir}_{kind}"] = \
                a.T if kind.startswith("w") else a
        elif parts[0] == "convs1":
            w = t.shape[2] if parts[2] == "weight" else \
                state_dict[f"{tower}.convs1.{parts[1]}.weight"].shape[2]
            conv = p.setdefault("convs", {}).setdefault(f"conv_w{w}", {})
            if parts[2] == "weight":       # (K, 1, w, C) -> (w, C, K)
                conv["kernel"] = _np32(t[:, 0].permute(1, 2, 0))
            else:
                conv["bias"] = _np32(t)
        elif parts[0] == "embed":
            p["embed"] = {"embedding": _np32(t)}
        elif parts[0] in ("k", "q"):
            d = p.setdefault(parts[0], {})
            d["kernel" if parts[1] == "weight" else "bias"] = \
                _np32(t.t() if parts[1] == "weight" else t)
        elif parts[0] == "mapping" and parts[1] == "bn_1":
            field = parts[2]
            if field == "num_batches_tracked":
                continue
            if field.startswith("running_"):
                s = stats.setdefault(tower, {}).setdefault(
                    "mapping", {}).setdefault("bn_1", {})
                s[field[len("running_"):]] = _np32(t)
            else:
                bn = p.setdefault("mapping", {}).setdefault("bn_1", {})
                bn["scale" if field == "weight" else "bias"] = _np32(t)
        elif parts[0] == "mapping":
            d = p.setdefault("mapping", {}).setdefault(parts[1], {})
            d["kernel" if parts[2] == "weight" else "bias"] = \
                _np32(t.t() if parts[2] == "weight" else t)
        else:
            raise KeyError(f"no JAX counterpart for {key}")
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def reference_state_dicts(state_dict: Dict[str, torch.Tensor]
                          ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """The port's state dict as the reference checkpoint's 'model' list:
    one sub state dict per tower in REFERENCE_ORDER, None where the style
    has no such tower (the list convert_linas_dual_encoding reads)."""
    out: List[Optional[Dict[str, torch.Tensor]]] = []
    for name in REFERENCE_ORDER:
        prefix = name + "."
        sub = {k[len(prefix):]: v for k, v in state_dict.items()
               if k.startswith(prefix)}
        out.append(sub or None)
    return out


# -- the LINAS train state ----------------------------------------------------
# optax's states as flax serializes them: a NamedTuple as a dict of its
# fields in field order, a tuple as a dict keyed "0", "1", ..., an
# EmptyState as {}; dict keys sorted, as jax.tree.map leaves them.

def _moments_to_jax(moments: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{parameter name: tensor} -> the JAX params tree of those tensors."""
    return dual_encoding_variables_to_jax(moments)["params"]


def _chain_state(named_state: Dict[str, Any], to_tree) -> Dict[str, Any]:
    """chain(clip_by_global_norm, adam | rmsprop)'s state: (EmptyState,
    (ScaleByAdamState(count, mu, nu) | ScaleByRmsState(nu), EmptyState))."""
    if "mu" in named_state:
        inner = {"count": np.asarray(named_state["count"], np.int32),
                 "mu": to_tree(named_state["mu"]),
                 "nu": to_tree(named_state["nu"])}
    else:
        inner = {"nu": to_tree(named_state["nu"])}
    return {"0": {}, "1": {"0": inner, "1": {}}}


def linas_train_state_to_jax(state_dict: Dict[str, torch.Tensor],
                             named_state: Dict[str, Any]) -> Dict[str, Any]:
    """The model's state dict and its optimizer's `named_state()` -> the
    JAX TrainState's tree: params, batch_stats and the
    inject_hyperparams state (count, hyperparams/learning_rate,
    hyperparams_states, inner_state)."""
    variables = dual_encoding_variables_to_jax(state_dict)
    opt_state = {
        "count": np.asarray(named_state["count"], np.int32),
        "hyperparams": {"learning_rate": np.asarray(
            named_state["learning_rate"], np.float32)},
        "hyperparams_states": {},
        "inner_state": _chain_state(named_state, _moments_to_jax)}
    return {"params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "opt_state": opt_state}


def _moments_from_jax(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    return dual_encoding_state_dict_from_jax({"params": tree}, cfg)


def linas_train_state_from_jax(tree: Dict[str, Any], cfg
                               ) -> Tuple[Dict[str, torch.Tensor],
                                          Dict[str, Any]]:
    """The inverse: the JAX TrainState's tree (leaves numpy arrays or
    tensors) -> (the model's state dict, the optimizer's named state)."""
    state_dict = dual_encoding_state_dict_from_jax(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}, cfg)
    opt = tree["opt_state"]
    inner = opt["inner_state"]["1"]["0"]
    named = {"count": int(np.asarray(opt["count"])),
             "learning_rate": float(np.asarray(
                 opt["hyperparams"]["learning_rate"]))}
    for m in ("mu", "nu"):
        if m in inner:
            named[m] = _moments_from_jax(inner[m], cfg)
    return state_dict, named


def linas_mask_state_to_jax(pa: torch.Tensor, named_state: Dict[str, Any]
                            ) -> Dict[str, Any]:
    """The 'adapt' mask's (pa, chain(clip, adam) state) as the JAX
    MaskState tuple serializes."""
    return {"0": _np32(pa),
            "1": _chain_state(named_state, lambda m: _np32(m["pa"]))}


def linas_mask_state_from_jax(tree: Dict[str, Any]
                              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The inverse: (pa, the mask optimizer's named state)."""
    inner = tree["1"]["1"]["0"]
    named = {"count": int(np.asarray(inner["count"])),
             "mu": {"pa": _f32(inner["mu"])}, "nu": {"pa": _f32(inner["nu"])}}
    return _f32(tree["0"]), named


# -- composed retrieval: CLIP-RN, the Combiner, and the trees back ----------

def _conv_from_jax(sd, name: str, p) -> None:
    """flax conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh,
    kw), no bias."""
    sd[f"{name}.weight"] = _f32(p["kernel"]).permute(3, 2, 0, 1).contiguous()


def _bn_from_jax(sd, name: str, p, stats) -> None:
    sd[f"{name}.weight"] = _f32(p["scale"])
    sd[f"{name}.bias"] = _f32(p["bias"])
    sd[f"{name}.running_mean"] = _f32(stats["mean"])
    sd[f"{name}.running_var"] = _f32(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _text_from_jax(sd, txt, n_layers: int) -> None:
    sd["token_embedding.weight"] = _t(txt["token_embedding"])
    sd["positional_embedding"] = _t(txt["positional_embedding"])
    sd["text_projection"] = _t(txt["text_projection"])
    _ln(sd, "ln_final", txt["ln_final"])
    for i in range(n_layers):
        _resblock(sd, f"transformer.resblocks.{i}",
                  txt["transformer"][f"resblock_{i}"])


def clip_resnet_state_dict_from_jax(variables: Dict[str, Any], cfg
                                    ) -> Dict[str, torch.Tensor]:
    """A JAX CLIPResNetModel's variables ({"params", "batch_stats"}, leaves
    numpy arrays or tensors) -> the port's f32 OpenAI-layout CLIP-RN state
    dict.  cfg: a CLIPResNetConfig of either package."""
    params = variables["params"]
    vis, vstats = params["visual"], variables["batch_stats"]["visual"]
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        _conv_from_jax(sd, f"visual.conv{i}", vis[f"conv{i}"])
        _bn_from_jax(sd, f"visual.bn{i}", vis[f"bn{i}"], vstats[f"bn{i}"])
    for s, n in zip((1, 2, 3, 4), cfg.vision_layers):
        for b in range(n):
            p, st = vis[f"layer{s}_{b}"], vstats[f"layer{s}_{b}"]
            prefix = f"visual.layer{s}.{b}"
            for i in (1, 2, 3):
                _conv_from_jax(sd, f"{prefix}.conv{i}", p[f"conv{i}"])
                _bn_from_jax(sd, f"{prefix}.bn{i}", p[f"bn{i}"],
                             st[f"bn{i}"])
            if "conv_down" in p:
                _conv_from_jax(sd, f"{prefix}.downsample.0", p["conv_down"])
                _bn_from_jax(sd, f"{prefix}.downsample.1", p["bn_down"],
                             st["bn_down"])
    pool = vis["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(
        pool["positional_embedding"])
    for n in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(sd, f"visual.attnpool.{n}", pool[n])
    _text_from_jax(sd, params["text"], cfg.text_layers)
    sd["logit_scale"] = _t(params["logit_scale"])
    return sd


def combiner_state_dict_from_jax(variables: Dict[str, Any], cfg
                                 ) -> Dict[str, torch.Tensor]:
    """A JAX Combiner's variables (with or without the top-level "params"
    key) -> the port's f32 state dict.  cfg: a CombinerConfig of either
    package; its middle_mix says which tree it is."""
    p = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for n in ("text_projection_layer", "image_projection_layer",
              "combiner_layer", "output_layer", "m_residual"):
        _linear(sd, n, p[n])
    _linear(sd, "dynamic_scalar.0", p["dynamic_scalar_fc1"])
    _linear(sd, "dynamic_scalar.3", p["dynamic_scalar_fc2"])
    if cfg.middle_mix == "conv4x4":
        # (C_in, C_out) -> the 1x1 Conv2d's (C_out, C_in, 1, 1)
        sd["m_remained.weight"] = _t(p["m_remained_kernel"]).t()[
            :, :, None, None].contiguous()
        sd["m_remained.bias"] = _t(p["m_remained_bias"])
    else:
        _linear(sd, "m_remained", p["m_remained"])
    at = p["self_attn_1"]
    _ln(sd, "self_attn_1.ln_1", at["ln_1"])
    _ln(sd, "self_attn_1.ln_2", at["ln_2"])
    _mha(sd, "self_attn_1.attn", at["attn"])
    _linear(sd, "self_attn_1.mlp.c_fc", at["c_fc"])
    _linear(sd, "self_attn_1.mlp.c_proj", at["c_proj"])
    return sd


def _dense_to_jax(sd, name: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np32(sd[f"{name}.weight"]).T,
            "bias": _np32(sd[f"{name}.bias"])}


def _ln_to_jax(sd, name: str) -> Dict[str, Any]:
    return {"ln": {"scale": _np32(sd[f"{name}.weight"]),
                   "bias": _np32(sd[f"{name}.bias"])}}


def _mha_to_jax(sd, name: str) -> Dict[str, Any]:
    w = _np32(sd[f"{name}.in_proj_weight"])
    b = _np32(sd[f"{name}.in_proj_bias"])
    d = w.shape[1]
    out = {n: {"kernel": w[i * d:(i + 1) * d].T, "bias": b[i * d:(i + 1) * d]}
           for i, n in enumerate(("q_proj", "k_proj", "v_proj"))}
    out["out_proj"] = _dense_to_jax(sd, f"{name}.out_proj")
    return out


def _resblock_to_jax(sd, prefix: str) -> Dict[str, Any]:
    return {"ln_1": _ln_to_jax(sd, f"{prefix}.ln_1"),
            "ln_2": _ln_to_jax(sd, f"{prefix}.ln_2"),
            "attn": _mha_to_jax(sd, f"{prefix}.attn"),
            "c_fc": _dense_to_jax(sd, f"{prefix}.mlp.c_fc"),
            "c_proj": _dense_to_jax(sd, f"{prefix}.mlp.c_proj")}


def _text_to_jax(sd, n_layers: int) -> Dict[str, Any]:
    return {"token_embedding": _np32(sd["token_embedding.weight"]),
            "positional_embedding": _np32(sd["positional_embedding"]),
            "text_projection": _np32(sd["text_projection"]),
            "ln_final": _ln_to_jax(sd, "ln_final"),
            "transformer": {f"resblock_{i}": _resblock_to_jax(
                sd, f"transformer.resblocks.{i}") for i in range(n_layers)}}


def clip_variables_to_jax(sd: Dict[str, torch.Tensor], cfg
                          ) -> Dict[str, Any]:
    """The inverse of clip_state_dict_from_jax: an OpenAI-layout CLIP ViT
    state dict -> the JAX CLIPModel's {"params": ...} as numpy f32."""
    visual = {
        "conv1": {"kernel": _np32(sd["visual.conv1.weight"]).transpose(
            2, 3, 1, 0)},
        "class_embedding": _np32(sd["visual.class_embedding"]),
        "positional_embedding": _np32(sd["visual.positional_embedding"]),
        "proj": _np32(sd["visual.proj"]),
        "ln_pre": _ln_to_jax(sd, "visual.ln_pre"),
        "ln_post": _ln_to_jax(sd, "visual.ln_post"),
        "transformer": {f"resblock_{i}": _resblock_to_jax(
            sd, f"visual.transformer.resblocks.{i}")
            for i in range(cfg.vision_layers)}}
    return {"params": {"visual": visual,
                       "text": _text_to_jax(sd, cfg.text_layers),
                       "logit_scale": _np32(sd["logit_scale"])}}


def _conv_bn_to_jax(sd, conv: str, bn: str):
    params = ({"kernel": _np32(sd[f"{conv}.weight"]).transpose(2, 3, 1, 0)},
              {"scale": _np32(sd[f"{bn}.weight"]),
               "bias": _np32(sd[f"{bn}.bias"])})
    stats = {"mean": _np32(sd[f"{bn}.running_mean"]),
             "var": _np32(sd[f"{bn}.running_var"])}
    return params, stats


def clip_resnet_variables_to_jax(sd: Dict[str, torch.Tensor], cfg
                                 ) -> Dict[str, Any]:
    """The inverse of clip_resnet_state_dict_from_jax: -> the JAX
    CLIPResNetModel's {"params", "batch_stats"} as numpy f32."""
    visual: Dict[str, Any] = {}
    vstats: Dict[str, Any] = {}

    def put(p, s, prefix, conv, bn, jconv, jbn):
        (p[jconv], p[jbn]), s[jbn] = _conv_bn_to_jax(
            sd, f"{prefix}{conv}", f"{prefix}{bn}")

    for i in (1, 2, 3):
        put(visual, vstats, "visual.", f"conv{i}", f"bn{i}", f"conv{i}",
            f"bn{i}")
    for s, n in zip((1, 2, 3, 4), cfg.vision_layers):
        for b in range(n):
            p, st = {}, {}
            prefix = f"visual.layer{s}.{b}."
            for i in (1, 2, 3):
                put(p, st, prefix, f"conv{i}", f"bn{i}", f"conv{i}",
                    f"bn{i}")
            if f"{prefix}downsample.0.weight" in sd:
                put(p, st, prefix, "downsample.0", "downsample.1",
                    "conv_down", "bn_down")
            visual[f"layer{s}_{b}"], vstats[f"layer{s}_{b}"] = p, st
    visual["attnpool"] = {
        "positional_embedding": _np32(
            sd["visual.attnpool.positional_embedding"]),
        **{n: _dense_to_jax(sd, f"visual.attnpool.{n}")
           for n in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    return {"params": {"visual": visual,
                       "text": _text_to_jax(sd, cfg.text_layers),
                       "logit_scale": _np32(sd["logit_scale"])},
            "batch_stats": {"visual": vstats}}


def combiner_variables_to_jax(sd: Dict[str, torch.Tensor], cfg
                              ) -> Dict[str, Any]:
    """The inverse of combiner_state_dict_from_jax: the port's Combiner
    state dict -> the JAX Combiner's {"params": ...} as numpy f32 (the
    tree the JAX package's load_checkpoint hands Combiner.apply)."""
    p: Dict[str, Any] = {n: _dense_to_jax(sd, n) for n in (
        "text_projection_layer", "image_projection_layer", "combiner_layer",
        "output_layer", "m_residual")}
    p["dynamic_scalar_fc1"] = _dense_to_jax(sd, "dynamic_scalar.0")
    p["dynamic_scalar_fc2"] = _dense_to_jax(sd, "dynamic_scalar.3")
    if cfg.middle_mix == "conv4x4":
        p["m_remained_kernel"] = _np32(sd["m_remained.weight"][:, :, 0, 0]).T
        p["m_remained_bias"] = _np32(sd["m_remained.bias"])
    else:
        p["m_remained"] = _dense_to_jax(sd, "m_remained")
    p["self_attn_1"] = {
        "ln_1": _ln_to_jax(sd, "self_attn_1.ln_1"),
        "ln_2": _ln_to_jax(sd, "self_attn_1.ln_2"),
        "attn": _mha_to_jax(sd, "self_attn_1.attn"),
        "c_fc": _dense_to_jax(sd, "self_attn_1.mlp.c_fc"),
        "c_proj": _dense_to_jax(sd, "self_attn_1.mlp.c_proj")}
    return {"params": p}


# -- the recognizers, back to the JAX tree ----------------------------------

def _timesformer_block_to_jax(sd, prefix: str, divided: bool
                              ) -> Dict[str, Any]:
    if divided:
        p = {"temporal_norm": _ln_to_jax(sd, f"{prefix}.attentions.0.norm"),
             "temporal_attn": _mha_to_jax(sd, f"{prefix}.attentions.0.attn"),
             "temporal_fc": _dense_to_jax(
                 sd, f"{prefix}.attentions.0.temporal_fc"),
             "spatial_norm": _ln_to_jax(sd, f"{prefix}.attentions.1.norm"),
             "spatial_attn": _mha_to_jax(sd, f"{prefix}.attentions.1.attn"),
             "ffn_norm": _ln_to_jax(sd, f"{prefix}.ffns.0.norm")}
    else:
        p = {"norm1": _ln_to_jax(sd, f"{prefix}.norms.0"),
             "attn": _mha_to_jax(sd, f"{prefix}.attentions.0.attn"),
             "norm2": _ln_to_jax(sd, f"{prefix}.norms.1")}
    p["ffn_fc1"] = _dense_to_jax(sd, f"{prefix}.ffns.0.layers.0.0")
    p["ffn_fc2"] = _dense_to_jax(sd, f"{prefix}.ffns.0.layers.1")
    return p


def _timesformer_to_jax(sd: Dict[str, torch.Tensor], backbone_cfg
                        ) -> Dict[str, Any]:
    """The JAX TimeSformer's params from the port's `backbone.*` keys."""
    pre = "backbone."
    kernel = _np32(sd[f"{pre}patch_embed.projection.weight"])
    # torch (D, 3, ...) -> flax conv kernel (..., 3, D)
    perm = (2, 3, 4, 1, 0) if kernel.ndim == 5 else (2, 3, 1, 0)
    bb: Dict[str, Any] = {
        "patch_embed": {"kernel": kernel.transpose(perm),
                        "bias": _np32(sd[f"{pre}patch_embed.projection.bias"])},
        "norm": _ln_to_jax(sd, f"{pre}norm")}
    names = ["cls_token", "pos_embed"]
    if backbone_cfg.attention_type != "space_only":
        names.append("time_embed")
    for n in names:
        bb[n] = _np32(sd[pre + n])
    for i in range(backbone_cfg.num_layers):
        bb[f"block_{i}"] = _timesformer_block_to_jax(
            sd, f"{pre}transformer_layers.layers.{i}",
            backbone_cfg.attention_type == "divided_space_time")
    return bb


def recognizer_variables_to_jax(sd: Dict[str, torch.Tensor], backbone_cfg
                                ) -> Dict[str, Any]:
    """The inverse of recognizer_state_dict_from_jax: the port's
    Recognizer3D or Recognizer3DRelseq state dict -> the JAX recognizer's
    {"params": {"backbone", "cls_head"}} as numpy f32.  backbone_cfg: a
    TimeSformerConfig of either package."""
    bb = _timesformer_to_jax(sd, backbone_cfg)
    if "cls_head.fc_cls.weight" in sd:
        head = {"fc_cls": _dense_to_jax(sd, "cls_head.fc_cls")}
    else:
        head = _decoder_to_jax(sd)
    return {"params": {"backbone": bb, "cls_head": head}}


def shuffle_recognizer_state_dict_from_jax(variables_np: Dict[str, Any],
                                           backbone_cfg
                                           ) -> Dict[str, torch.Tensor]:
    """A JAX shuffle recognizer's variables (Recognizer3DShuffleEmb, Soft
    or Extra: the Recognizer3D tree, `backbone` and `cls_head.fc_cls`) ->
    the port's fp32 state dict."""
    params = variables_np.get("params", variables_np)
    if "fc_cls" not in params["cls_head"]:
        raise KeyError("a shuffle recognizer's cls_head is fc_cls")
    return recognizer_state_dict_from_jax(params, backbone_cfg)


def shuffle_recognizer_variables_to_jax(sd: Dict[str, torch.Tensor],
                                        backbone_cfg) -> Dict[str, Any]:
    """The inverse of shuffle_recognizer_state_dict_from_jax."""
    if "cls_head.fc_cls.weight" not in sd:
        raise KeyError("a shuffle recognizer's cls_head is fc_cls")
    return recognizer_variables_to_jax(sd, backbone_cfg)


# -- the word-level caption transformer ---------------------------------------

def caption_transformer_state_dict_from_jax(params: Dict[str, Any],
                                            prefix: str = ""
                                            ) -> Dict[str, torch.Tensor]:
    """The JAX CaptionTransformer's params (with or without the "params"
    key) -> the port's state dict: the same names under `prefix`."""
    params = params.get("params", params)
    return {prefix + k: _t(v) for k, v in params.items()}


def caption_transformer_variables_to_jax(sd: Dict[str, torch.Tensor],
                                         prefix: str = "") -> Dict[str, Any]:
    """The inverse: {"params": {name: numpy f32}}."""
    return {"params": {k[len(prefix):]: _np32(v) for k, v in sd.items()
                       if k.startswith(prefix)}}


def recognizer_caption_state_dict_from_jax(variables_np: Dict[str, Any],
                                           backbone_cfg
                                           ) -> Dict[str, torch.Tensor]:
    """A JAX Recognizer3DCaption's variables -> the port's state dict
    (`backbone.*`, `caption_head.*`)."""
    params = variables_np.get("params", variables_np)
    sd = timesformer_state_dict_from_jax(params["backbone"], backbone_cfg)
    sd.update(caption_transformer_state_dict_from_jax(
        params["caption_head"], "caption_head."))
    return sd


def recognizer_caption_variables_to_jax(sd: Dict[str, torch.Tensor],
                                        backbone_cfg) -> Dict[str, Any]:
    """The inverse of recognizer_caption_state_dict_from_jax."""
    head = caption_transformer_variables_to_jax(sd, "caption_head.")
    return {"params": {"backbone": _timesformer_to_jax(sd, backbone_cfg),
                       "caption_head": head["params"]}}


# -- the concept-bottleneck head ----------------------------------------------

_RESIDUAL_HEAD_DENSES = ("concept_hidden", "concept_fc", "embed_fc")


def residual_head_state_dict_from_jax(variables: Dict[str, Any]
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX explain/cbm.ResidualHead's {"params": ...} -> the port's
    ResidualHead state dict (each flax Dense kernel transposed into its
    nn.Linear weight)."""
    sd: Dict[str, torch.Tensor] = {}
    for name in _RESIDUAL_HEAD_DENSES:
        _linear(sd, name, variables["params"][name])
    return sd


def residual_head_variables_to_jax(sd: Dict[str, torch.Tensor]
                                   ) -> Dict[str, Any]:
    """The inverse of residual_head_state_dict_from_jax, as numpy f32."""
    return {"params": {name: _dense_to_jax(sd, name)
                       for name in _RESIDUAL_HEAD_DENSES}}


# -- the recognition trainers' state ------------------------------------------
# make_rec_optimizer's chains as optax's init lays them out (read off
# `tx.init` in tests/test_torch_recognition_train.py): chain(clip, inner)
# -> {"0": {}, "1": inner}, without the clip inner alone;
# sgd: inner = {"0": {} (add_decayed_weights), "1": {"0": {"trace"} | {}
# (no momentum), "1": {"count"} (schedule) | {} (constant lr)}};
# adamw: inner = {"0": {"count", "mu", "nu"}, "1": {} (decay), "2":
# {"count"} | {}}.

def _rec_chain_to_jax(named_state: Dict[str, Any], kind: str, clip: bool,
                      schedule: bool, to_tree) -> Dict[str, Any]:
    count = np.asarray(named_state["count"], np.int32)
    lr_state = {"count": count} if schedule else {}
    if kind == "adamw":
        inner = {"0": {"count": count, "mu": to_tree(named_state["mu"]),
                       "nu": to_tree(named_state["nu"])},
                 "1": {}, "2": lr_state}
    else:
        trace = ({"trace": to_tree(named_state["trace"])}
                 if "trace" in named_state else {})
        inner = {"0": {}, "1": {"0": trace, "1": lr_state}}
    return {"0": {}, "1": inner} if clip else inner


def _params_to_jax(backbone_cfg):
    """{parameter name: tensor} -> the JAX params tree, for a TimeSformer
    recognizer (its config) or a 3D-CNN recognizer (the model itself)."""
    if isinstance(backbone_cfg, torch.nn.Module):
        return lambda t: conv_recognizer_variables_to_jax(
            t, backbone_cfg)["params"]
    return lambda t: recognizer_variables_to_jax(t, backbone_cfg)["params"]


def _params_from_jax(backbone_cfg):
    if isinstance(backbone_cfg, torch.nn.Module):
        return lambda t: conv_recognizer_state_dict_from_jax(
            {"params": t}, backbone_cfg)
    return lambda t: recognizer_state_dict_from_jax({"params": t},
                                                    backbone_cfg)


def rec_train_state_to_jax(state_dict: Dict[str, torch.Tensor],
                           named_state: Dict[str, Any], step: int,
                           backbone_cfg, kind: str, clip: bool,
                           schedule: bool) -> Dict[str, Any]:
    """A recognizer's state dict, its OptaxOptimizer's `named_state()` and
    the step count -> the JAX RecTrainState's tree.  backbone_cfg: the
    TimeSformerConfig of a TimeSformer recognizer, or a 3D-CNN recognizer
    itself (its module tree names the JAX tree; the BatchNorm statistics
    are not in the RecTrainState); kind: 'sgd' | 'adamw'; clip: a
    clip_by_global_norm leads the chain; schedule: the learning rate is
    the warmup-cosine schedule (its count is kept)."""
    to_tree = _params_to_jax(backbone_cfg)

    return {"params": to_tree(state_dict),
            "opt_state": _rec_chain_to_jax(named_state, kind, clip,
                                           schedule, to_tree),
            "step": np.asarray(step, np.int32)}


def rec_train_state_from_jax(tree: Dict[str, Any], backbone_cfg, kind: str,
                             clip: bool
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, Any], int]:
    """The inverse: the JAX RecTrainState's tree -> (the parameters'
    state dict, the optimizer's named state, step).  An optimizer state
    that keeps no count (SGD at a constant learning rate) takes the
    step's."""
    from_tree = _params_from_jax(backbone_cfg)

    step = int(np.asarray(tree["step"]))
    inner = tree["opt_state"]["1"] if clip else tree["opt_state"]
    named: Dict[str, Any] = {"count": step}
    if kind == "adamw":
        adam = inner["0"]
        named.update(count=int(np.asarray(adam["count"])),
                     mu=from_tree(adam["mu"]), nu=from_tree(adam["nu"]))
    else:
        trace, lr_state = inner["1"]["0"], inner["1"]["1"]
        if "count" in lr_state:
            named["count"] = int(np.asarray(lr_state["count"]))
        if "trace" in trace:
            named["trace"] = from_tree(trace["trace"])
    return from_tree(tree["params"]), named, step


# -- the YOLOv5 detector and classifier, both ways ---------------------------
# sequential index of the ultralytics layout -> the JAX module's name
# (convert/torch_import.py _YOLO_IDX2NAME)
_YOLO_IDX2NAME = {
    0: "stem", 1: "down1", 2: "c3_1", 3: "down2", 4: "c3_2", 5: "down3",
    6: "c3_3", 7: "down4", 8: "c3_4", 9: "sppf", 10: "up5_conv", 13: "n4",
    14: "up4_conv", 17: "n3", 18: "pan3", 20: "n4b", 21: "pan4", 23: "n5b",
}
_YOLO_DETECT = 24


def _yolo_convs(p) -> List[str]:
    """The ConvBnSiLU children of a JAX C3 / SPPF / Proto tree, or [""]
    for a ConvBnSiLU itself; C3's bottlenecks as 'm{j}.cv1', 'm{j}.cv2'."""
    if "conv" in p:
        return [""]
    names = [cv for cv in ("cv1", "cv2", "cv3") if cv in p]
    j = 0
    while f"m{j}" in p:
        names += [f"m{j}.cv1", f"m{j}.cv2"]
        j += 1
    return names


def _jax_path(tree, dotted: str):
    for part in filter(None, dotted.split(".")):
        tree = tree[part]
    return tree


def _torch_key(dotted: str) -> str:
    """'m0.cv1' -> 'm.0.cv1' (C3's bottlenecks sit in an nn.Sequential)."""
    return ".".join(f"m.{p[1:]}" if p[:1] == "m" and p[1:].isdigit() else p
                    for p in dotted.split(".") if p)


def _yolo_block_from_jax(sd, prefix: str, params, stats) -> None:
    for cv in _yolo_convs(params):
        p, s = _jax_path(params, cv), _jax_path(stats, cv)
        name = ".".join(filter(None, (prefix, _torch_key(cv))))
        _conv_from_jax(sd, f"{name}.conv", p["conv"])
        _bn_from_jax(sd, f"{name}.bn", p["bn"], s["bn"])


def _yolo_block_to_jax(sd, prefix: str, template_params):
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for cv in _yolo_convs(template_params):
        name = ".".join(filter(None, (prefix, _torch_key(cv))))
        (conv, bn), st = _conv_bn_to_jax(sd, f"{name}.conv", f"{name}.bn")
        node_p, node_s = params, stats
        for part in filter(None, cv.split(".")):
            node_p = node_p.setdefault(part, {})
            node_s = node_s.setdefault(part, {})
        node_p.update(conv=conv, bn=bn)
        node_s["bn"] = st
    return params, stats


def _yolo_anchors(cfg) -> torch.Tensor:
    a = torch.tensor(cfg.anchors, dtype=torch.float32)
    return a / torch.tensor([8.0, 16.0, 32.0]).view(3, 1, 1)


def yolo_state_dict_from_jax(variables_np: Dict[str, Any], cfg
                             ) -> Dict[str, torch.Tensor]:
    """A JAX YoloV5's variables ({"params", "batch_stats"}, numpy arrays or
    tensors) -> the port's state dict in the ultralytics layout, the
    inverse of convert_yolov5; the anchors buffer from cfg.anchors in grid
    units.  cfg: a YoloConfig of either package."""
    params, stats = variables_np["params"], variables_np["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for idx, name in _YOLO_IDX2NAME.items():
        _yolo_block_from_jax(sd, f"model.{idx}", params[name], stats[name])
    det = f"model.{_YOLO_DETECT}"
    for i in range(3):
        p = params[f"detect_{i}"]
        sd[f"{det}.m.{i}.weight"] = _f32(p["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        sd[f"{det}.m.{i}.bias"] = _f32(p["bias"])
    sd[f"{det}.anchors"] = _yolo_anchors(cfg)
    if cfg.masks > 0:
        _yolo_block_from_jax(sd, f"{det}.proto", params["proto"],
                             stats["proto"])
    return sd


def yolo_variables_to_jax(state_dict: Dict[str, torch.Tensor], cfg
                          ) -> Dict[str, Any]:
    """The port's YoloV5 state dict -> the JAX variables {"params",
    "batch_stats"} (numpy f32), as convert_yolov5 builds them."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for idx, name in _YOLO_IDX2NAME.items():
        pre = f"model.{idx}"
        if f"{pre}.conv.weight" in state_dict:
            template = {"conv": None}
        else:
            template = {cv: None for cv in ("cv1", "cv2", "cv3")
                        if f"{pre}.{cv}.conv.weight" in state_dict}
            j = 0
            while f"{pre}.m.{j}.cv1.conv.weight" in state_dict:
                template[f"m{j}"] = None
                j += 1
        params[name], stats[name] = _yolo_block_to_jax(state_dict, pre,
                                                       template)
    det = f"model.{_YOLO_DETECT}"
    for i in range(3):
        params[f"detect_{i}"] = {
            "kernel": _np32(state_dict[f"{det}.m.{i}.weight"]).transpose(
                2, 3, 1, 0),
            "bias": _np32(state_dict[f"{det}.m.{i}.bias"])}
    if cfg.masks > 0:
        params["proto"], stats["proto"] = _yolo_block_to_jax(
            state_dict, f"{det}.proto", {"cv1": 0, "cv2": 0, "cv3": 0})
    return {"params": params, "batch_stats": stats}


_YOLO_CLS_TRUNK = {i: n for i, n in _YOLO_IDX2NAME.items() if i <= 8}


def yolo_cls_state_dict_from_jax(variables_np: Dict[str, Any], cfg
                                 ) -> Dict[str, torch.Tensor]:
    """A JAX YoloClassifier's variables -> the port's state dict (the
    yolov5-cls layout convert_yolov5_cls reads: the trunk model.0-8,
    Classify at model.9)."""
    params, stats = variables_np["params"], variables_np["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for idx, name in _YOLO_CLS_TRUNK.items():
        _yolo_block_from_jax(sd, f"model.{idx}", params[name], stats[name])
    _yolo_block_from_jax(sd, "model.9.conv", params["classify_conv"],
                         stats["classify_conv"])
    lin = params["classify_linear"]
    sd["model.9.linear.weight"] = _f32(lin["kernel"]).T.contiguous()
    sd["model.9.linear.bias"] = _f32(lin["bias"])
    return sd


def yolo_cls_variables_to_jax(state_dict: Dict[str, torch.Tensor], cfg
                              ) -> Dict[str, Any]:
    """The inverse of yolo_cls_state_dict_from_jax."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for idx, name in _YOLO_CLS_TRUNK.items():
        pre = f"model.{idx}"
        if f"{pre}.conv.weight" in state_dict:
            template = {"conv": None}
        else:
            template = {"cv1": 0, "cv2": 0, "cv3": 0}
            j = 0
            while f"{pre}.m.{j}.cv1.conv.weight" in state_dict:
                template[f"m{j}"] = None
                j += 1
        params[name], stats[name] = _yolo_block_to_jax(state_dict, pre,
                                                       template)
    params["classify_conv"], stats["classify_conv"] = _yolo_block_to_jax(
        state_dict, "model.9.conv", {"conv": None})
    params["classify_linear"] = _dense_to_jax(state_dict, "model.9.linear")
    return {"params": params, "batch_stats": stats}


# -- the detector trainers' state ---------------------------------------------

_YOLO_BUFFERS = ("running_mean", "running_var", "num_batches_tracked",
                 "anchors")


def _yolo_to_jax(state_dict, cfg, classifier: bool) -> Dict[str, Any]:
    return (yolo_cls_variables_to_jax if classifier
            else yolo_variables_to_jax)(state_dict, cfg)


def _yolo_from_jax(params, stats, cfg, classifier: bool
                   ) -> Dict[str, torch.Tensor]:
    return (yolo_cls_state_dict_from_jax if classifier
            else yolo_state_dict_from_jax)(
        {"params": params, "batch_stats": stats}, cfg)


def yolo_train_state_to_jax(state_dict: Dict[str, torch.Tensor],
                            vel: Dict[str, torch.Tensor],
                            ema_state_dict: Dict[str, torch.Tensor],
                            updates: int, cfg, classifier: bool = False
                            ) -> Dict[str, Any]:
    """The port's YoloTrainState parts (the model's state dict, the
    velocity by parameter name, the EMA model's state dict, the update
    count) -> the JAX YoloTrainState's fields {"params", "batch_stats",
    "vel", "ema_params", "ema_stats", "updates"} as numpy."""
    cur = _yolo_to_jax(state_dict, cfg, classifier)
    ema = _yolo_to_jax(ema_state_dict, cfg, classifier)
    vel_sd = dict(state_dict)
    vel_sd.update(vel)
    return {"params": cur["params"], "batch_stats": cur["batch_stats"],
            "vel": _yolo_to_jax(vel_sd, cfg, classifier)["params"],
            "ema_params": ema["params"], "ema_stats": ema["batch_stats"],
            "updates": np.asarray(updates, np.int32)}


def yolo_train_state_from_jax(tree: Dict[str, Any], cfg,
                              classifier: bool = False
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, torch.Tensor],
                                         Dict[str, torch.Tensor], int]:
    """The inverse: the JAX YoloTrainState's fields -> (state dict,
    velocity by parameter name, EMA state dict, updates)."""
    sd = _yolo_from_jax(tree["params"], tree["batch_stats"], cfg, classifier)
    ema = _yolo_from_jax(tree["ema_params"], tree["ema_stats"], cfg,
                         classifier)
    vel_sd = _yolo_from_jax(tree["vel"], tree["batch_stats"], cfg,
                            classifier)
    vel = {k: v for k, v in vel_sd.items()
           if k.rsplit(".", 1)[-1] not in _YOLO_BUFFERS}
    return sd, vel, ema, int(np.asarray(tree["updates"]))


# -- the 3D-CNN backbones and recognizers, both ways --------------------------
# The port's modules carry mmaction's keys (models/resnet3d.py); the JAX
# modules name the same weights as convert/torch_import.py's
# convert_resnet3d, _non_local3d, convert_slowfast, convert_x3d and
# convert_csn write them.  One table of (port module, JAX path, kind) per
# model, read off the model's module tree, drives both directions, so
# each direction inverts the other and the importers.

def _conv_bn(rest: List[str], conv: str, bn: str) -> Tuple[str, ...]:
    """A ConvModule's leaf ('conv' or 'bn') -> its JAX name."""
    return (conv,) if rest == ["conv"] else (bn,)


def _bottleneck_path(rest: List[str]) -> Tuple[str, ...]:
    head = rest[0]
    if head == "downsample":
        return _conv_bn(rest[1:], "downsample", "bn_down")
    k = head[len("conv"):]
    return _conv_bn(rest[1:], f"conv{k}", f"bn{k}")


def _non_local_path(rest: List[str]) -> Tuple[str, ...]:
    if rest[0] == "conv_out":
        return _conv_bn(rest[1:], "conv_out", "bn_out")
    return (rest[0],)                  # g.0.conv, theta.conv, phi.0.conv


def _resnet3d_path(parts: List[str]) -> Tuple[str, ...]:
    if parts[0] == "conv1":
        return _conv_bn(parts[1:], "conv1", "bn1")
    dst = f"{parts[0]}_{parts[1]}"     # layer{s}.{j} -> layer{s}_{j}
    if parts[2] == "non_local_block":
        return (dst + "_nl",) + _non_local_path(parts[3:])
    return (dst,) + _bottleneck_path(parts[2:])


def _slowfast_path(parts: List[str]) -> Tuple[str, ...]:
    from ..models.resnet3d import LATERALS
    if parts[0] == "fast_path":
        return ("fast",) + _resnet3d_path(parts[1:])
    name, rest = parts[1], parts[2:]
    if name == "conv1":
        return _conv_bn(rest, "slow_conv1", "slow_bn1")
    if name in LATERALS:
        i = LATERALS.index(name)
        return _conv_bn(rest, f"lateral_{i}", f"lateral_bn_{i}")
    return (f"slow_l{name[len('layer'):]}_{rest[0]}",) \
        + _bottleneck_path(rest[1:])


def _csn_path(parts: List[str], ip: bool) -> Tuple[str, ...]:
    if parts[0] == "conv1":
        return _conv_bn(parts[1:], "conv1", "bn1")
    dst, head, rest = f"{parts[0]}_{parts[1]}", parts[2], parts[3:]
    if head == "conv2":                # conv2.{0|1}.{conv|bn}
        point = ip and rest[0] == "0"
        return (dst,) + (_conv_bn(rest[1:], "conv2_point", "bn_point")
                         if point else
                         _conv_bn(rest[1:], "conv2_depth", "bn2"))
    if head == "downsample":
        return (dst,) + _conv_bn(rest, "conv_down", "bn_down")
    return (dst,) + _bottleneck_path(parts[2:])


def _x3d_path(parts: List[str]) -> Tuple[str, ...]:
    stem = {"conv1_s": ("stem_s", None), "conv1_t": ("stem_t", "stem_bn"),
            "conv5": ("conv5", "bn5")}
    if parts[0] in stem:
        return _conv_bn(parts[1:], *stem[parts[0]])
    dst = f"s{parts[0][len('layer'):]}_{parts[1]}"
    if parts[2] == "se_module":
        return (dst, "se", parts[3])
    return (dst,) + _bottleneck_path(parts[2:])


def _tsm_path(parts: List[str]) -> Tuple[str, ...]:
    """TSMResNet and the ResNets of TINResNet and TINResNetExact."""
    if parts[0] == "conv1":
        return _conv_bn(parts[1:], "conv1", "bn1")
    if parts[0].startswith("interlace"):            # TINResNet
        return (f"interlace_{parts[0][len('interlace'):]}", parts[1])
    dst, rest = f"{parts[0]}_{parts[1]}", parts[2:]
    if rest[:3] == ["conv1", "conv", "net1"]:       # TINResNetExact
        return (dst, "interlace") + tuple(rest[3:])
    if rest[:3] == ["conv1", "conv", "net2"]:
        return (dst, "conv1")
    return (dst,) + _bottleneck_path(rest)


def _mobilenet_path(backbone, parts: List[str]) -> Tuple[str, ...]:
    stem = {"conv1": ("stem", "bn_stem"), "conv2": ("head", "bn_head")}
    if parts[0] in stem:
        return _conv_bn(parts[1:], *stem[parts[0]])
    block = getattr(backbone, parts[0])[int(parts[1])]
    k = int(parts[3]) + (block.expand == 1)         # no expand conv at 1
    conv, bn = (("expand", "bn1"), ("dw", "bn2"), ("project", "bn3"))[k]
    return (f"s{int(parts[0][len('layer'):]) - 1}_b{parts[1]}",) \
        + _conv_bn(parts[4:], conv, bn)


_TAM = {("G", "0"): "g_fc1", ("G", "1"): "g_bn", ("G", "3"): "g_fc2",
        ("L", "0"): "l_conv1", ("L", "1"): "l_bn", ("L", "3"): "l_conv2"}


def _tanet_path(parts: List[str]) -> Tuple[str, ...]:
    if parts[0] == "conv1":
        return _conv_bn(parts[1:], "conv1", "bn1")
    dst = f"{parts[0]}_{parts[1]}"
    if parts[2] == "tam":
        return (dst, "tam", _TAM[parts[3], parts[4]])
    return (dst,) + _bottleneck_path(parts[3:])     # block.<conv>


def _r2plus1d_path(parts: List[str]) -> Tuple[str, ...]:
    """A ConvModule2Plus1D `<name>.conv.{conv_s,bn_s,conv_t}` / `.bn`."""
    if parts[0] == "conv1":
        return ("conv1", parts[2]) if parts[1] == "conv" else ("bn1",)
    dst, head, rest = f"{parts[0]}_{parts[1]}", parts[2], parts[3:]
    name, bn = ("downsample", "bn_down") if head == "downsample" else \
        (head, f"bn{head[len('conv'):]}")
    return (dst, name, rest[1]) if rest[0] == "conv" else (dst, bn)


_TPN_LF = {"level_fusion_1": "fuse_td", "level_fusion_2": "fuse_bu"}


def _tpn_path(parts: List[str]) -> Tuple[str, ...]:
    head = parts[0]
    if head == "spatial_modulation":
        i, j = parts[2], parts[3]
        return _conv_bn(parts[4:], f"sm{i}_conv{j}", f"sm{i}_bn{j}")
    if head == "temporal_modulation_ops":
        return (f"tm{parts[1]}", "conv")
    if head == "downsample_ops":
        return (f"down{parts[1]}",)
    if head in _TPN_LF:
        if parts[1] == "downsamples":
            i = parts[2]
            return (_TPN_LF[head],) + _conv_bn(parts[4:], f"down{i}",
                                               f"down_bn{i}")
        return (_TPN_LF[head],) + _conv_bn(parts[2:], "fusion", "fusion_bn")
    if head == "pyramid_fusion":
        return _conv_bn(parts[1:], "pyramid_fusion", "pyramid_bn")
    if parts[1] == "conv":                          # aux_head.conv
        return _conv_bn(parts[2:], "aux_conv", "aux_bn")
    return ("aux_fc",)


def _head_path(head, parts: List[str]) -> Tuple[str, ...]:
    """cls_head.* below the recognizer: TRNHead's relation MLPs by the JAX
    names, TPNRecognizer's fc as the Dense `cls_head`, the rest as they
    are (fc_cls, fc1, fc2)."""
    from ..models.heads import TRNHead
    if isinstance(head, TRNHead) and parts[0] == "consensus":
        fc = "fc1" if parts[-1] == "1" else "fc2"
        if parts[1] == "classifier":
            return ("cls_head", f"relation_{fc}")
        scale = head.num_segments - int(parts[2])
        return ("cls_head", f"fusion_s{scale}_{fc}")
    return ("cls_head",) + tuple(parts)


def _backbone_path(backbone, parts: List[str]) -> Tuple[str, ...]:
    from ..models import backbones2d, resnet3d, tanet, tin_mobilenet
    if isinstance(backbone, (backbones2d.TSMResNet, tin_mobilenet.TINResNet,
                             tin_mobilenet.TINResNetExact)):
        return _tsm_path(parts)
    if isinstance(backbone, tin_mobilenet.MobileNetV2TSM):
        return _mobilenet_path(backbone, parts)
    if isinstance(backbone, tanet.TANet):
        return _tanet_path(parts)
    if isinstance(backbone, backbones2d.C3D):
        return (parts[0],)                      # conv{k}.conv, fc6, fc7
    if isinstance(backbone, backbones2d.R2Plus1D):
        return _r2plus1d_path(parts)
    if isinstance(backbone, resnet3d.ResNet3D):
        return _resnet3d_path(parts)
    if isinstance(backbone, resnet3d.SlowFast):
        return _slowfast_path(parts)
    if isinstance(backbone, resnet3d.CSN):
        return _csn_path(parts, backbone.cfg.mode == "ip")
    if isinstance(backbone, resnet3d.X3D):
        return _x3d_path(parts)
    inner = getattr(backbone, "inner", None)    # the temporal-mean adapter
    if inner is not None and parts[0] == "inner":
        return ("inner",) + _backbone_path(inner, parts[1:])
    raise TypeError(f"no JAX layout for {type(backbone).__name__}")


_CONVS = (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Conv3d)


def _ava_head_path(parts: List[str]) -> Tuple[str, ...]:
    """An AVA detector's `roi_head.*` below the detector: flax keeps the
    shared head (ACRN's convs and BatchNorms, FBO's `fbo`) at the top of
    the tree beside `roi_head`, which holds `fc_cls` alone."""
    if parts[0] == "shared_head":
        return tuple(parts)
    return ("roi_head",) + tuple(parts)


# the skeleton backbones (models/stgcn.py): the reference module under a
# block -> its JAX name (convert_stgcn, convert_agcn)
_STGCN_BLOCK = {"gcn.conv": "gcn", "tcn.0": "bn_gcn", "tcn.2": "tcn",
                "tcn.3": "bn_tcn", "residual.0": "residual",
                "residual.1": "bn_res"}
_AGCN_BLOCK = {"gcn.bn": "bn_gcn", "gcn.down.0": "down",
               "gcn.down.1": "bn_down", "tcn.0": "tcn", "tcn.1": "bn_tcn",
               "residual.0": "residual", "residual.1": "bn_res"}
_DENSE_1X1 = ("gcn", "down", "fc_cls") + tuple(
    f"conv_{c}" for c in "abd")


def _skeleton_path(parts: List[str]) -> Tuple[str, ...]:
    """A GCN backbone's module or parameter path -> its JAX path."""
    if parts[0] == "data_bn":
        return ("data_bn",)
    if parts[0] == "edge_importance":
        return (f"block_{parts[1]}", "edge_importance")
    block, rest = f"block_{parts[1]}", ".".join(parts[2:])
    if rest == "gcn.PA":
        return (block, "PA")
    if parts[2:4] in (["gcn", "conv_a"], ["gcn", "conv_b"],
                      ["gcn", "conv_d"]):
        return (block, parts[3] + parts[4])
    table = _STGCN_BLOCK if parts[0] == "st_gcn_networks" else _AGCN_BLOCK
    return (block, table[rest])


def _skeleton_table(model) -> List[Tuple[str, Tuple[str, ...], str]]:
    """_cnn_table for an ST-GCN or AGCN backbone alone or under
    SkeletonClassifier: kind 'dense' for the 1x1 Conv2d that are Dense
    layers in JAX (gcn, conv_{a,b,d}, down, the head's fc), 'conv' for the
    temporal and residual convs, 'bn', and 'param' for the edge masks and
    PA (the graph buffer `A` goes to the config, not the tree)."""
    from ..models.layers import FlaxBatchNorm
    wrapped = hasattr(model, "backbone")
    table = []
    for name, mod in model.named_modules():
        if not isinstance(mod, (torch.nn.Conv2d, FlaxBatchNorm)):
            continue
        parts = name.split(".")
        if parts[0] == "cls_head":
            path = ("cls_head", "fc_cls")
        else:
            path = _skeleton_path(parts[1:] if wrapped else parts)
            path = (("backbone",) if wrapped else ()) + path
        kind = ("bn" if isinstance(mod, FlaxBatchNorm)
                else "dense" if path[-1].startswith(_DENSE_1X1) else "conv")
        table.append((name, path, kind))
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "PA" or "edge_importance" in parts:
            inner = parts[1:] if wrapped else parts
            table.append((name, (("backbone",) if wrapped else ())
                          + _skeleton_path(inner), "param"))
    return table


def _cnn_table(model) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(the port module's name, its JAX path, kind) for every conv,
    linear and BatchNorm of a CNN backbone or recognizer (or a TPN neck
    alone), and of an AVA detector (train/detection_trainer.AVAFastRCNN)
    with its heads.  kind: 'conv' (Conv1d/2d/3d, with its bias if it has
    one), 'se' (an SE fc as a Dense), 'dense' (Linear), 'bn', 'ln' (the
    FBO's LayerNorms).  The RNN decoder head is apart.  A skeleton model
    takes `_skeleton_table`."""
    from ..models.decoder_head import RNNDecoderHead
    from ..models.stgcn import is_skeleton_model
    if is_skeleton_model(model):
        return _skeleton_table(model)
    from ..models.flax_nn import LayerNorm
    from ..models.layers import FlaxBatchNorm
    from ..models.recognizer import TPNRecognizer
    from ..models.tpn import TPN
    wrapped = hasattr(model, "backbone")
    backbone = model.backbone if wrapped else model
    detector = wrapped and hasattr(model, "roi_head")
    decoder = wrapped and not detector and isinstance(model.cls_head,
                                                      RNNDecoderHead)
    kinds = _CONVS + (torch.nn.Linear, FlaxBatchNorm) + (
        (LayerNorm,) if detector else ())
    table = []
    for name, mod in model.named_modules():
        if not isinstance(mod, kinds):
            continue
        parts = name.split(".")
        if isinstance(model, TPN):
            path = _tpn_path(parts)
        elif not wrapped:
            path = _backbone_path(backbone, parts)
        elif parts[0] == "backbone":
            path = ("backbone",) + _backbone_path(backbone, parts[1:])
        elif detector:
            path = _ava_head_path(parts[1:])
        elif parts[0] == "neck":
            path = ("neck",) + _tpn_path(parts[1:])
        elif decoder:
            continue
        elif isinstance(model, TPNRecognizer):
            path = ("cls_head",)       # the JAX Dense `cls_head`
        else:
            path = _head_path(model.cls_head, parts[1:])
        kind = ("bn" if isinstance(mod, FlaxBatchNorm)
                else "ln" if isinstance(mod, LayerNorm)
                else "dense" if isinstance(mod, torch.nn.Linear)
                else "se" if "se_module" in parts else "conv")
        table.append((name, path, kind))
    return table


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_put(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def conv_recognizer_state_dict_from_jax(variables: Dict[str, Any], model
                                        ) -> Dict[str, torch.Tensor]:
    """A JAX CNN model's variables ({"params"[, "batch_stats"]}) -> the
    port's fp32 state dict, for `model`: a port backbone (ResNet3D, CSN,
    SlowFast, X3D, TSMResNet, TINResNet, TINResNetExact, MobileNetV2TSM,
    TANet, C3D, R2Plus1D), a TPN neck or a recognizer
    (BackboneClassifier, X3DClassifier, RecognizerRelseq, Recognizer2D,
    TPNRecognizer) whose module tree names the keys (a meta-device copy
    will do).  Without "batch_stats" only the parameters come back
    (an optimizer's moments).  A transformer model (`is_transformer_model`)
    goes through `transformer_state_dict_from_jax`."""
    if is_transformer_model(model):
        return transformer_state_dict_from_jax(variables, model)
    params = variables.get("params", variables)
    stats = variables.get("batch_stats")
    sd: Dict[str, torch.Tensor] = {}
    for name, path, kind in _cnn_table(model):
        p = _tree_get(params, path)
        if kind == "param":
            sd[name] = _f32(p)
            continue
        if kind in ("bn", "ln"):
            sd[f"{name}.weight"] = _f32(p["scale"])
            sd[f"{name}.bias"] = _f32(p["bias"])
            continue
        k = _f32(p["kernel"])
        if kind == "conv":             # (*kernel, in, out) -> (out, in, *)
            sd[f"{name}.weight"] = k.permute(
                k.dim() - 1, k.dim() - 2, *range(k.dim() - 2)).contiguous()
        elif kind == "se":
            sd[f"{name}.weight"] = k.t()[:, :, None, None, None].contiguous()
        elif isinstance(model.get_submodule(name), torch.nn.Conv2d):
            sd[f"{name}.weight"] = k.t()[:, :, None, None].contiguous()
        else:
            sd[f"{name}.weight"] = k.t().contiguous()
        if "bias" in p:
            sd[f"{name}.bias"] = _f32(p["bias"])
    if "cls_head" in params and "start_emb" in params["cls_head"]:
        _decoder_from_jax(sd, params["cls_head"])
    if stats is not None:
        sd.update(conv_batch_stats_from_jax(stats, model))
        _skeleton_graph(sd, model)
    return sd


def _skeleton_graph(sd: Dict[str, torch.Tensor], model) -> None:
    """A skeleton model's graph buffer, which the JAX tree leaves to the
    config, from the model's config (so the state dict loads strictly)."""
    from ..models.stgcn import is_skeleton_model, reference_graph
    if is_skeleton_model(model):
        backbone = getattr(model, "backbone", model)
        key = "backbone.A" if backbone is not model else "A"
        sd[key] = torch.from_numpy(reference_graph(backbone.cfg))


def conv_batch_stats_from_jax(stats: Dict[str, Any], model
                              ) -> Dict[str, torch.Tensor]:
    """A JAX 3D-CNN model's batch_stats -> the port's BatchNorm buffers
    (running mean and variance, num_batches_tracked 0) for `model`."""
    sd: Dict[str, torch.Tensor] = {}
    for name, path, kind in _cnn_table(model):
        if kind == "bn":
            st = _tree_get(stats, path)
            sd[f"{name}.running_mean"] = _f32(st["mean"])
            sd[f"{name}.running_var"] = _f32(st["var"])
            sd[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
    return sd


def conv_recognizer_variables_to_jax(sd: Dict[str, torch.Tensor], model
                                     ) -> Dict[str, Any]:
    """The inverse: the port's state dict (or {parameter name: tensor})
    -> {"params"[, "batch_stats"]} as numpy f32, the tree the JAX module
    holds; "batch_stats" when the dict carries the running statistics.
    A transformer model (`is_transformer_model`) goes through
    `transformer_variables_to_jax`."""
    if is_transformer_model(model):
        return transformer_variables_to_jax(sd, model)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, path, kind in _cnn_table(model):
        if kind == "param":
            _tree_put(params, path, _np32(sd[name]))
            continue
        if kind in ("bn", "ln"):
            _tree_put(params, path, {"scale": _np32(sd[f"{name}.weight"]),
                                     "bias": _np32(sd[f"{name}.bias"])})
            if f"{name}.running_mean" in sd:
                _tree_put(stats, path,
                          {"mean": _np32(sd[f"{name}.running_mean"]),
                           "var": _np32(sd[f"{name}.running_var"])})
            continue
        w = _np32(sd[f"{name}.weight"])
        leaf = {"kernel": (w.transpose(*range(2, w.ndim), 1, 0)
                           if kind == "conv"
                           else w[..., 0, 0, 0].T if kind == "se"
                           else w.reshape(w.shape[0], -1).T)}
        if f"{name}.bias" in sd:
            leaf["bias"] = _np32(sd[f"{name}.bias"])
        _tree_put(params, path, leaf)
    if "cls_head.start_emb.weight" in sd:
        params["cls_head"] = _decoder_to_jax(sd)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def _conv_backbone_fns(family: str, module: str = "resnet3d"):
    def build(cfg):
        import importlib
        mod = importlib.import_module(f"..models.{module}", __package__)
        return getattr(mod, family)(cfg, device="meta")

    def state_dict_from_jax(variables: Dict[str, Any], cfg
                            ) -> Dict[str, torch.Tensor]:
        return conv_recognizer_state_dict_from_jax(variables, build(cfg))

    def variables_to_jax(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, Any]:
        return conv_recognizer_variables_to_jax(sd, build(cfg))

    state_dict_from_jax.__doc__ = (
        f"A JAX {family}'s variables -> the port's {family} state dict "
        f"(cfg: its config).")
    variables_to_jax.__doc__ = (
        f"The port's {family} state dict -> the JAX {family}'s "
        f"{{'params', 'batch_stats'}} (cfg: its config).")
    return state_dict_from_jax, variables_to_jax


resnet3d_state_dict_from_jax, resnet3d_variables_to_jax = \
    _conv_backbone_fns("ResNet3D")
csn_state_dict_from_jax, csn_variables_to_jax = _conv_backbone_fns("CSN")
slowfast_state_dict_from_jax, slowfast_variables_to_jax = \
    _conv_backbone_fns("SlowFast")
x3d_state_dict_from_jax, x3d_variables_to_jax = _conv_backbone_fns("X3D")
tsm_state_dict_from_jax, tsm_variables_to_jax = \
    _conv_backbone_fns("TSMResNet", "backbones2d")
r2plus1d_state_dict_from_jax, r2plus1d_variables_to_jax = \
    _conv_backbone_fns("R2Plus1D", "backbones2d")
tin_state_dict_from_jax, tin_variables_to_jax = \
    _conv_backbone_fns("TINResNet", "tin_mobilenet")
tin_exact_state_dict_from_jax, tin_exact_variables_to_jax = \
    _conv_backbone_fns("TINResNetExact", "tin_mobilenet")
mobilenetv2_tsm_state_dict_from_jax, mobilenetv2_tsm_variables_to_jax = \
    _conv_backbone_fns("MobileNetV2TSM", "tin_mobilenet")
tanet_state_dict_from_jax, tanet_variables_to_jax = \
    _conv_backbone_fns("TANet", "tanet")
tpn_state_dict_from_jax, tpn_variables_to_jax = \
    _conv_backbone_fns("TPN", "tpn")
stgcn_state_dict_from_jax, stgcn_variables_to_jax = \
    _conv_backbone_fns("STGCN", "stgcn")
agcn_state_dict_from_jax, agcn_variables_to_jax = \
    _conv_backbone_fns("AGCN", "stgcn")


# -- the transformer and CLIP backbones (Swin3D, MViT, VideoMAE, VideoCLIP,
# Recognizer3DCLIP), both ways ------------------------------------------------
# Every key of the port's state dict names a JAX leaf: its module path
# renamed (`_jax_owner`) and its leaf mapped by the module's kind (a Linear's
# weight is the Dense kernel transposed, a conv's the flax kernel permuted,
# a LayerNorm's the scale; CLIP's in_proj splits into q_proj, k_proj and
# v_proj).  The keys are the importers' where one exists (convert_swin3d,
# convert_videomae, convert_clip_vit's resblocks), the JAX tree's where none
# does (MViT, VideoCLIP); so these functions invert the importers.

def _clip_blocks(parts: List[str]) -> List[str]:
    """A port CLIP Transformer's module path -> the JAX one."""
    if not parts:
        return []
    out = [f"resblock_{parts[1]}"]
    rest = parts[2:]
    if rest[:1] in (["ln_1"], ["ln_2"]):
        return out + [rest[0], "ln"]
    if rest[:1] == ["mlp"]:
        return out + rest[1:]
    return out + rest


def _jax_owner(root, parts: List[str]) -> List[str]:
    """The JAX module path of the port module at `parts` under `root`."""
    from ..models import clip, mvit, recognizer, swin3d, videoclip
    from ..models import videomae_vit
    if isinstance(root, recognizer.Recognizer3DCLIP):
        return (["clip_vision"] + _jax_owner(root.clip_vision, parts[1:])
                if parts[:1] == ["clip_vision"] else parts)
    if hasattr(root, "backbone"):
        return (["backbone"] + _jax_owner(root.backbone, parts[1:])
                if parts[:1] == ["backbone"] else parts)
    if isinstance(root, videoclip.VideoCLIPPooled):
        return ["videoclip"] + _jax_owner(root.videoclip, parts[1:])
    if isinstance(root, swin3d.Swin3D):
        if parts[:1] == ["patch_embed"]:
            return ["patch_embed" if parts[1] == "proj" else "patch_norm"]
        if parts[:1] == ["layers"]:
            i, rest = parts[1], parts[3:]
            if parts[2] == "downsample":
                return [f"merge{i}"] + rest
            return [f"stage{i}_block{rest[0]}"] + [
                p for p in rest[1:] if p != "mlp"]
        return parts
    if isinstance(root, videomae_vit.VideoMAEViT):
        if parts[:1] == ["patch_embed"]:
            return ["patch_embed"]
        if parts[:1] == ["blocks"]:
            return [f"block_{parts[1]}"] + [p for p in parts[2:]
                                             if p != "mlp"]
        return parts
    if isinstance(root, (videoclip.VideoCLIP, clip.VisionTower)):
        if parts[:1] in (["video_transformer"], ["text_transformer"],
                         ["transformer"]):
            return parts[:1] + _clip_blocks(parts[1:])
        if parts[:1] in (["ln_video"], ["ln_text"], ["ln_pre"], ["ln_post"]):
            return parts + ["ln"]
        return parts
    if isinstance(root, mvit.MViT):
        return parts
    raise TypeError(f"no JAX layout for {type(root).__name__}")


def _tx_table(model) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(port key, JAX path, kind) for every key of a transformer model's
    state dict but the RNN decoder's; kind: 'kernel' (a Linear's weight),
    'conv' (a conv weight), 'inproj_w'/'inproj_b' (CLIP's fused q/k/v;
    the path names the attention), 'id' (as it is)."""
    from ..models import clip
    from ..models.decoder_head import RNNDecoderHead
    from ..models.flax_nn import LayerNorm
    from ..models.videomae_vit import _MAEAttention
    head = getattr(model, "cls_head", None)
    rows = []
    for key in model.state_dict():
        if isinstance(head, RNNDecoderHead) and key.startswith("cls_head."):
            continue
        owner, _, leaf = key.rpartition(".")
        parts = owner.split(".") if owner else []
        mod = model.get_submodule(owner)
        path = _jax_owner(model, parts)
        if isinstance(mod, (torch.nn.Linear,)):
            path, kind = path + ["kernel" if leaf == "weight" else leaf], \
                "kernel" if leaf == "weight" else "id"
        elif isinstance(mod, _CONVS + (clip.PatchEmbed,)):
            path, kind = path + ["kernel" if leaf == "weight" else leaf], \
                "conv" if leaf == "weight" else "id"
        elif isinstance(mod, (LayerNorm, clip.LayerNormF32)):
            path, kind = path + ["scale" if leaf == "weight" else leaf], "id"
        elif isinstance(mod, clip.MHA):
            kind = "inproj_w" if leaf == "in_proj_weight" else "inproj_b"
        elif parts[-1:] == ["qkv"] and isinstance(
                model.get_submodule(".".join(parts[:-1])), _MAEAttention):
            path, kind = path[:-1] + ["qkv_weight"], "kernel"
        else:
            path, kind = path + ["rel_pos_bias" if leaf ==
                                 "relative_position_bias_table" else leaf], \
                "id"
        rows.append((key, tuple(path), kind))
    return rows


_QKV = ("q_proj", "k_proj", "v_proj")


def transformer_state_dict_from_jax(variables: Dict[str, Any], model
                                    ) -> Dict[str, torch.Tensor]:
    """A JAX transformer model's variables ({"params"} or the params
    themselves) -> the port's fp32 state dict for `model`: a Swin3D,
    MViT, VideoMAEViT, VideoCLIP or CLIP VisionTower, alone, under
    BackboneClassifier or RecognizerRelseq (VideoCLIP behind
    VideoCLIPPooled), or Recognizer3DCLIP; its module tree names the keys
    (a meta-device copy will do)."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for key, path, kind in _tx_table(model):
        if kind in ("inproj_w", "inproj_b"):
            at = _tree_get(params, path)
            sd[key] = (torch.cat([_f32(at[n]["kernel"]).t() for n in _QKV])
                       if kind == "inproj_w" else
                       torch.cat([_f32(at[n]["bias"]) for n in _QKV]))
            continue
        a = _f32(_tree_get(params, path))
        if kind == "kernel":
            a = a.t()
        elif kind == "conv":              # (*kernel, in, out) -> (out, in, *)
            a = a.permute(a.dim() - 1, a.dim() - 2, *range(a.dim() - 2))
        sd[key] = a.contiguous()
    if "cls_head" in params and "start_emb" in params["cls_head"]:
        _decoder_from_jax(sd, params["cls_head"])
    return sd


def transformer_variables_to_jax(sd: Dict[str, torch.Tensor], model
                                 ) -> Dict[str, Any]:
    """The inverse: the port's state dict (or {parameter name: tensor})
    -> {"params"} as numpy f32, the tree the JAX module holds."""
    params: Dict[str, Any] = {}
    for key, path, kind in _tx_table(model):
        w = _np32(sd[key])
        if kind in ("inproj_w", "inproj_b"):
            d = w.shape[0] // 3
            for i, n in enumerate(_QKV):
                _tree_put(params, path + (n, "kernel" if kind == "inproj_w"
                                          else "bias"),
                          w[i * d:(i + 1) * d].T if kind == "inproj_w"
                          else w[i * d:(i + 1) * d])
            continue
        if kind == "kernel":
            w = w.T
        elif kind == "conv":
            w = w.transpose(*range(2, w.ndim), 1, 0)
        _tree_put(params, path, np.array(w, order="C"))
    if "cls_head.start_emb.weight" in sd:
        params["cls_head"] = _decoder_to_jax(sd)
    return {"params": params}


def is_transformer_model(model) -> bool:
    """A model `transformer_*_jax` carries (one of the 8c families)."""
    from ..models import clip, mvit, recognizer, swin3d, videoclip
    from ..models import videomae_vit
    families = (swin3d.Swin3D, mvit.MViT, videomae_vit.VideoMAEViT,
                videoclip.VideoCLIP, videoclip.VideoCLIPPooled,
                clip.VisionTower, recognizer.Recognizer3DCLIP)
    return isinstance(model, families) or isinstance(
        getattr(model, "backbone", None), families)


def _tx_backbone_fns(family: str, module: str):
    def build(cfg):
        import importlib
        mod = importlib.import_module(f"..models.{module}", __package__)
        return getattr(mod, family)(cfg, device="meta")

    def state_dict_from_jax(variables: Dict[str, Any], cfg
                            ) -> Dict[str, torch.Tensor]:
        return transformer_state_dict_from_jax(variables, build(cfg))

    def variables_to_jax(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, Any]:
        return transformer_variables_to_jax(sd, build(cfg))

    state_dict_from_jax.__doc__ = (
        f"A JAX {family}'s variables -> the port's {family} state dict "
        f"(cfg: its config).")
    variables_to_jax.__doc__ = (
        f"The port's {family} state dict -> the JAX {family}'s {{'params'}} "
        f"(cfg: its config).")
    return state_dict_from_jax, variables_to_jax


swin3d_state_dict_from_jax, swin3d_variables_to_jax = \
    _tx_backbone_fns("Swin3D", "swin3d")
mvit_state_dict_from_jax, mvit_variables_to_jax = \
    _tx_backbone_fns("MViT", "mvit")
videomae_state_dict_from_jax, videomae_variables_to_jax = \
    _tx_backbone_fns("VideoMAEViT", "videomae_vit")
videoclip_state_dict_from_jax, videoclip_variables_to_jax = \
    _tx_backbone_fns("VideoCLIP", "videoclip")


def clip_recognizer_state_dict_from_jax(variables: Dict[str, Any],
                                        clip_cfg, num_classes: int
                                        ) -> Dict[str, torch.Tensor]:
    """A JAX Recognizer3DCLIP's variables -> the port's state dict."""
    from ..models.recognizer import Recognizer3DCLIP
    return transformer_state_dict_from_jax(
        variables, Recognizer3DCLIP(clip_cfg, num_classes, device="meta"))


def clip_recognizer_variables_to_jax(sd: Dict[str, torch.Tensor], clip_cfg,
                                     num_classes: int) -> Dict[str, Any]:
    """The port's Recognizer3DCLIP state dict -> the JAX one's
    {"params"}."""
    from ..models.recognizer import Recognizer3DCLIP
    return transformer_variables_to_jax(
        sd, Recognizer3DCLIP(clip_cfg, num_classes, device="meta"))


# -- the localizers (BMN, BSN's TEM and PEM, the SSN head) --------------------

def localizer_state_dict_from_jax(variables: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """A JAX localizer's {"params": {name: {"kernel", "bias"}}} -> the
    port's state dict: each kernel's last two axes (in, out) brought to
    the front as (out, in), its kernel axes after them."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in variables["params"].items():
        k = np.asarray(p["kernel"])
        n = k.ndim
        sd[f"{name}.weight"] = _t(np.transpose(k, (n - 1, n - 2)
                                                + tuple(range(n - 2))))
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def localizer_variables_to_jax(sd: Dict[str, torch.Tensor]
                               ) -> Dict[str, Any]:
    """The inverse of localizer_state_dict_from_jax, as numpy f32."""
    params: Dict[str, Any] = {}
    for key in sd:
        name, leaf = key.rsplit(".", 1)
        a = _np32(sd[key])
        if leaf == "weight":
            params.setdefault(name, {})["kernel"] = np.ascontiguousarray(
                np.transpose(a, tuple(range(2, a.ndim)) + (1, 0)))
        else:
            params.setdefault(name, {})["bias"] = a
    return {"params": params}


bmn_state_dict_from_jax = tem_state_dict_from_jax = \
    pem_state_dict_from_jax = ssn_head_state_dict_from_jax = \
    localizer_state_dict_from_jax
bmn_variables_to_jax = tem_variables_to_jax = pem_variables_to_jax = \
    ssn_head_variables_to_jax = localizer_variables_to_jax


# -- the AVA detectors (AVAFastRCNN with the RoI head, ACRN or FBO) ----------

def ava_detector_state_dict_from_jax(variables: Dict[str, Any], model
                                     ) -> Dict[str, torch.Tensor]:
    """A JAX AVAFastRCNN's {"params"[, "batch_stats"]} -> the port's fp32
    state dict for `model` (an AVAFastRCNN; a meta-device copy will do):
    the backbone through the ResNet3D or SlowFast layout, `roi_head/fc_cls`,
    and the shared head from the top of the tree (`shared_head/{conv1,
    bn1, conv2, bn2, ...}` with its batch_stats for ACRN,
    `shared_head/fbo/...` for FBO)."""
    return conv_recognizer_state_dict_from_jax(variables, model)


def ava_detector_variables_to_jax(sd: Dict[str, torch.Tensor], model
                                  ) -> Dict[str, Any]:
    """The inverse: {"params"[, "batch_stats"]} as numpy f32."""
    return conv_recognizer_variables_to_jax(sd, model)

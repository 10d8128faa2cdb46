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
  patch embed is the Conv3d `patch_embed.projection`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
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
    sd["cls_head.start_emb.weight"] = _t(head["start_emb"])
    for torch_name, jax_name, transpose in (
            ("weight_ih_l0", "rnn_wi", True), ("bias_ih_l0", "rnn_bi", False),
            ("weight_hh_l0", "rnn_wh", True), ("bias_hh_l0", "rnn_bh", False)):
        a = np.asarray(head[jax_name])
        sd[f"cls_head.rnn.{torch_name}"] = _t(a.T if transpose else a)
    sd["cls_head.out.weight"] = _t(np.asarray(head["out_kernel"]).T)
    sd["cls_head.out.bias"] = _t(head["out_bias"])
    return sd

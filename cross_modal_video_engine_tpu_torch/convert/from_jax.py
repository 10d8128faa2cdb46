"""JAX package parameters -> the port's state dict.

`clip_state_dict_from_jax` is the exact inverse of
cross_modal_video_engine_tpu.convert.torch_import.convert_clip_vit (with
its `_resblock`): it turns the JAX CLIPModel's variables, given as numpy
arrays, into the OpenAI-layout state dict that
cross_modal_video_engine_tpu_torch.models.clip.CLIPModel loads, so both
packages compute the same function.
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


def _resblock(sd: Dict[str, torch.Tensor], prefix: str,
              p: Dict[str, Any]) -> None:
    _ln(sd, f"{prefix}.ln_1", p["ln_1"])
    _ln(sd, f"{prefix}.ln_2", p["ln_2"])
    at = p["attn"]
    sd[f"{prefix}.attn.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(at[n]["kernel"]).T
         for n in ("q_proj", "k_proj", "v_proj")], 0))
    sd[f"{prefix}.attn.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(at[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]))
    _linear(sd, f"{prefix}.attn.out_proj", at["out_proj"])
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

"""Inference-precision helpers.

Counterpart of cross_modal_video_engine_tpu/utils/precision.py.  The JAX
package casts every floating leaf of a checkpoint loaded for inference
to bf16 when the backbone config says dtype='bfloat16'; without the cast
its `Dense(dtype=None)` layers (TimeSformer's FFN and temporal_fc, the
heads) would promote back to f32.  `maybe_cast_bf16` is the same rule
on a state dict, which the loader (api.init_recognizer) applies before
loading, and `maybe_cast_model_bf16` on a module: the TimeSformer
recognizers keep f32 masters whatever their config says, so the loader
casts the model itself, which then computes what the JAX package
computes on the cast tree.
"""

from __future__ import annotations

from typing import Dict

import torch


def cast_inference_state_dict(state_dict: Dict[str, torch.Tensor],
                              dtype: torch.dtype = torch.bfloat16
                              ) -> Dict[str, torch.Tensor]:
    """Every floating tensor cast to `dtype` (round to nearest even);
    integer entries pass through."""
    if dtype == torch.float32:
        return state_dict
    return {k: v.to(dtype) if torch.is_floating_point(v) else v
            for k, v in state_dict.items()}


def maybe_cast_bf16(state_dict: Dict[str, torch.Tensor],
                    cfg_d: dict) -> Dict[str, torch.Tensor]:
    """Cast to bf16 iff the backbone config says dtype='bfloat16'."""
    if cfg_d.get("backbone", {}).get("dtype") == "bfloat16":
        return cast_inference_state_dict(state_dict)
    return state_dict


def maybe_cast_model_bf16(model: torch.nn.Module,
                          cfg_d: dict) -> torch.nn.Module:
    """The model's floating parameters and buffers cast to bf16 in place
    iff the backbone config says dtype='bfloat16'; returns the model."""
    if cfg_d.get("backbone", {}).get("dtype") == "bfloat16":
        model.to(torch.bfloat16)
    return model


def no_tf32() -> None:
    """f32 matmuls and cuDNN convolutions in f32, not TF32, in this
    process (cuDNN's default is TF32), so the f32 models on the card agree
    with the CPU and the JAX package to f32 tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

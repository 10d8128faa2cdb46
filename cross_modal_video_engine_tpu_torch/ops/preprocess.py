"""Frame preprocessing on the device.

Counterpart of cross_modal_video_engine_tpu/ops/preprocess.py: uint8
frames go to the device once, and dequantize -> pad -> resize -> crop ->
normalize -> cast run there as plain torch (the JAX package has no kernel
here; XLA fuses these ops).

The resizes compute what `jax.image.resize` computes, not what
`F.interpolate` does: one (in, out) weight matrix per axis from
`jax.image.scale_and_translate`'s formula (half-pixel centres; the kernel
widened by in/out when shrinking, which is its antialiasing; the weights of
each output renormalized over the taps that fall inside the input;
outputs whose centre falls outside the input zeroed), contracted over H
then W in f32.  Its cubic kernel is Keys' with a = -0.5
(`F.interpolate(mode="bicubic")` has a = -0.75 and no antialiasing).  The
output sizes use Python's `round`, as the JAX code does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# public CLIP normalization constants (data_utils.py:83)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# mmaction TimeSformer normalize (configs/.../timesformer_*.py: mean/std 127.5)
TSF_MEAN = (127.5, 127.5, 127.5)
TSF_STD = (127.5, 127.5, 127.5)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x
                   + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out).astype(np.float32)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) f32: out[j] = sum_i x[i] * w[i, j], as
    jax.image.scale_and_translate's compute_weight_mat builds it (scale
    n_out / n_in, no translation, antialiased), in the same f32 steps."""
    f = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f(max(inv_scale, 1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + f(0.5)) * f(inv_scale)
              - f(0.0) * f(inv_scale) - f(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = _KERNELS[method](x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1)), f(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0)).astype(np.float32)


def resize(x: torch.Tensor, size: Tuple[int, int],
           method: str) -> torch.Tensor:
    """(..., H, W, C) f32 -> (..., h, w, C): jax.image.resize(x, ...,
    method) for 'bilinear' and 'bicubic'.  An axis whose size does not
    change is left as it is, as jax does."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h, w = size
    if h != h_in:
        wh = torch.from_numpy(resize_weights(h_in, h, method)).to(x.device)
        x = torch.einsum("...hwc,hk->...kwc", x, wh)
    if w != w_in:
        ww = torch.from_numpy(resize_weights(w_in, w, method)).to(x.device)
        x = torch.einsum("...hwc,wk->...hkc", x, ww)
    return x


def _resize_short_side(x: torch.Tensor, short: int) -> torch.Tensor:
    """Bilinear resize so min(H, W) == short, aspect preserved.
    x: (..., H, W, C) float."""
    h, w = x.shape[-3], x.shape[-2]
    if h <= w:
        nh, nw = short, int(round(w * short / h))
    else:
        nh, nw = int(round(h * short / w)), short
    return resize(x, (nh, nw), "bilinear")


def _center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return x[..., y0:y0 + size, x0:x0 + size, :]


def _normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def preprocess_frames(frames_u8: torch.Tensor, short_side: int = 256,
                      crop_size: int = 224,
                      mean: Tuple[float, ...] = CLIP_MEAN,
                      std: Tuple[float, ...] = CLIP_STD,
                      scale_to_unit: bool = True,
                      out_dtype: str = "bfloat16") -> torch.Tensor:
    """(F, H, W, 3) uint8 -> (F, crop, crop, 3) normalized.
    scale_to_unit: divide by 255 before mean/std (CLIP convention);
    False uses raw 0..255 pixels (mmaction mean/std 127.5 convention)."""
    x = frames_u8.to(torch.float32)
    if scale_to_unit:
        x = x / 255.0
    x = _resize_short_side(x, short_side)
    x = _center_crop(x, crop_size)
    x = _normalize(x, mean, std)
    return x.to(torch.bfloat16 if out_dtype == "bfloat16" else torch.float32)


def _pad_hw(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Zero-pad H by (ph // 2, ph - ph // 2) and W likewise."""
    return F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def _pad_to_square(x: torch.Tensor) -> torch.Tensor:
    """SquarePad (data_utils.py:23-38): symmetric zero-pad to square."""
    h, w = x.shape[-3], x.shape[-2]
    m = max(h, w)
    return _pad_hw(x, m - h, m - w)


def _target_pad(x: torch.Tensor, target_ratio: float) -> torch.Tensor:
    """TargetPad (data_utils.py:71-101): pad only when the aspect ratio
    exceeds target_ratio, to bring it back to target_ratio."""
    h, w = x.shape[-3], x.shape[-2]
    actual = max(h, w) / min(h, w)
    if actual < target_ratio:
        return x
    scaled = int(max(h, w) / target_ratio)
    return _pad_hw(x, max(scaled - h, 0), max(scaled - w, 0))


def clip_preprocess(frames_u8: torch.Tensor, dim: int = 224,
                    pad: Optional[str] = "targetpad",
                    target_ratio: float = 1.25) -> torch.Tensor:
    """The MultiFusion preprocessing pipeline (targetpad 1.25 -> bicubic
    resize -> center crop -> CLIP normalize) on the frames' device:
    (F, H, W, 3) uint8 -> (F, dim, dim, 3) bf16."""
    x = frames_u8.to(torch.float32) / 255.0
    if pad == "squarepad":
        x = _pad_to_square(x)
    elif pad == "targetpad":
        x = _target_pad(x, target_ratio)
    h, w = x.shape[-3], x.shape[-2]
    if h <= w:
        nh, nw = dim, max(dim, int(round(w * dim / h)))
    else:
        nh, nw = max(dim, int(round(h * dim / w))), dim
    x = resize(x, (nh, nw), "bicubic")
    x = _center_crop(x, dim)
    return _normalize(x, CLIP_MEAN, CLIP_STD).to(torch.bfloat16)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/p * W/p, p*p*C), tokens in (p, p, C)
    row-major order, grid in row-major order."""
    *lead, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(*lead, gh, patch, gw, patch, c)
    nd = x.dim()
    # (..., gh, p, gw, p, C) -> (..., gh, gw, p, p, C)
    perm = list(range(nd - 5)) + [nd - 5, nd - 3, nd - 4, nd - 2, nd - 1]
    return x.permute(*perm).reshape(*lead, gh * gw, patch * patch * c)

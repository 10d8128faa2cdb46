"""Flash attention: the CUDA kernel and its plain version.

Counterpart of cross_modal_video_engine_tpu/ops/flash_attention.py:
softmax(q kᵀ · sm_scale) v over (B, H, S, D) with fp32 softmax
statistics, never materialising the (Sq, Skv) scores on the card.

* `flash_attention(q, k, v, sm_scale, causal)`: (B, H, Sq, D) queries
  against (B, H, Skv, D) keys and values.  Under `causal`, query row r
  sees keys 0..r: the mask is aligned at the top left when Sq != Skv.
* `mha_flash`: the (B, S, D_model) wrapper that splits and merges heads.

Dispatch, as in ops/attention_sublayer.py: a CPU tensor runs the plain
version (`_reference_attention`); a CUDA tensor launches csrc/
flash_attention.cu or the call raises.  Nothing falls back.  With grad
mode on and an input that requires grad, the forward still launches the
kernel and the backward differentiates the plain version, as the JAX
custom_vjp does (`_PlainBackward`); there is no backward kernel.
`flash_attention.launches` counts the calls that launched the kernel.

The kernel takes float32 or bfloat16 and head dims that are multiples of
16 up to 128.  `kernel_path` says which of its three paths serves a dtype
and head dim: bfloat16 at head dim 64 or 128 runs the Hopper design
(wgmma for both products, K/V tiles of 128 keys arriving by TMA on
mbarriers, a producer warpgroup and two consumer warpgroups of 64 query
rows); bfloat16 at the other head dims runs the mma.sync kernel;
float32 runs on the CUDA cores.  The routing is decided before the
launch from dtype and head dim alone.  The kernel reads strided
(B, H, S, D) views whose head dimension is contiguous, so the transposed
q/k/v of an attention layer need no copy (the TMA path reads them as 4-D
tensor maps, whose strides are multiples of 16 bytes), and returns a
(B, H, Sq, D) view of (B, Sq, H, D) memory, so the head merge that
follows is a view as well.

The plain version has `_reference_attention`'s semantics: fp32 scores
and softmax, P rounded to v.dtype after normalising, fp32-accumulated
P·v rounded to v.dtype.  The kernel, like the Pallas kernel, rounds P
before normalising, so in bf16 the two differ by about a bf16 step.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from .attention_sublayer import (_DTYPE_CODES, _check, _launch,
                                 _stream)

# the JAX kernel's mask: finite, so exp(mask - m) is exactly 0
DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sm_scale: float, causal: bool) -> torch.Tensor:
    """(B, H, Sq, D), (B, H, Skv, D) -> (B, H, Sq, D) in plain torch."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        row = torch.arange(q.shape[2], device=q.device)[:, None]
        col = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(col <= row, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(v.dtype)


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention takes (B, H, S, D) q, k, v with "
                         f"k and v alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head dim")
    if min(q.shape) < 1 or k.shape[2] < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def kernel_path(dtype: torch.dtype, head_dim: int) -> str:
    """The path of csrc/flash_attention.cu that serves (dtype, head dim):
    "wgmma" (bfloat16, head dim 64 or 128: TMA ring, warp-specialised),
    "mma.sync" (bfloat16, the other head dims) or "fma" (float32, CUDA
    cores).  Raises for what no path takes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    if head_dim % 16 or not 16 <= head_dim <= 128:
        raise ValueError(f"the flash kernel takes head dims that are "
                         f"multiples of 16 up to 128, not {head_dim}")
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if head_dim in (64, 128) else "mma.sync"


def _kernel_operands(q, k, v):
    """What the kernel reads and writes: q, k, v as they are when their
    head dim is contiguous and the other strides (positive) and the
    address keep 16-byte rows, which is also what a TMA tensor map asks
    (else a contiguous copy), the output as a (B, H, Sq, D) view of
    (B, Sq, H, D) memory, and the 12 element strides."""
    vec = 16 // q.element_size()

    def fit(t):
        s = t.stride()
        if (s[3] != 1 or any(x % vec or x < 1 for x in s[:3])
                or t.data_ptr() % 16):   # a fresh, aligned allocation
            return t.clone(memory_format=torch.contiguous_format)
        return t

    q, k, v = fit(q), fit(k), fit(v)
    b, h, sq, d = q.shape
    out = q.new_empty((b, sq, h, d)).permute(0, 2, 1, 3)
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    return q, k, v, out, strides


def _flash_cuda(q, k, v, sm_scale: float, causal: bool) -> torch.Tensor:
    """csrc/flash_attention.cu on CUDA tensors."""
    from ._build import load_kernels
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernel takes q, k, v of one dtype, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    d = q.shape[3]
    kernel_path(q.dtype, d)             # raises for what no path takes
    if sm_scale < 0:    # the kernel takes sm_scale >= 0: the sign moves
        q, sm_scale = -q, -sm_scale     # into q, which is exact
    q, k, v, out, strides = _kernel_operands(q, k, v)
    b, h, sq, _ = q.shape
    with torch.cuda.device(q.device):
        err = load_kernels().lib.cmve_flash_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, sq, k.shape[2], d,
            (ctypes.c_longlong * 12)(*strides),
            float(np.float32(sm_scale)), int(causal), _stream(q))
    _check(err, "flash attention kernel")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float = 1.0, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, H, Skv, D) -> (B, H, Sq, D).

    block_q and block_k are kept for the JAX signature and not used: the
    CUDA kernel tiles by itself (`kernel_path`): 128 queries against 128
    keys on the wgmma path, 64 against 64 on the mma.sync path (32 keys
    above head dim 64) and 32 against 32 in float32."""
    del block_q, block_k
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")

    def launch(*a):
        out = _flash_cuda(*a, sm_scale, causal)
        flash_attention.launches += 1
        return out

    return _launch(launch,
                   lambda *a: _reference_attention(*a, sm_scale, causal),
                   q, k, v)


flash_attention.launches = 0


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              sm_scale: Optional[float] = None,
              causal: bool = False) -> torch.Tensor:
    """(B, S, D_model) wrapper: split heads, flash, merge (views only)."""
    b, s, dm = q.shape
    hd = dm // heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)

    def split(x):
        return x.reshape(b, -1, heads, hd).transpose(1, 2)

    out = flash_attention(split(q), split(k), split(v), sm_scale, causal)
    return out.transpose(1, 2).reshape(b, s, dm)

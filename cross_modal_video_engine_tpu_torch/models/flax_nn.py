"""flax's per-layer compute dtypes for the transformer backbones.

The JAX package keeps float32 parameters and lets each flax layer pick the
dtype it computes in:

* a layer built with an explicit `dtype=` casts its parameters and its
  input to that dtype and returns that dtype;
* a layer with `dtype=None` promotes its input with its parameters (bf16
  input and bf16 parameters compute in bf16; bf16 against f32 computes in
  f32).

Its bf16 trainer casts the parameters and the videos to bf16, so a model
whose layers name no dtype runs its first layers in bf16 and, from the
first fp32 softmax product on, in fp32.  The port's modules keep fp32
parameters whatever their config's dtype says and compute every layer
through these helpers, so they run each layer in the dtype flax would, on
f32 masters or on the trainer's bf16 copy alike.  `torch.nn.functional.
linear` refuses mismatched dtypes; `dense` promotes first.

* `acc_dtype` (ops/mixed_precision.py): fp32 accumulation, float64
  staying float64;
* `result_dtype`: jnp.result_type of tensors (None skipped);
* `dense` / `Dense`: flax's `nn.Dense` on torch's (out, in) weight;
* `LayerNorm`: flax's `nn.LayerNorm` (statistics in fp32 or wider, eps
  1e-6 by default, output in `dtype` or the promoted dtype);
* `conv3d`: flax's `nn.Conv` on channels-last (B, T, H, W, C) input with
  a torch (O, I/groups, kt, kh, kw) weight, `'SAME'` padding as flax
  computes it (`same_pads`: ceil(n/s)·s - n + k - s in all, the smaller
  half before), or explicit (lo, hi) pairs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mixed_precision import acc_dtype


def result_dtype(*tensors: Optional[torch.Tensor]) -> torch.dtype:
    """The dtype flax's `dtype=None` layers compute in: the promotion of
    their input and parameters."""
    dts = [t.dtype for t in tensors if t is not None]
    dt = dts[0]
    for d in dts[1:]:
        dt = torch.promote_types(dt, d)
    return dt


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax nn.Dense(dtype) on a torch (out, in) weight."""
    dt = dtype or result_dtype(x, weight, bias)
    return F.linear(x.to(dt), weight.to(dt),
                    None if bias is None else bias.to(dt))


class Dense(nn.Linear):
    """nn.Linear's parameters (fp32 unless told), applied as flax's Dense
    with `dtype` (None: promote)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class LayerNorm(nn.Module):
    """flax's nn.LayerNorm(epsilon, dtype) over the last axis: statistics
    and the affine map in fp32 (or wider), the output in `dtype` or, for
    None, the promotion of the input with the scale and bias."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.eps, self.compute_dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.compute_dtype or result_dtype(x, self.weight, self.bias)
        acc = acc_dtype(x.dtype, self.weight.dtype, self.bias.dtype)
        return F.layer_norm(x.to(acc), self.weight.shape,
                            self.weight.to(acc), self.bias.to(acc),
                            self.eps).to(out)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


Padding = Union[str, Sequence[Tuple[int, int]]]


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], stride: Sequence[int],
           padding: Padding = "SAME", groups: int = 1,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax nn.Conv(dtype) over channels-last (B, T, H, W, C) with a torch
    Conv3d weight; returns channels-last."""
    dt = dtype or result_dtype(x, weight, bias)
    k = weight.shape[2:]
    if padding == "SAME":
        padding = [same_pads(n, kk, s)
                   for n, kk, s in zip(x.shape[1:4], k, stride)]
    xc = x.to(dt).permute(0, 4, 1, 2, 3)
    flat = [p for pair in reversed(padding) for p in pair]
    if any(flat):
        xc = F.pad(xc, flat)
    y = F.conv3d(xc, weight.to(dt), None if bias is None else bias.to(dt),
                 stride=tuple(stride), groups=groups)
    return y.permute(0, 2, 3, 4, 1)


class Conv3d(nn.Conv3d):
    """nn.Conv3d's parameters (torch's keys), applied as flax's nn.Conv on
    channels-last input: `padding` 'SAME' (flax's default) or (lo, hi)
    pairs, `dtype` None to promote."""

    def __init__(self, cin: int, cout: int, kernel: Sequence[int],
                 stride: Sequence[int] = (1, 1, 1), padding: Padding = "SAME",
                 groups: int = 1, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(cin, cout, tuple(kernel), stride=tuple(stride),
                         groups=groups, bias=bias, device=device)
        self.flax_padding, self.compute_dtype = padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self.weight, self.bias, self.stride,
                      self.flax_padding, self.groups, self.compute_dtype)

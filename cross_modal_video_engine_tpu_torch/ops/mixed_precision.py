"""Mixed-precision products.

Counterpart of cross_modal_video_engine_tpu/ops/mixed_precision.py.
`einsum_f32acc(pattern, a, b)` is a binary einsum accumulated in fp32
(output fp32, or float64 for float64 operands) whose backward casts the
cotangent to the other operand's dtype *before* each of the two gradient
products, accumulates that product in fp32 and rounds it to the operand's
dtype: torch autocast's backward, and the JAX package's `custom_vjp`.
Plain autograd through `a.float() @ b.float()` would feed the fp32
cotangent straight into the gradient products instead, which in bf16 gives
other gradients than the JAX package's.  In fp32 the two are the same.

It is plain torch (the JAX package computes it with XLA, outside any
Pallas call), on every device.
"""

from __future__ import annotations

import torch


def _grad_patterns(pattern: str):
    ins, out = pattern.split("->")
    xa, xb = ins.split(",")
    # the gradient patterns below hold only when every operand index is
    # in the product or in the other operand (no diagonal or sum-only
    # index), as in every attention pattern
    assert set(xa) <= set(out) | set(xb), pattern
    assert set(xb) <= set(out) | set(xa), pattern
    return xa, xb, out


def acc_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """The accumulation dtype: fp32, or wider where an input is (float64
    stays float64)."""
    dt = torch.float32
    for d in dtypes:
        dt = torch.promote_types(dt, d)
    return dt


def _product(pattern: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = acc_dtype(a.dtype, b.dtype)
    return torch.einsum(pattern, a.to(acc), b.to(acc))


class _EinsumF32Acc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pattern: str, a: torch.Tensor, b: torch.Tensor):
        ctx.pattern = pattern
        ctx.save_for_backward(a, b)
        return _product(pattern, a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        xa, xb, out = _grad_patterns(ctx.pattern)
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = _product(f"{out},{xb}->{xa}", g.to(b.dtype), b).to(a.dtype)
        if ctx.needs_input_grad[2]:
            gb = _product(f"{out},{xa}->{xb}", g.to(a.dtype), a).to(b.dtype)
        return None, ga, gb


def einsum_f32acc(pattern: str, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Binary einsum, fp32 accumulation, autocast backward.  The output is
    fp32 (float64 for float64 operands); the caller casts it, as with the
    plain einsum."""
    _grad_patterns(pattern)           # validate outside autograd too
    return _EinsumF32Acc.apply(pattern, a, b)

"""Fused attention and MLP sublayers: CUDA kernels and their plain versions.

Counterpart of cross_modal_video_engine_tpu/ops/attention_sublayer.py:

* `fused_attention_sublayer`: y = x + W_o·MHA(LN(x)) + b_o on rank-3
  (B, LP, D); keys >= valid_len are masked, pad rows pass through as
  queries, causal=True adds the triangular mask (the text tower).
* `fused_attention_sublayer_compact`: the same sublayer on flat
  (B·L, D) rows with no pad rows, each sequence attending only to its own
  L rows (the vision tower).
* `fused_mlp_sublayer`: y = x + W2·quick_gelu(W1·LN(x) + b1) + b2 per
  token, over any leading shape.

Weights are in torch Linear layout, (out_features, in_features) — the
OpenAI CLIP state dict's — where the JAX functions take (in, out) kernels.

Dispatch: a CPU tensor goes to the plain version (`_attn_ref`,
`_attn_ref_flat`, `_mlp_ref`); a CUDA tensor goes to the kernels in
`csrc/` or the call raises.  Nothing falls back.  The kernels are
inference only: on a tensor that requires grad with grad mode on they
raise NotImplementedError (the JAX custom_vjp's backward comes with the
training slice).  Each public function carries `launches`, a plain int
that counts the calls which launched its kernels.

The plain versions follow the Pallas kernels' rounding points, not those
of the JAX `_attn_ref`/`_mlp_ref`: every weight, bias and the LN
scale/bias are rounded to x.dtype; LN statistics, scores, softmax and
every accumulation are fp32; q/k/v, P, the gelu output and each
projection are rounded to x.dtype; the output is rounded before the
residual add in x.dtype.
"""

from __future__ import annotations

import numpy as np
import torch

# epilogue codes of csrc/gemm.cu
_EPI_BIAS, _EPI_GELU, _EPI_RESID = 0, 1, 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _ln_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNormF32 semantics: fp32 statistics, output in x.dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.float()
            + bias.float()).to(x.dtype)


def _dense(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ w.T + b with weights rounded to a.dtype and fp32 accumulation,
    rounded once to a.dtype."""
    dt = a.dtype
    return (a.float() @ w.to(dt).float().t()
            + b.to(dt).float()).to(dt)


def _key_mask(lp: int, valid_len: int, causal: bool,
              device: torch.device) -> torch.Tensor:
    """The kernels' additive mask: -1e30 (not -inf) on masked keys."""
    col = torch.arange(lp, device=device)
    mask = torch.where(col < valid_len, 0.0, -1e30)[None, :].expand(lp, lp)
    if causal:
        row = torch.arange(lp, device=device)[:, None]
        mask = mask + torch.where(col[None, :] <= row, 0.0, -1e30)
    return mask.float()


def _attn_ref(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
              heads: int, valid_len: int, causal: bool,
              eps: float = 1e-5) -> torch.Tensor:
    """The attention sublayer on rank-3 (B, LP, D) in plain torch."""
    b, lp, d = x.shape
    dt = x.dtype
    hd = d // heads
    ln = _ln_f32(x, ln_scale.to(dt), ln_bias.to(dt), eps)
    q = _dense(ln, wq, bq).reshape(b, lp, heads, hd)
    k = _dense(ln, wk, bk).reshape(b, lp, heads, hd)
    v = _dense(ln, wv, bv).reshape(b, lp, heads, hd)
    sc = torch.einsum("bqhc,bkhc->bhqk", q.float(), k.float())
    sc = sc * float(np.float32(1.0 / np.sqrt(hd)))
    pr = torch.softmax(sc + _key_mask(lp, valid_len, causal, x.device),
                       dim=-1).to(dt)
    att = torch.einsum("bhqk,bkhc->bqhc", pr.float(), v.float()).to(dt)
    return _dense(att.reshape(b, lp, d), wo, bo) + x


def _attn_ref_flat(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo, *,
                   heads: int, seq_len: int, causal: bool,
                   eps: float = 1e-5) -> torch.Tensor:
    """The compact sublayer: _attn_ref on the (B, L, D) view of flat rows
    (no pad rows, so valid_len == seq_len)."""
    n, d = x.shape
    y = _attn_ref(x.reshape(n // seq_len, seq_len, d), ln_scale, ln_bias,
                  wq, bq, wk, bk, wv, bv, wo, bo, heads=heads,
                  valid_len=seq_len, causal=causal, eps=eps)
    return y.reshape(n, d)


def _mlp_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
             eps: float = 1e-5) -> torch.Tensor:
    """The MLP sublayer in plain torch; quick_gelu in fp32."""
    dt = x.dtype
    ln = _ln_f32(x, ln_scale.to(dt), ln_bias.to(dt), eps)
    h = ln.float() @ w1.to(dt).float().t() + b1.to(dt).float()
    h = (h * torch.sigmoid(1.702 * h)).to(dt)
    return (h.float() @ w2.to(dt).float().t()
            + b2.to(dt).float()).to(dt) + x


# ---------------------------------------------------------------------------
# CUDA path
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no sublayer kernel for device {x.device}")
    return False


def _prepare(x: torch.Tensor, *params: torch.Tensor):
    """Check what the kernels take; return x contiguous and the params
    rounded to x.dtype, contiguous, on x's device."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"sublayer kernels take float32 or bfloat16, "
                        f"not {x.dtype}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        raise NotImplementedError(
            "the CUDA sublayer kernels have no backward yet; call them "
            "under torch.no_grad()")
    x = x.contiguous()
    out = []
    for p in params:
        if p.device != x.device:
            raise ValueError(f"parameter on {p.device}, input on {x.device}")
        out.append(p.to(x.dtype).contiguous())
    for t in (x, *out):
        if t.data_ptr() % 16:
            raise ValueError("sublayer kernels need 16-byte aligned tensors")
    return x, out


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} refused the launch: CUDA error {err}")


def _layernorm(x2, lns, lnb, eps):
    """csrc/layernorm.cu: LN(x2) with fp32 statistics, in x2.dtype."""
    from ._build import load_kernels
    m, k = x2.shape
    if k % 8:
        raise ValueError(f"LayerNorm kernel needs a width divisible by 8, "
                         f"got {k}")
    if lns.shape != (k,) or lnb.shape != (k,):
        raise ValueError(f"LayerNorm scale {tuple(lns.shape)} and bias "
                         f"{tuple(lnb.shape)} for width {k}")
    out = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        err = load_kernels().lib.cmve_layernorm(
            _DTYPE_CODES[x2.dtype], x2.data_ptr(), lns.data_ptr(),
            lnb.data_ptr(), out.data_ptr(), m, k, eps, _stream(x2))
    _check(err, "layernorm kernel")
    return out


def _gemm(a, epi, mats, resid=None):
    """One launch of csrc/gemm.cu: out_i = epi(a @ w_i.T + b_i) for up to
    three (w_i, b_i) that share a; returns the outputs."""
    from ._build import load_kernels
    m, k = a.shape
    n = mats[0][0].shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"GEMM kernel needs K and N divisible by 8, got "
                         f"K={k} N={n}")
    for w, b in mats:
        if w.shape != (n, k) or b.shape != (n,):
            raise ValueError(f"GEMM shapes: w {tuple(w.shape)} b "
                             f"{tuple(b.shape)} for a {tuple(a.shape)}")
    if resid is not None and resid.shape != (m, n):
        raise ValueError(f"residual {tuple(resid.shape)} for a GEMM output "
                         f"of {(m, n)}")
    outs = [a.new_empty((m, n)) for _ in mats]
    ptrs = []
    for i in range(3):
        w, b, o = (*mats[i], outs[i]) if i < len(mats) else (None,) * 3
        ptrs += [None if t is None else t.data_ptr() for t in (w, b, o)]
    with torch.cuda.device(a.device):
        err = load_kernels().lib.cmve_gemm(
            _DTYPE_CODES[a.dtype], epi, a.data_ptr(),
            None if resid is None else resid.data_ptr(), *ptrs, len(mats),
            m, n, k, _stream(a))
    _check(err, "gemm kernel")
    return outs


def _attention_core(q, k, v, att, *, heads, seq_stride, rows, valid_len,
                    causal):
    """csrc/attention_core.cu into `att`.  The kernel refuses a head dim
    whose fp32 keys and values would not fit in shared memory."""
    from ._build import load_kernels
    lib = load_kernels().lib
    n, d = q.shape
    hd = d // heads
    if heads * hd != d:
        raise ValueError(f"heads={heads} does not divide width {d}")
    if not 1 <= valid_len <= min(rows, 256):
        raise ValueError(f"attention core takes 1 <= valid_len <= "
                         f"min(rows, 256), got valid_len={valid_len} "
                         f"rows={rows}")
    with torch.cuda.device(q.device):
        err = lib.cmve_attention_core(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            att.data_ptr(), n // seq_stride, heads, d, hd, seq_stride, rows,
            valid_len, int(causal), float(np.float32(1.0 / np.sqrt(hd))),
            _stream(q))
    _check(err, "attention core kernel")
    return att


def _attn_cuda(x2, params, *, heads, seq_stride, rows, valid_len, causal,
               eps):
    lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo = params
    if wq.shape[0] != x2.shape[1]:
        raise ValueError(f"q/k/v projections {tuple(wq.shape)} for width "
                         f"{x2.shape[1]}")
    ln = _layernorm(x2, lns, lnb, eps)
    q, k, v = _gemm(ln, _EPI_BIAS, ((wq, bq), (wk, bk), (wv, bv)))
    att = _attention_core(q, k, v, torch.empty_like(x2), heads=heads,
                          seq_stride=seq_stride, rows=rows,
                          valid_len=valid_len, causal=causal)
    return _gemm(att, _EPI_RESID, ((wo, bo),), resid=x2)[0]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def fused_attention_sublayer(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv,
                             wo, bo, *, heads: int, valid_len: int,
                             causal: bool = False,
                             eps: float = 1e-5) -> torch.Tensor:
    """x: (B, LP, D) -> (B, LP, D); rows >= valid_len are padding (masked
    as keys, passed through as queries)."""
    if _on_cpu(x):
        return _attn_ref(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo,
                         bo, heads=heads, valid_len=valid_len,
                         causal=causal, eps=eps)
    x, params = _prepare(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo,
                         bo)
    b, lp, d = x.shape
    y = _attn_cuda(x.reshape(b * lp, d), params, heads=heads,
                   seq_stride=lp, rows=lp, valid_len=valid_len,
                   causal=causal, eps=eps)
    fused_attention_sublayer.launches += 1
    return y.reshape(b, lp, d)


fused_attention_sublayer.launches = 0


def fused_attention_sublayer_compact(x, ln_scale, ln_bias, wq, bq, wk, bk,
                                     wv, bv, wo, bo, *, heads: int,
                                     seq_len: int, causal: bool = False,
                                     eps: float = 1e-5) -> torch.Tensor:
    """x: FLAT (B·seq_len, D) with no pad rows -> (B·seq_len, D)."""
    if x.shape[0] % seq_len:
        raise ValueError(f"seq_len {seq_len} must divide the row count "
                         f"{x.shape[0]}")
    if _on_cpu(x):
        return _attn_ref_flat(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv,
                              wo, bo, heads=heads, seq_len=seq_len,
                              causal=causal, eps=eps)
    x, params = _prepare(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo,
                         bo)
    y = _attn_cuda(x, params, heads=heads, seq_stride=seq_len,
                   rows=seq_len, valid_len=seq_len, causal=causal, eps=eps)
    fused_attention_sublayer_compact.launches += 1
    return y


fused_attention_sublayer_compact.launches = 0


def fused_mlp_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       eps: float = 1e-5) -> torch.Tensor:
    """y = x + W2·quick_gelu(W1·LN(x) + b1) + b2, any leading shape."""
    if _on_cpu(x):
        return _mlp_ref(x, ln_scale, ln_bias, w1, b1, w2, b2, eps=eps)
    x, (lns, lnb, w1, b1, w2, b2) = _prepare(x, ln_scale, ln_bias, w1, b1,
                                             w2, b2)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    h = _gemm(_layernorm(x2, lns, lnb, eps), _EPI_GELU, ((w1, b1),))[0]
    y = _gemm(h, _EPI_RESID, ((w2, b2),), resid=x2)[0]
    fused_mlp_sublayer.launches += 1
    return y.reshape(shape)


fused_mlp_sublayer.launches = 0

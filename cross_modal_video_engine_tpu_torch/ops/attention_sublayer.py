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
* `fused_block_sublayer_compact`: the compact attention sublayer, then the
  MLP sublayer, as one kernel launch per block: x is read from device
  memory once and y written once per layer.  It takes no `g`: how many
  sequences a thread block owns is the kernel's business.

Weights are in torch Linear layout, (out_features, in_features) — the
OpenAI CLIP state dict's — where the JAX functions take (in, out) kernels.

Dispatch: a CPU tensor goes to the plain version (`_attn_ref`,
`_attn_ref_flat`, `_mlp_ref`, `_block_ref_flat`); a CUDA tensor goes to
the kernels in `csrc/` or the call raises.  Nothing falls back.  Each
public function carries `launches`, a plain int that counts the calls
which launched its kernels.

Gradients: as the JAX custom_vjps do, the forward launches the kernel and
the backward recomputes the plain version and differentiates that (one
extra unfused forward in the backward pass): `_PlainBackward`, used only
when grad mode is on and an input requires grad.  No kernel has a
backward kernel.  On the CPU the plain version's own autograd is the
gradient.

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


def _gemm_ref(a, epi, mats, resid=None):
    """What one launch of csrc/gemm.cu computes (`_gemm`), in plain torch:
    out_i = epi(a @ w_i.T + b_i), fp32 accumulation and bias, quick_gelu in
    fp32 before the rounding, the residual added to the rounded
    projection in a.dtype."""
    dt = a.dtype
    outs = []
    for w, b in mats:
        h = a.float() @ w.to(dt).float().t() + b.to(dt).float()
        if epi == _EPI_GELU:
            h = h * torch.sigmoid(1.702 * h)
        h = h.to(dt)
        outs.append(h + resid if epi == _EPI_RESID else h)
    return outs


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


def _block_ref_flat(x, ln1s, ln1b, wq, bq, wk, bk, wv, bv, wo, bo, ln2s,
                    ln2b, w1, b1, w2, b2, *, heads: int, seq_len: int,
                    causal: bool, eps: float = 1e-5) -> torch.Tensor:
    """A whole block in plain torch: the compact attention sublayer, then
    the MLP sublayer on its output y1, which is in x.dtype (rounded where
    the two-kernel chain rounds it)."""
    y1 = _attn_ref_flat(x, ln1s, ln1b, wq, bq, wk, bk, wv, bv, wo, bo,
                        heads=heads, seq_len=seq_len, causal=causal,
                        eps=eps)
    return _mlp_ref(y1, ln2s, ln2b, w1, b1, w2, b2, eps=eps)


# ---------------------------------------------------------------------------
# gradients: kernel forward, plain-version backward
# ---------------------------------------------------------------------------

class _PlainBackward(torch.autograd.Function):
    """forward(launch, plain, *tensors) returns launch(*tensors) and saves
    the tensors; backward recomputes plain(*tensors) with grad mode on and
    returns its gradients (the JAX custom_vjp over the `_*_ref` math)."""

    @staticmethod
    def forward(ctx, launch, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*leaves)
            grads = iter(torch.autograd.grad(
                out, [t for t in leaves if t.requires_grad], grad))
        return (None, None,
                *[next(grads) if need else None for need in needs])


def _launch(launch, plain, *tensors):
    """launch(*tensors), differentiable through `plain` when grad mode is
    on and a tensor requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PlainBackward.apply(launch, plain, *tensors)
    return launch(*tensors)


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
    three (w_i, b_i) that share a; returns the outputs.  bfloat16 runs the
    wgmma kernel (TMA ring, persistent tiles), float32 the CUDA-core
    kernel: the dtype alone decides, before the launch.  Plain version:
    `_gemm_ref`."""
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
    def plain(*a):
        return _attn_ref(*a, heads=heads, valid_len=valid_len,
                         causal=causal, eps=eps)

    def launch(*a):
        xc, params = _prepare(*a)
        b, lp, d = xc.shape
        y = _attn_cuda(xc.reshape(b * lp, d), params, heads=heads,
                       seq_stride=lp, rows=lp, valid_len=valid_len,
                       causal=causal, eps=eps)
        fused_attention_sublayer.launches += 1
        return y.reshape(b, lp, d)

    args = (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    return plain(*args) if _on_cpu(x) else _launch(launch, plain, *args)


fused_attention_sublayer.launches = 0


def fused_attention_sublayer_compact(x, ln_scale, ln_bias, wq, bq, wk, bk,
                                     wv, bv, wo, bo, *, heads: int,
                                     seq_len: int, causal: bool = False,
                                     eps: float = 1e-5) -> torch.Tensor:
    """x: FLAT (B·seq_len, D) with no pad rows -> (B·seq_len, D)."""
    if x.shape[0] % seq_len:
        raise ValueError(f"seq_len {seq_len} must divide the row count "
                         f"{x.shape[0]}")

    def plain(*a):
        return _attn_ref_flat(*a, heads=heads, seq_len=seq_len,
                              causal=causal, eps=eps)

    def launch(*a):
        xc, params = _prepare(*a)
        y = _attn_cuda(xc, params, heads=heads, seq_stride=seq_len,
                       rows=seq_len, valid_len=seq_len, causal=causal,
                       eps=eps)
        fused_attention_sublayer_compact.launches += 1
        return y

    args = (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    return plain(*args) if _on_cpu(x) else _launch(launch, plain, *args)


fused_attention_sublayer_compact.launches = 0


def fused_mlp_sublayer(x, ln_scale, ln_bias, w1, b1, w2, b2, *,
                       eps: float = 1e-5) -> torch.Tensor:
    """y = x + W2·quick_gelu(W1·LN(x) + b1) + b2, any leading shape."""
    def plain(*a):
        return _mlp_ref(*a, eps=eps)

    def launch(*a):
        xc, (lns, lnb, w1c, b1c, w2c, b2c) = _prepare(*a)
        x2 = xc.reshape(-1, xc.shape[-1])
        h = _gemm(_layernorm(x2, lns, lnb, eps), _EPI_GELU,
                  ((w1c, b1c),))[0]
        y = _gemm(h, _EPI_RESID, ((w2c, b2c),), resid=x2)[0]
        fused_mlp_sublayer.launches += 1
        return y.reshape(xc.shape)

    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    return plain(*args) if _on_cpu(x) else _launch(launch, plain, *args)


fused_mlp_sublayer.launches = 0

# what csrc/block_sublayer.cu takes
BLOCK_MAX_SEQ, BLOCK_MAX_WIDTH, BLOCK_MAX_HEAD_DIM = 64, 768, 64


def _check_block_shapes(x, wq, w1, heads: int, seq_len: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"the block sublayer takes flat (B·seq_len, D) "
                         f"rows, got {tuple(x.shape)}")
    n, d = x.shape
    hidden = w1.shape[0]
    if not 1 <= seq_len <= BLOCK_MAX_SEQ or n % seq_len:
        raise ValueError(f"the block kernel takes 1 <= seq_len <= "
                         f"{BLOCK_MAX_SEQ} dividing the row count, got "
                         f"seq_len={seq_len} rows={n}")
    if d % 64 or not 64 <= d <= BLOCK_MAX_WIDTH:
        raise ValueError(f"the block kernel takes widths that are multiples "
                         f"of 64 up to {BLOCK_MAX_WIDTH}, got {d}")
    if heads < 1 or d % heads or (d // heads) % 16 \
            or d // heads > BLOCK_MAX_HEAD_DIM:
        raise ValueError(f"the block kernel takes head dims that are "
                         f"multiples of 16 up to {BLOCK_MAX_HEAD_DIM}, got "
                         f"width {d} over {heads} heads")
    if hidden % 64 or w1.shape != (hidden, d) or wq.shape != (d, d):
        raise ValueError(f"the block kernel takes a hidden width that is a "
                         f"multiple of 64, got w1 {tuple(w1.shape)} and wq "
                         f"{tuple(wq.shape)} for width {d}")


def _block_cuda(x, params, *, heads, seq_len, causal, eps):
    """csrc/block_sublayer.cu: one launch for the whole block.  float32
    stages its tiles through a per-block scratch allocated here; bf16
    keeps everything on chip."""
    from ._build import load_kernels
    lib = load_kernels().lib
    n, d = x.shape
    hidden = params[12].shape[0]
    code = _DTYPE_CODES[x.dtype]
    nbytes = lib.cmve_block_scratch_bytes(code, n, d, heads, hidden, seq_len)
    if nbytes < 0:
        raise ValueError(f"block kernel refuses rows={n} width={d} "
                         f"heads={heads} hidden={hidden} seq_len={seq_len}")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
               if nbytes else None)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.cmve_block_sublayer(
            code, x.data_ptr(), *[p.data_ptr() for p in params],
            y.data_ptr(), None if scratch is None else scratch.data_ptr(),
            n, d, heads, hidden, seq_len, int(causal), eps,
            float(np.float32(1.0 / np.sqrt(d // heads))), _stream(x))
    _check(err, "block sublayer kernel")
    return y


def fused_block_sublayer_compact(x, ln1s, ln1b, wq, bq, wk, bk, wv, bv, wo,
                                 bo, ln2s, ln2b, w1, b1, w2, b2, *,
                                 heads: int, seq_len: int,
                                 causal: bool = False,
                                 eps: float = 1e-5) -> torch.Tensor:
    """A whole transformer block on FLAT (B·seq_len, D) rows:
    fused_attention_sublayer_compact, then fused_mlp_sublayer, in one
    kernel launch."""
    _check_block_shapes(x, wq, w1, heads, seq_len)

    def plain(*a):
        return _block_ref_flat(*a, heads=heads, seq_len=seq_len,
                               causal=causal, eps=eps)

    def launch(*a):
        xc, params = _prepare(*a)
        y = _block_cuda(xc, params, heads=heads, seq_len=seq_len,
                        causal=causal, eps=eps)
        fused_block_sublayer_compact.launches += 1
        return y

    args = (x, ln1s, ln1b, wq, bq, wk, bk, wv, bv, wo, bo, ln2s, ln2b, w1,
            b1, w2, b2)
    return plain(*args) if _on_cpu(x) else _launch(launch, plain, *args)


fused_block_sublayer_compact.launches = 0

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
  MLP sublayer, as one kernel launch per block (`block_path` names the
  kernel of csrc/block_sublayer.cu that serves a call).  It takes no
  `g`: how many sequences a thread block owns is the kernel's business.

Weights are in torch Linear layout, (out_features, in_features) — the
OpenAI CLIP state dict's — where the JAX functions take (in, out) kernels.

Dispatch: a CPU tensor goes to the plain version (`_attn_ref`,
`_attn_ref_flat`, `_mlp_ref`, `_block_ref_flat`); a CUDA tensor goes to
the kernels in `csrc/` or the call raises.  Nothing falls back.  Each
public function carries `launches`, a plain int that counts the calls
which launched its kernels.

The two attention sublayers replace `_attn_pallas` (`_kernel`) and
`_attn_pallas_compact` (`_kernel_compact` / `_attn_body_compact`) of the
JAX module.  On the H100 they are four kernels behind one host call
(`cmve_attention_sublayer` in csrc/sublayer.cu): LayerNorm, the q|k|v
product, the attention core, the output projection with the residual.
What bounds them at the main-path shapes is not arithmetic: the core
moves q, k, v and its output once through device memory (bytes), and
the call as a whole is short enough that host time per call showed as
device idle time.  So the core (csrc/attention_core.cu) is a persistent
TMA/wgmma kernel that keeps loads in flight, and the host side does one
crossing into C per sublayer, allocates one workspace, reads LayerNorm's
fp32 scale and bias in the kernel instead of casting them, and keeps the
weights' tensor maps on the C side.  `fused_mlp_sublayer` takes the same
single-call shape (`cmve_mlp_sublayer`).  `core_path` names which core
kernel serves a call.  The step-by-step path (`_layernorm`, `_gemm`,
`_attention_core`: one crossing per kernel) stays for tests and for
timing the pieces.

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

import functools

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


@functools.lru_cache(maxsize=None)
def _sm_scale(hd: int) -> float:
    """1 / sqrt(hd) as the float32 the JAX kernels multiply by."""
    return float(np.float32(1.0 / np.sqrt(hd)))


def _key_mask(lp: int, valid_len: int, causal: bool,
              device: torch.device) -> torch.Tensor:
    """The kernels' additive mask: -1e30 (not -inf) on masked keys."""
    col = torch.arange(lp, device=device)
    mask = torch.where(col < valid_len, 0.0, -1e30)[None, :].expand(lp, lp)
    if causal:
        row = torch.arange(lp, device=device)[:, None]
        mask = mask + torch.where(col[None, :] <= row, 0.0, -1e30)
    return mask.float()


def _attention_core_ref(q, k, v, *, heads: int, seq_stride: int, rows: int,
                        valid_len: int, causal: bool) -> torch.Tensor:
    """What one launch of csrc/attention_core.cu computes (`_attention_core`),
    in plain torch: q, k, v are (n, D); sequence s owns rows
    [s * seq_stride, s * seq_stride + rows) and attends to its first
    valid_len rows.  fp32 scores and softmax, P rounded to q.dtype, fp32
    accumulation, the output rounded to q.dtype.  Rows of k and v past
    valid_len read as zeros, as the Pallas kernels zero them and the
    tensor maps' bound does, so what lies there (inf, NaN) reaches
    nothing.  Rows the kernel does not write (past `rows` in a sequence)
    come back as zeros."""
    n, d = q.shape
    hd = d // heads
    dt = q.dtype
    q4, k4, v4 = (t.reshape(n // seq_stride, seq_stride, heads, hd)[:, :rows]
                  for t in (q, k, v))
    if valid_len < rows:
        pad = (torch.arange(rows, device=q.device) >= valid_len)[:, None, None]
        k4, v4 = k4.masked_fill(pad, 0.0), v4.masked_fill(pad, 0.0)
    sc = torch.einsum("bqhc,bkhc->bhqk", q4.float(), k4.float())
    sc = sc * _sm_scale(hd)
    pr = torch.softmax(sc + _key_mask(rows, valid_len, causal, q.device),
                       dim=-1).to(dt)
    att = torch.einsum("bhqk,bkhc->bqhc", pr.float(), v4.float()).to(dt)
    out = q.new_zeros(n // seq_stride, seq_stride, d)
    out[:, :rows] = att.reshape(-1, rows, d)
    return out.reshape(n, d)


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
    sc = sc * _sm_scale(hd)
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


def _prepare(x: torch.Tensor, *params: torch.Tensor, ln=(0, 1)):
    """Check what the kernels take; return x contiguous and the params in
    x.dtype, contiguous, on x's device.  A parameter that already is all
    that comes back as the same object, at no cost.  The LayerNorm scale
    and bias (the positions in `ln`) may also stay float32: layernorm.cu
    reads them as stored and rounds them to x.dtype itself."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"sublayer kernels take float32 or bfloat16, "
                        f"not {x.dtype}")
    if not x.is_contiguous():
        x = x.contiguous()
    out = []
    for i, p in enumerate(params):
        if p.device != x.device:
            raise ValueError(f"parameter on {p.device}, input on {x.device}")
        if p.dtype != x.dtype and not (p.dtype == torch.float32 and i in ln):
            p = p.to(x.dtype)
        if not p.is_contiguous():
            p = p.contiguous()
        out.append(p)
    for t in (x, *out):
        if t.data_ptr() % 16:
            raise ValueError("sublayer kernels need 16-byte aligned tensors")
    return x, out


def _stream(x: torch.Tensor) -> int:
    """The raw handle of x's device's current stream.  Asked of the C layer
    directly: `torch.cuda.current_stream(...).cuda_stream` builds a Stream
    object first, a tenth of a sublayer call's host time."""
    index = x.device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} refused the launch: CUDA error {err}")


def _check_ln(x2, lns, lnb) -> None:
    k = x2.shape[1]
    if k % 8:
        raise ValueError(f"LayerNorm kernel needs a width divisible by 8, "
                         f"got {k}")
    if lns.shape != (k,) or lnb.shape != (k,):
        raise ValueError(f"LayerNorm scale {tuple(lns.shape)} and bias "
                         f"{tuple(lnb.shape)} for width {k}")
    if lns.dtype != lnb.dtype or lns.dtype not in (x2.dtype, torch.float32):
        raise TypeError(f"LayerNorm scale {lns.dtype} and bias {lnb.dtype} "
                        f"must both be {x2.dtype} or float32")


def _check_gemm(a, mats, resid=None) -> None:
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


# what csrc/attention_core.cu takes
CORE_MAX_KEYS, CORE_WGMMA_HEAD_DIM, CORE_WGMMA_MAX_KEYS = 256, 64, 128
_CORE_SMEM = 227 * 1024


def core_path(dtype: torch.dtype, head_dim: int, valid_len: int) -> str:
    """Which kernel of csrc/attention_core.cu serves a call, by dtype, head
    dim and key count alone: "wgmma" (bfloat16, head dim 64, at most 128
    keys: TMA ring, persistent blocks) or "fma" (everything else the core
    takes: CUDA cores, K and V of one head in shared memory as fp32).
    Raises for what neither takes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"attention core takes float32 or bfloat16, "
                        f"not {dtype}")
    if head_dim < 1 or not 1 <= valid_len <= CORE_MAX_KEYS:
        raise ValueError(f"attention core takes a head dim >= 1 and 1 <= "
                         f"valid_len <= {CORE_MAX_KEYS}, got head dim "
                         f"{head_dim}, valid_len={valid_len}")
    if (dtype == torch.bfloat16 and head_dim == CORE_WGMMA_HEAD_DIM
            and valid_len <= CORE_WGMMA_MAX_KEYS):
        return "wgmma"
    # K (rows padded by one), V, and a q row and a P row for each of 4 warps
    smem = 4 * (valid_len * (2 * head_dim + 1) + 4 * (head_dim + valid_len))
    if smem > _CORE_SMEM:
        raise ValueError(f"attention core: head dim {head_dim} with "
                         f"{valid_len} keys needs {smem} bytes of shared "
                         f"memory as fp32, above {_CORE_SMEM}")
    return "fma"


def _check_core(q, heads, seq_stride, rows, valid_len) -> int:
    """The shapes one core launch takes; returns the head dim."""
    n, d = q.shape
    hd = d // heads
    if heads < 1 or heads * hd != d:
        raise ValueError(f"heads={heads} does not divide width {d}")
    if not 1 <= rows <= seq_stride or n % seq_stride:
        raise ValueError(f"attention core takes 1 <= rows <= seq_stride "
                         f"dividing the row count, got rows={rows} "
                         f"seq_stride={seq_stride} for {n} rows")
    if valid_len > rows:
        raise ValueError(f"attention core takes valid_len <= rows, got "
                         f"valid_len={valid_len} rows={rows}")
    core_path(q.dtype, hd, valid_len)
    return hd


def _layernorm(x2, lns, lnb, eps):
    """csrc/layernorm.cu: LN(x2) with fp32 statistics, in x2.dtype; scale
    and bias in x2.dtype or float32."""
    from ._build import load_kernels
    _check_ln(x2, lns, lnb)
    m, k = x2.shape
    out = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        err = load_kernels().lib.cmve_layernorm(
            _DTYPE_CODES[x2.dtype], _DTYPE_CODES[lns.dtype], x2.data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), out.data_ptr(), m, k, eps,
            _stream(x2))
    _check(err, "layernorm kernel")
    return out


def _gemm(a, epi, mats, resid=None):
    """One launch of csrc/gemm.cu: out_i = epi(a @ w_i.T + b_i) for up to
    three (w_i, b_i) that share a; returns the outputs.  bfloat16 runs the
    wgmma kernel (TMA ring, persistent tiles), float32 the CUDA-core
    kernel: the dtype alone decides, before the launch.  Plain version:
    `_gemm_ref`."""
    from ._build import load_kernels
    _check_gemm(a, mats, resid)
    m, k = a.shape
    n = mats[0][0].shape[0]
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
    """One launch of csrc/attention_core.cu into `att`; `core_path` names
    the kernel.  Plain version: `_attention_core_ref`."""
    from ._build import load_kernels
    hd = _check_core(q, heads, seq_stride, rows, valid_len)
    n, d = q.shape
    with torch.cuda.device(q.device):
        err = load_kernels().lib.cmve_attention_core(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            att.data_ptr(), n // seq_stride, heads, d, hd, seq_stride, rows,
            valid_len, int(causal), _sm_scale(hd), _stream(q))
    _check(err, "attention core kernel")
    return att


def _check_attn(x2, params, heads, seq_stride, rows, valid_len) -> int:
    lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo = params
    if wq.shape[0] != x2.shape[1]:
        raise ValueError(f"q/k/v projections {tuple(wq.shape)} for width "
                         f"{x2.shape[1]}")
    _check_ln(x2, lns, lnb)
    _check_gemm(x2, ((wq, bq), (wk, bk), (wv, bv)))
    _check_gemm(x2, ((wo, bo),), resid=x2)
    return _check_core(x2, heads, seq_stride, rows, valid_len)


def _attn_cuda_steps(x2, params, *, heads, seq_stride, rows, valid_len,
                     causal, eps):
    """The attention sublayer kernel by kernel, one crossing into C each:
    what `_attn_cuda` enqueues in one."""
    lns, lnb, wq, bq, wk, bk, wv, bv, wo, bo = params
    _check_attn(x2, params, heads, seq_stride, rows, valid_len)
    ln = _layernorm(x2, lns, lnb, eps)
    q, k, v = _gemm(ln, _EPI_BIAS, ((wq, bq), (wk, bk), (wv, bv)))
    att = _attention_core(q, k, v, torch.empty_like(x2), heads=heads,
                          seq_stride=seq_stride, rows=rows,
                          valid_len=valid_len, causal=causal)
    return _gemm(att, _EPI_RESID, ((wo, bo),), resid=x2)[0]


def _attn_cuda(x2, params, *, heads, seq_stride, rows, valid_len, causal,
               eps):
    """csrc/sublayer.cu, `cmve_attention_sublayer`: LayerNorm, q|k|v, the
    core and the output projection enqueued by one call, on one workspace
    of five (n, D) planes (LN(x), q, k, v, the attention output)."""
    from ._build import load_kernels
    hd = _check_attn(x2, params, heads, seq_stride, rows, valid_len)
    n, d = x2.shape
    work = x2.new_empty((5, n, d))
    y = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        err = load_kernels().lib.cmve_attention_sublayer(
            _DTYPE_CODES[x2.dtype], _DTYPE_CODES[params[0].dtype],
            x2.data_ptr(), *[p.data_ptr() for p in params], work.data_ptr(),
            y.data_ptr(), n, d, heads, seq_stride, rows, valid_len,
            int(causal), eps, _sm_scale(hd), _stream(x2))
    _check(err, "attention sublayer")
    return y


def _check_mlp(x2, params) -> None:
    lns, lnb, w1, b1, w2, b2 = params
    _check_ln(x2, lns, lnb)
    _check_gemm(x2, ((w1, b1),))
    if w2.shape != (x2.shape[1], w1.shape[0]):
        raise ValueError(f"MLP projections {tuple(w1.shape)} then "
                         f"{tuple(w2.shape)} for width {x2.shape[1]}")
    if w2.shape[1] % 8 or b2.shape != (w2.shape[0],):
        raise ValueError(f"GEMM shapes: w {tuple(w2.shape)} b "
                         f"{tuple(b2.shape)} for a hidden width "
                         f"{w1.shape[0]}")


def _mlp_cuda_steps(x2, params, *, eps):
    """The MLP sublayer kernel by kernel: what `_mlp_cuda` enqueues in one
    call."""
    lns, lnb, w1, b1, w2, b2 = params
    _check_mlp(x2, params)
    h = _gemm(_layernorm(x2, lns, lnb, eps), _EPI_GELU, ((w1, b1),))[0]
    return _gemm(h, _EPI_RESID, ((w2, b2),), resid=x2)[0]


def _mlp_cuda(x2, params, *, eps):
    """csrc/sublayer.cu, `cmve_mlp_sublayer`: LayerNorm, the up projection
    with quick_gelu and the down projection with the residual enqueued by
    one call; the workspace holds LN(x) and the hidden activation."""
    from ._build import load_kernels
    _check_mlp(x2, params)
    n, d = x2.shape
    hidden = params[2].shape[0]
    work = x2.new_empty(n * (d + hidden))
    y = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        err = load_kernels().lib.cmve_mlp_sublayer(
            _DTYPE_CODES[x2.dtype], _DTYPE_CODES[params[0].dtype],
            x2.data_ptr(), *[p.data_ptr() for p in params], work.data_ptr(),
            y.data_ptr(), n, d, hidden, eps, _stream(x2))
    _check(err, "mlp sublayer")
    return y


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
        xc, params = _prepare(*a)
        y = _mlp_cuda(xc.reshape(-1, xc.shape[-1]), params, eps=eps)
        fused_mlp_sublayer.launches += 1
        return y.reshape(xc.shape)

    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    return plain(*args) if _on_cpu(x) else _launch(launch, plain, *args)


fused_mlp_sublayer.launches = 0

# what csrc/block_sublayer.cu takes, and where its wgmma route applies
BLOCK_MAX_SEQ, BLOCK_MAX_WIDTH, BLOCK_MAX_HEAD_DIM = 64, 768, 64
BLOCK_WGMMA_QUARTER, BLOCK_WGMMA_HEAD_DIM = 192, 64


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


def block_path(dtype: torch.dtype, width: int, head_dim: int, hidden: int,
               seq_len: int) -> str:
    """Which kernel of csrc/block_sublayer.cu serves a call, by dtype and
    shape alone: "wgmma" (bfloat16, width a multiple of 192 and head dim
    64: the weights through a TMA ring, wgmma products), "mma" (the other
    bfloat16 shapes: the same ring, mma.sync products) or "fma" (float32:
    CUDA cores, a per-block scratch in device memory).  Raises for what the
    kernel does not take."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the block kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    if not 1 <= seq_len <= BLOCK_MAX_SEQ:
        raise ValueError(f"the block kernel takes 1 <= seq_len <= "
                         f"{BLOCK_MAX_SEQ}, got seq_len={seq_len}")
    if width % 64 or not 64 <= width <= BLOCK_MAX_WIDTH:
        raise ValueError(f"the block kernel takes widths that are multiples "
                         f"of 64 up to {BLOCK_MAX_WIDTH}, got {width}")
    if head_dim < 16 or head_dim % 16 or head_dim > BLOCK_MAX_HEAD_DIM \
            or width % head_dim:
        raise ValueError(f"the block kernel takes head dims that are "
                         f"multiples of 16 up to {BLOCK_MAX_HEAD_DIM} "
                         f"dividing the width, got {head_dim} for {width}")
    if hidden < 64 or hidden % 64:
        raise ValueError(f"the block kernel takes a hidden width that is a "
                         f"multiple of 64, got {hidden}")
    if dtype == torch.float32:
        return "fma"
    if width % BLOCK_WGMMA_QUARTER == 0 and head_dim == BLOCK_WGMMA_HEAD_DIM:
        return "wgmma"
    return "mma"


def _block_cuda(x, params, *, heads, seq_len, causal, eps):
    """csrc/block_sublayer.cu: one launch for the whole block; `block_path`
    names the kernel.  float32 stages its tiles through a per-block scratch
    allocated here; bf16 keeps all but y1 on chip."""
    from ._build import load_kernels
    lib = load_kernels().lib
    n, d = x.shape
    hidden = params[12].shape[0]
    block_path(x.dtype, d, d // heads, hidden, seq_len)
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
            _sm_scale(d // heads), _stream(x))
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
        xc, params = _prepare(*a, ln=())   # block_sublayer.cu: all in x.dtype
        y = _block_cuda(xc, params, heads=heads, seq_len=seq_len,
                        causal=causal, eps=eps)
        fused_block_sublayer_compact.launches += 1
        return y

    args = (x, ln1s, ln1b, wq, bq, wk, bk, wv, bv, wo, bo, ln2s, ln2b, w1,
            b1, w2, b2)
    return plain(*args) if _on_cpu(x) else _launch(launch, plain, *args)


fused_block_sublayer_compact.launches = 0

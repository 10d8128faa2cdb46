// One host call per sublayer: the C entries that enqueue a whole attention
// or MLP sublayer on a stream.
//
// Replaces the single `pallas_call` of each TPU sublayer in
// cross_modal_video_engine_tpu/ops/attention_sublayer.py (_attn_pallas line
// 132, _attn_pallas_compact line 354, _mlp_pallas line 479) as the unit the
// host sees: there one call launches one kernel; here one call launches the
// sublayer's kernels (layernorm.cu, gemm.cu, attention_core.cu) back to back
// on the given stream.  It adds no kernel and changes none.
//
// What bounds it: at the main-path shapes the sublayers' kernels take 0.03
// to 0.15 ms together, and a call through Python that crossed into C once
// per kernel (device guard, stream lookup, output allocation, argument
// conversion each time) took longer than that, so the card waited for the
// host.  One crossing per sublayer leaves the kernel launches themselves.
// The caller hands in one workspace for the intermediates.

#include "common.cuh"

extern "C" int cmve_layernorm(int dtype, int param_dtype, const void* x,
                              const void* scale, const void* bias, void* out,
                              int M, int K, float eps, void* stream);
extern "C" int cmve_gemm(int dtype, int epilogue, const void* a,
                         const void* resid, const void* w0, const void* b0,
                         void* o0, const void* w1, const void* b1, void* o1,
                         const void* w2, const void* b2, void* o2, int nmat,
                         int M, int N, int K, void* stream);
extern "C" int cmve_attention_core(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int nseq,
                                   int heads, int D, int hd, int seq_stride,
                                   int rows, int valid_len, int causal,
                                   float scale, void* stream);

namespace cmve {

static size_t element_size(int dtype) { return dtype == kBFloat16 ? 2 : 4; }

}  // namespace cmve

// y = x + W_o attention(LN(x)) + b_o on n rows of width D: LayerNorm, the
// q|k|v product (one launch), the attention core, the output projection with
// the residual.  `work` holds five (n, D) planes in x's type: LN(x), q, k, v
// and the attention output.  Returns the first error of the four launches.
extern "C" int cmve_attention_sublayer(
    int dtype, int ln_dtype, const void* x, const void* lns, const void* lnb,
    const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* wo, const void* bo, void* work,
    void* y, int n, int D, int heads, int seq_stride, int rows, int valid_len,
    int causal, float eps, float scale, void* stream) {
  using namespace cmve;
  if (n <= 0 || D <= 0 || heads <= 0 || D % heads || seq_stride <= 0 ||
      n % seq_stride)
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)n * D * element_size(dtype);
  char* const w = static_cast<char*>(work);
  void* const ln = w;
  void* const q = w + plane;
  void* const k = w + 2 * plane;
  void* const v = w + 3 * plane;
  void* const att = w + 4 * plane;
  if (int err = cmve_layernorm(dtype, ln_dtype, x, lns, lnb, ln, n, D, eps,
                               stream))
    return err;
  if (int err = cmve_gemm(dtype, kBias, ln, nullptr, wq, bq, q, wk, bk, k, wv,
                          bv, v, 3, n, D, D, stream))
    return err;
  if (int err = cmve_attention_core(dtype, q, k, v, att, n / seq_stride, heads,
                                    D, D / heads, seq_stride, rows, valid_len,
                                    causal, scale, stream))
    return err;
  return cmve_gemm(dtype, kBiasResidual, att, x, wo, bo, y, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr, 1, n, D, D, stream);
}

// y = x + W2 quick_gelu(W1 LN(x) + b1) + b2 on n rows of width D: LayerNorm,
// the up projection with quick_gelu, the down projection with the residual.
// `work` holds LN(x), (n, D), then the hidden activation, (n, hidden).
extern "C" int cmve_mlp_sublayer(int dtype, int ln_dtype, const void* x,
                                 const void* lns, const void* lnb,
                                 const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* work,
                                 void* y, int n, int D, int hidden, float eps,
                                 void* stream) {
  using namespace cmve;
  if (n <= 0 || D <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  char* const w = static_cast<char*>(work);
  void* const ln = w;
  void* const h = w + (size_t)n * D * element_size(dtype);
  if (int err = cmve_layernorm(dtype, ln_dtype, x, lns, lnb, ln, n, D, eps,
                               stream))
    return err;
  if (int err = cmve_gemm(dtype, kBiasQuickGelu, ln, nullptr, w1, b1, h,
                          nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          1, n, hidden, D, stream))
    return err;
  return cmve_gemm(dtype, kBiasResidual, h, x, w2, b2, y, nullptr, nullptr,
                   nullptr, nullptr, nullptr, nullptr, 1, n, D, hidden, stream);
}

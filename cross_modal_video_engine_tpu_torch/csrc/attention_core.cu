// Attention core of the attention sublayers: softmax(q k^T / sqrt(hd)) v
// for one (sequence, head) per block, between the LayerNorm + QKV
// projection (layernorm.cu, gemm.cu) and the output projection + residual
// (gemm.cu).
//
// Replaces the per-sequence, per-head attention loops inside the Pallas
// kernels of cross_modal_video_engine_tpu/ops/attention_sublayer.py:
//   _kernel (lines 86-105), run by _attn_pallas (fused_attention_sublayer):
//     rank-3 rows, keys >= valid_len masked, pad rows pass as queries;
//   _attn_body_compact (lines 271-301), run by _attn_pallas_compact
//     (fused_attention_sublayer_compact): flat rows, no pad rows.
// Both layouts are one parametrisation here: sequence s owns rows
// [s * seq_stride, s * seq_stride + rows), keys are its first valid_len
// rows, and a key read never leaves its own sequence.  Rounding points
// follow the Pallas kernels: fp32 scores and softmax, P rounded to x.dtype
// before P v, fp32 accumulation, the output rounded to x.dtype.  Masked
// keys (j >= valid_len, and j > r when causal) get -1e30 added there,
// which makes their exp exactly 0 in fp32, so skipping them here gives the
// same sums.
//
// Two paths, chosen by what the call is: bf16 with head dim 64 and at
// most 128 keys (both towers of the main path) runs on the tensor cores
// (attention_core_mma_kernel, below); every other call, float32 included,
// runs the CUDA-core kernel: K and V of one (sequence, head) in shared
// memory as fp32 (at most 256 keys), one warp per query row.
//
// What bounds it on the H100: at L = 50 or 77 the work per (sequence,
// head) is small (2 x L^2 x 64 multiply-adds), so the tensor-core path is
// bound by reading q, k, v from device memory and writing the output
// (4 x L x 64 x 2 bytes per block); the CUDA-core path by shared-memory
// reads, two per FMA.  A faster design keeps q, k and v on chip: the
// attention runs inside the QKV projection's blocks, on whole sequences,
// so that they never go through device memory.

#include "common.cuh"

namespace cmve {

constexpr int ATT_THREADS = 128;
constexpr int MAX_KEYS_PER_LANE = 8;  // valid_len <= 256

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
    attention_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out, int D,
                          int hd, int seq_stride, int rows, int valid_len,
                          int causal, float scale) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int ks = hd + 1;  // odd stride: 32 lanes on 32 keys hit 32 banks
  float* Ks = smem;                     // valid_len x (hd + 1)
  float* Vs = Ks + valid_len * ks;      // valid_len x hd
  float* Qw = Vs + valid_len * hd;      // nwarps x hd
  float* Pw = Qw + nwarps * hd;         // nwarps x valid_len
  const size_t base = (size_t)s * seq_stride;
  const size_t col0 = (size_t)h * hd;

  for (int i = threadIdx.x; i < valid_len * hd; i += blockDim.x) {
    const int j = i / hd, c = i - j * hd;
    const size_t off = (base + j) * D + col0 + c;
    Ks[j * ks + c] = to_f32(k[off]);
    Vs[j * hd + c] = to_f32(v[off]);
  }
  __syncthreads();

  float* qrow = Qw + warp * hd;
  float* prow = Pw + warp * valid_len;
  for (int r = warp; r < rows; r += nwarps) {
    const size_t off = (base + r) * D + col0;
    for (int c = lane; c < hd; c += 32) qrow[c] = to_f32(q[off + c]);
    __syncwarp();
    const int kv = causal ? min(r + 1, valid_len) : valid_len;

    float sc[MAX_KEYS_PER_LANE];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < MAX_KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      sc[t] = -INFINITY;
      if (j < kv) {
        const float* kr = Ks + j * ks;
        float d = 0.f;
        for (int c = 0; c < hd; ++c) d = fmaf(qrow[c], kr[c], d);
        sc[t] = d * scale;
        m = fmaxf(m, sc[t]);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < MAX_KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      sc[t] = j < kv ? expf(sc[t] - m) : 0.f;
      sum += sc[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < MAX_KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      if (j < kv) prow[j] = round_to<T>(sc[t] / sum);
    }
    __syncwarp();
    for (int c = lane; c < hd; c += 32) {
      float o = 0.f;
      for (int j = 0; j < kv; ++j) o = fmaf(prow[j], Vs[j * hd + c], o);
      out[off + c] = from_f32<T>(o);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// bf16, head dim 64, at most 128 keys (both towers of the main path): the
// same math on the tensor cores.  One warp owns 16 query rows; S = q k^T
// and O = P v are mma.sync m16n8k16 with fp32 accumulation, the softmax
// runs on the S fragments in registers, and P (rounded to bf16) feeds the
// second product straight from them.  K is staged in shared memory as
// [key][channel] and V transposed as [channel][key], both zero past
// valid_len, so every fragment is one 32-bit shared-memory load.
// ---------------------------------------------------------------------------

constexpr int MMA_HD = 64;
constexpr int MMA_MAX_KEYS = 128;
constexpr int KS_STRIDE = MMA_HD + 8;        // bank-spread padding
constexpr int VT_STRIDE = MMA_MAX_KEYS + 8;

__global__ void __launch_bounds__(ATT_THREADS)
    attention_core_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ out, int D,
                              int seq_stride, int rows, int valid_len,
                              int causal, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = MMA_MAX_KEYS / 8;       // key tiles of S
  constexpr int CT = MMA_HD / 8;             // channel tiles of O
  __shared__ __align__(16) bf16 Ks[MMA_MAX_KEYS][KS_STRIDE];
  __shared__ __align__(16) bf16 Vt[MMA_HD][VT_STRIDE];
  const int s = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const int nkt = (valid_len + 15) / 16;     // 16-key steps of P v
  const size_t base = (size_t)s * seq_stride;
  const size_t col0 = (size_t)h * MMA_HD;

  for (int i = threadIdx.x; i < nkt * 16 * (MMA_HD / 8);
       i += blockDim.x) {
    const int j = i / (MMA_HD / 8), c = (i % (MMA_HD / 8)) * 8;
    uint4 kk4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kk4;
    if (j < valid_len) {
      const size_t off = (base + j) * D + col0 + c;
      kk4 = *reinterpret_cast<const uint4*>(k + off);
      vv4 = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(&Ks[j][c]) = kk4;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv4);
#pragma unroll
    for (int e = 0; e < 8; ++e) Vt[c + e][j] = ve[e];
  }
  __syncthreads();

  for (int r0 = warp * 16; r0 < rows; r0 += nwarps * 16) {
    const int ra = r0 + g, rb = r0 + g + 8;   // this lane's two rows
    uint32_t qf[MMA_HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < MMA_HD / 16; ++ks) {
      const int c = ks * 16 + 2 * t;
      const bf16* pa = q + (base + ra) * D + col0 + c;
      const bf16* pb = q + (base + rb) * D + col0 + c;
      qf[ks][0] = ra < rows ? ld_u32(pa) : 0u;
      qf[ks][1] = rb < rows ? ld_u32(pb) : 0u;
      qf[ks][2] = ra < rows ? ld_u32(pa + 8) : 0u;
      qf[ks][3] = rb < rows ? ld_u32(pb + 8) : 0u;
    }

    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
      if (nt < 2 * nkt) {
#pragma unroll
        for (int ks = 0; ks < MMA_HD / 16; ++ks) {
          const uint32_t b[2] = {ld_u32(&Ks[nt * 8 + g][ks * 16 + 2 * t]),
                                 ld_u32(&Ks[nt * 8 + g][ks * 16 + 2 * t + 8])};
          mma_bf16_16816(sc[nt], qf[ks], b);
        }
      }
    }

    // softmax over the keys each row may see; the 4 lanes of a group
    // share a row
    const int kva = causal ? min(ra + 1, valid_len) : valid_len;
    const int kvb = causal ? min(rb + 1, valid_len) : valid_len;
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t + e;
        sc[nt][e] = col < kva ? sc[nt][e] * scale : -INFINITY;
        sc[nt][2 + e] = col < kvb ? sc[nt][2 + e] * scale : -INFINITY;
        ma = fmaxf(ma, sc[nt][e]);
        mb = fmaxf(mb, sc[nt][2 + e]);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
    }
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t + e;
        sc[nt][e] = col < kva ? expf(sc[nt][e] - ma) : 0.f;
        sc[nt][2 + e] = col < kvb ? expf(sc[nt][2 + e] - mb) : 0.f;
        suma += sc[nt][e];
        sumb += sc[nt][2 + e];
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      suma += __shfl_xor_sync(0xffffffffu, suma, o);
      sumb += __shfl_xor_sync(0xffffffffu, sumb, o);
    }

    float acc[CT][4];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ct][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < MMA_MAX_KEYS / 16; ++kt) {
      if (kt < nkt) {
        // P rounded to bf16: the S fragments of keys 16 kt .. 16 kt + 15
        // are the A fragment of this step
        const uint32_t pf[4] = {
            pack_bf16(sc[2 * kt][0] / suma, sc[2 * kt][1] / suma),
            pack_bf16(sc[2 * kt][2] / sumb, sc[2 * kt][3] / sumb),
            pack_bf16(sc[2 * kt + 1][0] / suma, sc[2 * kt + 1][1] / suma),
            pack_bf16(sc[2 * kt + 1][2] / sumb, sc[2 * kt + 1][3] / sumb)};
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) {
          const uint32_t b[2] = {ld_u32(&Vt[ct * 8 + g][kt * 16 + 2 * t]),
                                 ld_u32(&Vt[ct * 8 + g][kt * 16 + 2 * t + 8])};
          mma_bf16_16816(acc[ct], pf, b);
        }
      }
    }
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const size_t c = col0 + ct * 8 + 2 * t;
      if (ra < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (base + ra) * D + c) =
            __floats2bfloat162_rn(acc[ct][0], acc[ct][1]);
      if (rb < rows)
        *reinterpret_cast<__nv_bfloat162*>(out + (base + rb) * D + c) =
            __floats2bfloat162_rn(acc[ct][2], acc[ct][3]);
    }
  }
}

template <typename T>
static int launch_core(const void* q, const void* k, const void* v, void* out,
                       int nseq, int heads, int D, int hd, int seq_stride,
                       int rows, int valid_len, int causal, float scale,
                       size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024)  // above 48 KB only after opting in
    cudaFuncSetAttribute(attention_core_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid(nseq, heads);
  attention_core_kernel<T><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), D, hd, seq_stride, rows,
      valid_len, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace cmve

// C entry: returns cudaGetLastError() after the launch (0 on success).
extern "C" int cmve_attention_core(int dtype, const void* q, const void* k,
                                   const void* v, void* out, int nseq,
                                   int heads, int D, int hd, int seq_stride,
                                   int rows, int valid_len, int causal,
                                   float scale, void* stream) {
  using namespace cmve;
  if (nseq <= 0 || heads <= 0 || hd <= 0 || valid_len <= 0 ||
      valid_len > 32 * MAX_KEYS_PER_LANE || valid_len > rows ||
      heads * hd != D)
    return (int)cudaErrorInvalidValue;
  // the CUDA-core kernel's K, V, q rows and P rows, in fp32
  const size_t smem =
      sizeof(float) * ((size_t)valid_len * (2 * hd + 1) +
                       (size_t)(ATT_THREADS / 32) * (hd + valid_len));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && hd == MMA_HD && valid_len <= MMA_MAX_KEYS) {
    attention_core_mma_kernel<<<dim3(nseq, heads), ATT_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
        D, seq_stride, rows, valid_len, causal, scale);
    return (int)cudaGetLastError();
  }
  if (dtype == kBFloat16)
    return launch_core<__nv_bfloat16>(q, k, v, out, nseq, heads, D, hd,
                                      seq_stride, rows, valid_len, causal,
                                      scale, smem, s);
  if (dtype == kFloat32)
    return launch_core<float>(q, k, v, out, nseq, heads, D, hd, seq_stride,
                              rows, valid_len, causal, scale, smem, s);
  return (int)cudaErrorInvalidValue;
}

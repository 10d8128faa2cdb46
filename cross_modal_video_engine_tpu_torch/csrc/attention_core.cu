// Attention core of the attention sublayers: softmax(q k^T / sqrt(hd)) v
// per (sequence, head), between the LayerNorm + QKV projection
// (layernorm.cu, gemm.cu) and the output projection + residual (gemm.cu).
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
// follow the Pallas kernels: fp32 scores and softmax, P normalised and then
// rounded to x.dtype before P v, fp32 accumulation, the output rounded to
// x.dtype.  Masked keys (j >= valid_len, and j > r when causal) get -1e30
// added there, which makes their exp exactly 0 in fp32, so giving them
// P = 0 here gives the same sums.
//
// What bounds it on the H100: at L = 50 or 77 one (sequence, head) is
// 2 x 2 x L^2 x 64 operations on 4 x L x 128 bytes, a few operations a
// byte, so the least time is that of reading q, k, v and writing the output
// once (0.0235 ms at 12,800 rows of width 768).  What kept the first port
// (one small block per (sequence, head), loads, one barrier, products)
// three to four times above that was latency: nothing was in flight while
// a block computed.
//
// Two paths, chosen by what the call is (ops/attention_sublayer.core_path
// names them):
//  * bf16, head dim 64, at most 128 keys (both towers of the main path):
//    attention_core_wgmma, the design for this card.  One persistent block
//    an SM walks over the (sequence, head, query tile) items.  One producer
//    thread keeps TMA loads of the next items' Q, K and V tiles in flight on
//    a ring of full/empty mbarriers, so the loads of several items overlap
//    the products and softmax of the current ones.  q, k and v are 3-D
//    tensor maps (channels, rows of one sequence, sequences): the box is
//    (64 channels, the key tile, 1 sequence) with the 128-byte swizzle, the
//    row extent of the K/V maps is valid_len and that of the Q map is
//    `rows`, so the hardware zero-fills every row past the bound.  That is
//    the Pallas kernel's zeroing of k/v pad rows for nothing, and it is how
//    "a key read never leaves its own sequence" holds: what lies behind the
//    bound (the neighbour sequence, pad rows, inf or NaN) is never read, so
//    no 0 x inf reaches P v.  S = Q K^T is wgmma m64nNk16 with N the key
//    count rounded up to 16, K-major from shared memory; the softmax runs on
//    the accumulator fragments; P, normalised and rounded to bf16, is the
//    register operand of O = P V, with V read as it lies (keys by channels)
//    through wgmma's transpose bit.  Registers are sized by the key tile (a
//    template), not for 128 keys always.  A consumer warpgroup owns 64 query
//    rows: up to 64 rows a sequence the two warpgroups of a block take
//    items in turn; above, they share an item's K/V.  O leaves through a
//    staging tile as 16-byte stores guarded by `rows`.
//  * every other call, float32 included: the CUDA-core kernel, K and V of
//    one (sequence, head) in shared memory as fp32 (at most 256 keys), one
//    warp per query row; bound by shared-memory reads, two per FMA.
// Not done, and why: attention inside the QKV projection's blocks would
// keep q, k and v on chip, but wgmma rows come in 64s, so each 50-row
// sequence would fill a 64-row slot of that product (28% more tensor work)
// to save this kernel's bytes: a wash at these lengths (PERF.md, section 7).

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
// bf16, head dim 64, at most 128 keys: wgmma from a TMA/mbarrier ring,
// persistent blocks over the (sequence, head, query tile) items
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int HD = 64;             // one 128-byte swizzle row of bf16
constexpr int MAX_KEYS = 128;
constexpr int NWG = 2;             // consumer warpgroups
constexpr int THREADS = 128 * (NWG + 1);  // and the producer warpgroup
constexpr int OP = HD + 8;         // staging row: 16-byte rows, banks spread

// KT: the key tile, valid_len rounded up to 16.  SPLIT: a sequence has more
// than 64 rows, so both warpgroups work on one item (128 query rows sharing
// its K/V); otherwise each takes whole items of 64 query rows in turn.
template <int KT, bool SPLIT> struct Cfg {
  static constexpr int QROWS = SPLIT ? 128 : 64;
  static constexpr int Q_BYTES = QROWS * 128;
  static constexpr int KV_BYTES = KT * 128;      // a K or a V tile
  static constexpr int STAGE_BYTES = Q_BYTES + 2 * KV_BYTES;
  static constexpr int O_BYTES = NWG * 64 * OP * 2;
  static constexpr int FIT = (200 * 1024 - O_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  // the ring, a staging tile per warpgroup, room to align to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + O_BYTES + 1024;
};

struct Args {
  bf16* out;
  int D, heads, seq_stride, rows, valid_len, causal;
  int n_qt;    // query tiles a sequence
  int items;   // (sequence, head, query tile) triples
  float scale2;  // scale * log2(e): the softmax runs in base 2
};

// Item -> (sequence, head, first query row).  Blocks take items round robin,
// so the blocks running together read neighbouring heads of the same rows.
__device__ __forceinline__ void decode_item(const Args& a, int item, int qrows,
                                            int& seq, int& h, int& q0) {
  const int sh = item / a.n_qt;
  q0 = (item - sh * a.n_qt) * qrows;
  seq = sh / a.heads;
  h = sh - seq * a.heads;
}

// s (64 x KT) = a (64 x 16) b^T (KT x 16), both K-major from shared memory
template <int KT>
__device__ __forceinline__ void mma_scores(float* s, uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (KT == 16) wgmma_m64n16k16_ss<0>(s, da, db, scale_d);
  else if constexpr (KT == 32) wgmma_m64n32k16_ss<0>(s, da, db, scale_d);
  else if constexpr (KT == 48) wgmma_m64n48k16_ss<0>(s, da, db, scale_d);
  else if constexpr (KT == 64) wgmma_m64n64k16_ss<0>(s, da, db, scale_d);
  else if constexpr (KT == 80) wgmma_m64n80k16_ss<0>(s, da, db, scale_d);
  else if constexpr (KT == 96) wgmma_m64n96k16_ss<0>(s, da, db, scale_d);
  else if constexpr (KT == 112) wgmma_m64n112k16_ss<0>(s, da, db, scale_d);
  else wgmma_m64n128k16_ss<0>(s, da, db, scale_d);
}

template <int KT, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    attention_core_wgmma(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, Args a) {
  using C = Cfg<KT, SPLIT>;
  constexpr int STAGES = C::STAGES;
  static_assert(KT % 16 == 0 && KT >= 16 && KT <= MAX_KEYS, "key tile");
  static_assert(STAGES >= 2, "the ring needs two stages");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const ring = align_1024(smem_raw);
  bf16* const staging =
      reinterpret_cast<bf16*>(ring + STAGES * C::STAGE_BYTES);
  __shared__ uint64_t full[STAGES], empty[STAGES];

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);  // the producer's expect_tx arrival
      mbar_init(&empty[st], SPLIT ? NWG : 1);  // the warpgroups that read it
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: item n of this block goes to stage n % STAGES ----
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int n = 0;; ++n) {
        const int item = blockIdx.x + n * gridDim.x;
        if (item >= a.items) break;
        const int stage = n % STAGES, phase = (n / STAGES) & 1;
        int seq, h, q0;
        decode_item(a, item, C::QROWS, seq, h, q0);
        unsigned char* const st = ring + stage * C::STAGE_BYTES;
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], C::STAGE_BYTES);
        tma_load_3d(st, &map_q, &full[stage], h * HD, q0, seq);
        tma_load_3d(st + C::Q_BYTES, &map_k, &full[stage], h * HD, 0, seq);
        tma_load_3d(st + C::Q_BYTES + C::KV_BYTES, &map_v, &full[stage],
                    h * HD, 0, seq);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns 64 query rows of an item ----
    setmaxnreg_inc<232>();
    const int cw = tid / 128 - 1, t128 = tid % 128;
    const int warp = t128 >> 5, lane = t128 & 31, g = lane >> 2, t = lane & 3;
    bf16* const ot = staging + cw * 64 * OP;

    float s[KT / 2];       // S, then the fp32 P, 64 x KT
    uint32_t pf[KT / 4];   // P normalised and rounded to bf16: A of P V
    float o[HD / 2];       // O, 64 x 64

    for (int n = SPLIT ? 0 : cw;; n += SPLIT ? 1 : NWG) {
      const int item = blockIdx.x + n * gridDim.x;
      if (item >= a.items) break;
      const int stage = n % STAGES, phase = (n / STAGES) & 1;
      int seq, h, q0;
      decode_item(a, item, C::QROWS, seq, h, q0);
      unsigned char* const st = ring + stage * C::STAGE_BYTES;
      const int r0 = q0 + (SPLIT ? cw * 64 : 0);  // the warpgroup's first row
      const uint64_t dq =
          wgmma_desc_sw128(st + (SPLIT ? cw * 64 * 128 : 0), 16, 1024);
      const uint64_t dk = wgmma_desc_sw128(st + C::Q_BYTES, 16, 1024);
      const uint64_t dv =
          wgmma_desc_sw128(st + C::Q_BYTES + C::KV_BYTES, 16, 1024);

      mbar_wait(&full[stage], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_scores<KT>(s, wgmma_desc_advance(dq, 32 * kk),
                       wgmma_desc_advance(dk, 32 * kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin<KT / 2>(s);

      // softmax over the keys each row may see, on the fragments: this
      // thread holds rows ra and rb, columns 8 j + 2 t and the next; the 4
      // lanes of a group share a row.  A warp whose 16 rows all lie past
      // `rows` only feeds zeros to the product.
      if (r0 + warp * 16 < a.rows) {
        const int ra = r0 + warp * 16 + g, rb = ra + 8;
        const int kva = a.causal ? min(ra + 1, a.valid_len) : a.valid_len;
        const int kvb = a.causal ? min(rb + 1, a.valid_len) : a.valid_len;
        float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            if (col < kva) ma = fmaxf(ma, s[4 * j + e]);
            if (col < kvb) mb = fmaxf(mb, s[4 * j + 2 + e]);
          }
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, x));
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, x));
        }
        // scale2 > 0: the max of the scaled scores is the scaled max
        const float na = ma * a.scale2, nb = mb * a.scale2;
        float suma = 0.f, sumb = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            float& pa = s[4 * j + e];
            float& pb = s[4 * j + 2 + e];
            pa = col < kva ? ex2_approx(fmaf(pa, a.scale2, -na)) : 0.f;
            pb = col < kvb ? ex2_approx(fmaf(pb, a.scale2, -nb)) : 0.f;
            suma += pa;
            sumb += pb;
          }
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          suma += __shfl_xor_sync(0xffffffffu, suma, x);
          sumb += __shfl_xor_sync(0xffffffffu, sumb, x);
        }
        const float ia = 1.f / suma, ib = 1.f / sumb;
        // the S fragments of keys 16 kk .. + 15 are the A fragment of step kk
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          pf[2 * j] = pack_bf16(s[4 * j] * ia, s[4 * j + 1] * ia);
          pf[2 * j + 1] = pack_bf16(s[4 * j + 2] * ib, s[4 * j + 3] * ib);
        }
      } else {
#pragma unroll
        for (int i = 0; i < KT / 4; ++i) pf[i] = 0u;
      }

      // O = P V: V lies keys by channels, the MN-major operand; 16 keys
      // (2048 bytes) a step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_m64n64k16_rs<1>(o, pf + 4 * kk, wgmma_desc_advance(dv, 2048 * kk),
                              kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_pin<HD / 2>(o);
      if (t128 == 0) mbar_arrive(&empty[stage]);  // the stage may be refilled

      // O through this warpgroup's staging tile to 16-byte stores
      named_barrier_sync(1 + cw, 128);  // the last item's tile has been read
#pragma unroll
      for (int ct = 0; ct < HD / 8; ++ct) {
        bf16* const p = ot + (warp * 16 + g) * OP + ct * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[4 * ct], o[4 * ct + 1]);
        *reinterpret_cast<uint32_t*>(p + 8 * OP) =
            pack_bf16(o[4 * ct + 2], o[4 * ct + 3]);
      }
      named_barrier_sync(1 + cw, 128);
      bf16* const dst =
          a.out + ((size_t)seq * a.seq_stride + r0) * a.D + h * HD;
      for (int i = t128; i < 64 * (HD / 8); i += 128) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
        if (r0 + r < a.rows)
          *reinterpret_cast<uint4*>(dst + (size_t)r * a.D + c) =
              *reinterpret_cast<const uint4*>(ot + r * OP + c);
      }
    }
  }
}

// q, k or v as the 3-D map (channels, the first `bound` rows of a sequence,
// sequences) with boxes of 64 channels x `box_rows` rows of one sequence
static int make_map(CUtensorMap* map, const void* base, int D, int seq_stride,
                    int nseq, int bound, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)bound,
                              (cuuint64_t)nseq};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)seq_stride * D * 2};
  const cuuint32_t box[3] = {HD, (cuuint32_t)box_rows, 1};
  return make_tensor_map_bf16(map, base, 3, dims, strides, box);
}

template <int KT, bool SPLIT>
static int launch(const void* q, const void* k, const void* v, Args a,
                  int nseq, cudaStream_t stream) {
  using C = Cfg<KT, SPLIT>;
  CUtensorMap mq, mk, mv;
  if (int err = make_map(&mq, q, a.D, a.seq_stride, nseq, a.rows, C::QROWS))
    return err;
  if (int err = make_map(&mk, k, a.D, a.seq_stride, nseq, a.valid_len, KT))
    return err;
  if (int err = make_map(&mv, v, a.D, a.seq_stride, nseq, a.valid_len, KT))
    return err;
  a.n_qt = (a.rows + C::QROWS - 1) / C::QROWS;
  const long long items = (long long)nseq * a.heads * a.n_qt;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  const int sms = sm_count();  // one persistent block an SM
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  cudaFuncSetAttribute(attention_core_wgmma<KT, SPLIT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  attention_core_wgmma<KT, SPLIT>
      <<<a.items < sms ? a.items : sms, THREADS, C::SMEM, stream>>>(mq, mk, mv,
                                                                    a);
  return (int)cudaGetLastError();
}

// the key tile is valid_len rounded up to 16; up to 64 rows a sequence each
// warpgroup takes whole items (then valid_len <= rows <= 64 too)
template <bool SPLIT>
static int dispatch(const void* q, const void* k, const void* v,
                    const Args& a, int nseq, cudaStream_t stream) {
  switch ((a.valid_len + 15) / 16) {
    case 1: return launch<16, SPLIT>(q, k, v, a, nseq, stream);
    case 2: return launch<32, SPLIT>(q, k, v, a, nseq, stream);
    case 3: return launch<48, SPLIT>(q, k, v, a, nseq, stream);
    case 4: return launch<64, SPLIT>(q, k, v, a, nseq, stream);
  }
  if constexpr (SPLIT) {
    switch ((a.valid_len + 15) / 16) {
      case 5: return launch<80, true>(q, k, v, a, nseq, stream);
      case 6: return launch<96, true>(q, k, v, a, nseq, stream);
      case 7: return launch<112, true>(q, k, v, a, nseq, stream);
      case 8: return launch<128, true>(q, k, v, a, nseq, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg

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

// C entry: returns 0, the tensor-map encoder's error, or cudaGetLastError()
// after the launch.
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
  if (dtype == kBFloat16 && hd == wg::HD && valid_len <= wg::MAX_KEYS) {
    if (!(scale > 0.f) || seq_stride < rows) return (int)cudaErrorInvalidValue;
    wg::Args a;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.D = D;
    a.heads = heads;
    a.seq_stride = seq_stride;
    a.rows = rows;
    a.valid_len = valid_len;
    a.causal = causal != 0;
    a.n_qt = 0;
    a.items = 0;
    a.scale2 = scale * 1.4426950408889634f;
    return rows > 64 ? wg::dispatch<true>(q, k, v, a, nseq, s)
                     : wg::dispatch<false>(q, k, v, a, nseq, s);
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

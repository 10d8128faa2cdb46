// A whole transformer block in one launch: y1 = x + W_o MHA(LN1(x)) + b_o,
// then y = y1 + W2 quick_gelu(W1 LN2(y1) + b1) + b2, on flat (B*L, D) rows
// of whole sequences.  x is read from device memory once and y written
// once per layer; no intermediate leaves the SM (bf16).
//
// Replaces _block_kernel_compact / _block_pallas_compact
// (fused_block_sublayer_compact) of
// cross_modal_video_engine_tpu/ops/attention_sublayer.py (pallas_call at
// line 617).  Rounding points are those of the two-kernel chain
// (layernorm.cu + gemm.cu + attention_core.cu): fp32 LayerNorm statistics
// by two passes, every projection accumulated in fp32 and rounded to
// x.dtype, fp32 scores and softmax with P rounded to x.dtype before P v,
// quick_gelu in fp32 before the cast, each residual added in x.dtype to
// the rounded projection.
//
// bf16 design.  One 512-thread block owns a tile of up to 64 rows: as many
// whole sequences as fit (one at L = 50).  Shared memory (226.5 KB at
// D = 768) holds the residual stream (x, then y1, then y), a staging area
// (q | k | v^T of one head, or 192 hidden columns), a ring of weight tiles
// filled by cp.async, two 64-column slabs of LayerNorm output, and the
// LayerNorm's scale, bias and row statistics.  The
// D-wide output sum of a sublayer (64 x D fp32) stays in registers, 48
// columns a warp, while its operand arrives in pieces:
//   attention half, head by head: q, k, v of one head (64 x 3hd, K = D)
//     -> softmax(q k^T) v on four warps -> out += att_h W_o[:, head]^T;
//   MLP half, 192 hidden columns at a time: gelu(LN2 W1^T + b1)
//     -> out += hidden_chunk W2[:, chunk]^T.
// A projection step ("up") walks K in 64-column slabs: the weights of slab
// s + 2 are in flight while LN(x) of slab s + 1 is normalised from the
// residual stream and the row statistics (there is no room for a whole
// LayerNorm tile) and slab s is multiplied.  An accumulation step
// ("down") walks K 16 columns at a time over all D weight rows, two
// stages.  Every product is mma.sync m16n8k16 bf16 with both operands
// read from shared memory by ldmatrix.  Pad rows of k and v are written
// as zeros and masked as keys; the softmax of one tile covers several
// sequences by a block-diagonal mask.
//
// What bounds it on the H100: every block streams all of the block's
// weights (14.2 MB at D = 768) from L2, so at (51200, 768) a layer reads
// 1024 x 14.2 MB through L2 for 0.73 TFLOP of work, and the 64 x D output
// sum takes three quarters of the register file (96 of a thread's 128
// registers), which leaves one block per SM and makes ptxas spill.  The
// first version read the weights as 4-byte fragment loads (eight cache
// lines an instruction) and ran 7x slower than the two-kernel chain; there
// L2 latency was not yet the limit (with the weight loads confined to L1
// it was no faster).  The cp.async ring halves its time, and now the
// weight traffic is the first limit (per-phase cycles:
// bench/block_profile.py, PERF.md): issuing and waiting for the loads is
// half of the product steps' cycles, and no warp overlaps them with
// products, since one block per SM is in step at a barrier every 64
// columns of K.  Next come the shared-memory re-reads of the A tile (every
// warp reads it for its 24 columns) and the spills.  A faster design
// shares each weight tile over more rows (clusters with multicast TMA),
// feeds wgmma from shared memory, and splits the warps into producers and
// consumers.
//
// f32 exists to separate algorithm from rounding.  Its tiles do not fit in
// shared memory, so only the residual stream lives there; LN, q, k, v, the
// attention output and the hidden go through a per-block scratch in device
// memory that the wrapper allocates.  Still one launch; CUDA-core FMAs.

#include "common.cuh"

namespace cmve {

using bf16 = __nv_bfloat16;

constexpr int BLK_ROWS = 64;     // rows of a tile (whole sequences)
// threads of the bf16 block (256 measured 1.2x slower on the H100)
constexpr int BLK_THREADS = 512;
constexpr int BLK_WARPS = BLK_THREADS / 32;
constexpr int F32_THREADS = 256;
constexpr int BLK_MAX_D = 768;
constexpr int BLK_MAX_HD = 64;
constexpr int BLK_PAD = 8;                      // bank-spread row padding
constexpr int BLK_HS = BLK_MAX_HD + BLK_PAD;    // q, k, v^T rows of a head
constexpr int BLK_CHUNK = 192;                  // hidden columns per step
constexpr int BLK_CS = BLK_CHUNK + BLK_PAD;
// staging: q | k | v^T of one head, or one hidden chunk
constexpr int BLK_STAGE = 3 * BLK_ROWS * BLK_HS;
static_assert(BLK_STAGE >= BLK_ROWS * BLK_CS, "hidden chunk fits staging");
static_assert(3 * BLK_MAX_HD <= BLK_CHUNK, "q | k | v is one up step");
// up step: K in slabs of UP_KS columns; the weight ring holds UP_STAGES
// slabs of BLK_CHUNK rows; warps are 2 (row halves) x UP_NG (column groups
// of UP_NT 8-column tiles)
constexpr int UP_KS = 64;
constexpr int UP_KSP = UP_KS + BLK_PAD;
constexpr int UP_STAGES = 3;
constexpr int UP_STAGE = BLK_CHUNK * UP_KSP;    // elements
constexpr int UP_NG = BLK_WARPS / 2;
constexpr int UP_NT = BLK_CHUNK / 8 / UP_NG;
constexpr int LN_SLAB = BLK_ROWS * UP_KSP;      // elements
static_assert(UP_NT * UP_NG * 8 == BLK_CHUNK, "the up step's warp tiling");
static_assert((BLK_ROWS * UP_KS / 8) % BLK_THREADS == 0,
              "whole 8-element vectors of a LayerNorm slab per thread");
// down step: K 16 columns at a time over all D weight rows, two stages;
// a warp owns OUT_NT neighbouring 8-column tiles of the output
constexpr int DOWN_KP = 16 + BLK_PAD;
constexpr int DOWN_STAGE = BLK_MAX_D * DOWN_KP;  // elements
constexpr int OUT_NT = BLK_MAX_D / 8 / BLK_WARPS;
static_assert(OUT_NT * BLK_WARPS * 8 == BLK_MAX_D && OUT_NT % 2 == 0,
              "the output is covered, two tiles an ldmatrix");
constexpr int BLK_RING =
    UP_STAGES * UP_STAGE > 2 * DOWN_STAGE ? UP_STAGES * UP_STAGE
                                          : 2 * DOWN_STAGE;  // elements

struct BlockParams {
  const void* x;
  const void *ln1s, *ln1b, *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo;
  const void *ln2s, *ln2b, *w1, *b1, *w2, *b2;
  void* y;
  float* scratch;       // f32 only: per-block LN, q, k, v, att, hidden
  int n, D, heads, hd, hidden, seq_len, rows_per_block, causal;
  float eps, scale;
};

// float32 path: LayerNorm of the tile's 64 rows, src -> dst, one warp per
// row; the arithmetic and its order are layernorm.cu's
__device__ __forceinline__ void ln_tile_f32(const float* src, float* dst,
                                            int D,
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias,
                                            float eps, int warp, int nwarps,
                                            int lane) {
  const int nvec = D / 4;
  for (int r = warp; r < BLK_ROWS; r += nwarps) {
    const float4* xr = reinterpret_cast<const float4*>(src + r * D);
    float4* yr = reinterpret_cast<float4*>(dst + r * D);
    float s = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      const float4 e = xr[v];
      s += e.x;
      s += e.y;
      s += e.z;
      s += e.w;
    }
    const float mu = warp_sum(s) / (float)D;
    float s2 = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      const float4 e = xr[v];
      s2 += (e.x - mu) * (e.x - mu);
      s2 += (e.y - mu) * (e.y - mu);
      s2 += (e.z - mu) * (e.z - mu);
      s2 += (e.w - mu) * (e.w - mu);
    }
    const float rs = rsqrtf(warp_sum(s2) / (float)D + eps);
    for (int v = lane; v < nvec; v += 32) {
      const float4 e = xr[v];
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scale) + v);
      const float4 bi = __ldg(reinterpret_cast<const float4*>(bias) + v);
      yr[v] = make_float4((e.x - mu) * rs * sc.x + bi.x,
                          (e.y - mu) * rs * sc.y + bi.y,
                          (e.z - mu) * rs * sc.z + bi.z,
                          (e.w - mu) * rs * sc.w + bi.w);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, everything on chip
// ---------------------------------------------------------------------------

__device__ __forceinline__ void st_u32(bf16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

// -DCMVE_BLK_PROFILE: thread 0 of every block stamps clock64() at the phase
// boundaries below and block 0 writes the cycles of each phase to the
// scratch pointer (16 floats; unused by bf16 otherwise).  Phases 0-9 are
// the kernel's top level (chain 0), 10-12 split the up steps and 13-15 the
// down steps (chain 1).  A stamp costs some tens of cycles: read shares.
#ifdef CMVE_BLK_PROFILE
__device__ __forceinline__ void blk_mark(long long* prof, int chain, int i,
                                         int tid) {
  if (tid == 0) {
    const long long now = clock64();
    if (i >= 0) prof[i] += now - prof[16 + chain];
    prof[16 + chain] = now;
  }
}
#define BLK_MARK(chain, i) blk_mark(sm.prof, chain, i, tid)
#else
#define BLK_MARK(chain, i)
#endif

// the block's shared memory
struct BlockSmem {
  bf16* XS;       // [64][D + 8]: x, then y1, then y
  bf16* ST;       // staging: q | k | v^T of a head, or a hidden chunk
  bf16* LNS;      // two LayerNorm slabs [64][UP_KSP]
  bf16* LNP;      // LayerNorm scale [D], then bias [D]
  bf16* RING;     // weight tiles
  float2* stats;  // per row: mean, rsqrt(var + eps)
#ifdef CMVE_BLK_PROFILE
  long long* prof;  // 16 phase sums, then the two chains' last stamps
#endif
};

// fp32 statistics of the tile's 64 rows, one warp per row; the arithmetic
// and its order are layernorm.cu's
__device__ __forceinline__ void row_stats(const bf16* src, int stride, int D,
                                          float eps, float2* stats, int warp,
                                          int lane) {
  const int nvec = D / 8;
  for (int r = warp; r < BLK_ROWS; r += BLK_WARPS) {
    const bf16* xr = src + r * stride;
    float s = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      alignas(16) bf16 e[8];
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xr)[v];
#pragma unroll
      for (int j = 0; j < 8; ++j) s += to_f32(e[j]);
    }
    const float mu = warp_sum(s) / (float)D;
    float s2 = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      alignas(16) bf16 e[8];
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xr)[v];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = to_f32(e[j]) - mu;
        s2 += d * d;
      }
    }
    const float rs = rsqrtf(warp_sum(s2) / (float)D + eps);
    if (lane == 0) stats[r] = make_float2(mu, rs);
  }
}

// columns [k0, k0 + 64) of LN(rows of XS) into a slab, 8-element vectors
__device__ __forceinline__ void ln_slab(const BlockSmem& sm, int DP, int D,
                                        int k0, bf16* slab, int tid) {
#pragma unroll
  for (int j = 0; j < BLK_ROWS * UP_KS / 8 / BLK_THREADS; ++j) {
    const int idx = tid + j * BLK_THREADS, r = idx >> 3, c = (idx & 7) * 8;
    alignas(16) bf16 e[8], sc[8], bi[8];
    *reinterpret_cast<uint4*>(e) =
        *reinterpret_cast<const uint4*>(sm.XS + r * DP + k0 + c);
    *reinterpret_cast<uint4*>(sc) =
        *reinterpret_cast<const uint4*>(sm.LNP + k0 + c);
    *reinterpret_cast<uint4*>(bi) =
        *reinterpret_cast<const uint4*>(sm.LNP + D + k0 + c);
    const float2 st = sm.stats[r];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      e[q] = from_f32<bf16>((to_f32(e[q]) - st.x) * st.y * to_f32(sc[q]) +
                            to_f32(bi[q]));
    *reinterpret_cast<uint4*>(slab + r * UP_KSP + c) =
        *reinterpret_cast<uint4*>(e);
  }
}

// the LayerNorm's scale and bias into shared memory, once per sublayer
__device__ __forceinline__ void load_ln_params(const BlockSmem& sm, int D,
                                               const bf16* __restrict__ scale,
                                               const bf16* __restrict__ bias,
                                               int tid) {
  for (int i = tid; i < D / 8; i += BLK_THREADS) {
    reinterpret_cast<uint4*>(sm.LNP)[i] =
        __ldg(reinterpret_cast<const uint4*>(scale) + i);
    reinterpret_cast<uint4*>(sm.LNP + D)[i] =
        __ldg(reinterpret_cast<const uint4*>(bias) + i);
  }
}

// acc = LN(XS)[64 x D] W^T for the nB (<= 192, a multiple of 8) weight rows
// rowptr(0 .. nB - 1), each D long.  Warp (mh, ng) owns rows 32 mh .. + 31
// and the 8-column tiles 3 ng .. 3 ng + 2 (those below nB / 8).  Ends with
// every warp's products started; the caller synchronises before the ring,
// the slabs or the staging area change hands.
template <typename RowPtr>
__device__ __forceinline__ void up_phase(float (&acc)[2][UP_NT][4],
                                         const BlockSmem& sm, int DP, int D,
                                         RowPtr rowptr, int nB, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int mh = warp / UP_NG, ng = warp % UP_NG;
  const int cnt = min(max(nB / 8 - UP_NT * ng, 0), UP_NT);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < UP_NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][i][e] = 0.f;

  // 16-byte pieces of weight rows, global -> ring stage, by cp.async
  auto load_slab = [&](int s) {
    bf16* stage = sm.RING + (s % UP_STAGES) * UP_STAGE;
#pragma unroll
    for (int j = 0; j < BLK_CHUNK * (UP_KS / 8) / BLK_THREADS; ++j) {
      const int idx = tid + j * BLK_THREADS, R = idx >> 3, c = (idx & 7) * 8;
      if (R < nB)
        cp_async16(stage + R * UP_KSP + c, rowptr(R) + s * UP_KS + c, true);
    }
  };
  const int ns = D / UP_KS;
  BLK_MARK(1, -1);
  load_slab(0);
  cp_async_commit();
  if (ns > 1) load_slab(1);
  cp_async_commit();
  ln_slab(sm, DP, D, 0, sm.LNS, tid);
  BLK_MARK(1, 12);

  for (int s = 0; s < ns; ++s) {
    // slab s has landed; every warp is done with slab s - 1, whose ring
    // stage and LayerNorm slab are written next
    cp_async_wait<1>();
    __syncthreads();
    BLK_MARK(1, 11);
    if (s + 2 < ns) load_slab(s + 2);
    cp_async_commit();
    if (s + 1 < ns)
      ln_slab(sm, DP, D, (s + 1) * UP_KS, sm.LNS + ((s + 1) & 1) * LN_SLAB,
              tid);
    BLK_MARK(1, 12);
    if (cnt > 0) {
      const bf16* A = sm.LNS + (s & 1) * LN_SLAB +
                      (32 * mh + (lane & 15)) * UP_KSP + (lane >> 4) * 8;
      const bf16* B = sm.RING + (s % UP_STAGES) * UP_STAGE +
                      (UP_NT * ng * 8 + (lane & 7)) * UP_KSP +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < UP_KS; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[mi], A + mi * 16 * UP_KSP + kk);
        // two tiles an ldmatrix (lanes 16-31 address the second), then
        // the odd last one
#pragma unroll
        for (int pr = 0; pr < UP_NT / 2; ++pr)
          if (2 * pr < cnt) {
            uint32_t b[4];
            ldmatrix_x4(b, B + (2 * pr + (lane >> 4)) * 8 * UP_KSP + kk);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16_16816(acc[mi][2 * pr], af[mi], b);
              if (2 * pr + 1 < cnt)
                mma_bf16_16816(acc[mi][2 * pr + 1], af[mi], b + 2);
            }
          }
        if (UP_NT % 2 && cnt == UP_NT) {
          uint32_t b[2];
          ldmatrix_x2(b, B + (UP_NT - 1) * 8 * UP_KSP + kk);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_bf16_16816(acc[mi][UP_NT - 1], af[mi], b);
        }
      }
    }
    BLK_MARK(1, 10);
  }
}

// oacc += S[64 x kw] W[:, koff : koff + kw]^T, kw a multiple of 16.
// S: shared memory, row stride lds.  W: (D, ldw) row-major.  A warp owns
// the output tiles OUT_NT warp .. + OUT_NT - 1 (those below D / 8).  Ends
// synchronised: the ring and S are free.
__device__ __forceinline__ void down_phase(float (&oacc)[4][OUT_NT][4],
                                           const BlockSmem& sm, const bf16* S,
                                           int lds, int kw,
                                           const bf16* __restrict__ W,
                                           int ldw, int koff, int D,
                                           int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int cnt = min(max(D / 8 - OUT_NT * warp, 0), OUT_NT);
  auto load_step = [&](int s) {
    bf16* stage = sm.RING + (s & 1) * DOWN_STAGE;
#pragma unroll
    for (int j = 0; j < BLK_MAX_D * 2 / BLK_THREADS; ++j) {
      const int idx = tid + j * BLK_THREADS, R = idx >> 1, c = (idx & 1) * 8;
      if (R < D)
        cp_async16(stage + R * DOWN_KP + c,
                   W + (size_t)R * ldw + koff + 16 * s + c, true);
    }
  };
  const int nk = kw / 16;
  BLK_MARK(1, -1);
  load_step(0);
  cp_async_commit();
  BLK_MARK(1, 15);
  for (int s = 0; s < nk; ++s) {
    // step s has landed; every warp is done with step s - 1
    cp_async_wait<0>();
    __syncthreads();
    BLK_MARK(1, 14);
    if (s + 1 < nk) load_step(s + 1);
    cp_async_commit();
    BLK_MARK(1, 15);
    if (cnt > 0) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], S + (mi * 16 + (lane & 15)) * lds + 16 * s +
                                (lane >> 4) * 8);
      const bf16* B = sm.RING + (s & 1) * DOWN_STAGE +
                      (OUT_NT * warp * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                          DOWN_KP +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int pr = 0; pr < OUT_NT / 2; ++pr)
        if (2 * pr < cnt) {
          uint32_t b[4];  // tiles 2 pr and 2 pr + 1
          ldmatrix_x4(b, B + pr * 16 * DOWN_KP);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16_16816(oacc[mi][2 * pr], af[mi], b);
            if (2 * pr + 1 < cnt)
              mma_bf16_16816(oacc[mi][2 * pr + 1], af[mi], b + 2);
          }
        }
    }
    BLK_MARK(1, 13);
  }
  __syncthreads();
  BLK_MARK(1, 14);
}

// XS[r][c] = round(round(oacc + bias[c]) + XS[r][c]) for the warp's output
// tiles, in place; oacc is zeroed
__device__ __forceinline__ void residual_epilogue(
    float (&oacc)[4][OUT_NT][4], const bf16* __restrict__ bias, bf16* XS,
    int stride, int D, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int cnt = min(max(D / 8 - OUT_NT * warp, 0), OUT_NT);
#pragma unroll
  for (int i = 0; i < OUT_NT; ++i)
    if (i < cnt) {
      const int c = (OUT_NT * warp + i) * 8 + 2 * t;
      const float b0 = to_f32(bias[c]), b1 = to_f32(bias[c + 1]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          bf16* p = XS + (mi * 16 + g + 8 * half) * stride + c;
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p));
          const float p0 = round_to<bf16>(oacc[mi][i][2 * half] + b0);
          const float p1 = round_to<bf16>(oacc[mi][i][2 * half + 1] + b1);
          st_u32(p, pack_bf16(p0 + x.x, p1 + x.y));
          oacc[mi][i][2 * half] = 0.f;
          oacc[mi][i][2 * half + 1] = 0.f;
        }
    }
}

// softmax(q k^T * scale) v of one head for 16 query rows (one warp), the
// tile's rows being whole sequences of L rows: row r sees the keys of its
// own sequence (and, when causal, none after itself).  q is read from QS
// and the result written over the same rows.
__device__ __forceinline__ void attend_rows(bf16* QS, const bf16* KS,
                                            const bf16* VT, int mt, int hd,
                                            int L, int nrows, int causal,
                                            float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = mt * 16 + g, rb = ra + 8;
  uint32_t qf[BLK_MAX_HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < BLK_MAX_HD / 16; ++ks)
    if (ks * 16 < hd)
      ldmatrix_x4(qf[ks], QS + (mt * 16 + (lane & 15)) * BLK_HS + ks * 16 +
                              (lane >> 4) * 8);
  float sc[BLK_ROWS / 8][4];
#pragma unroll
  for (int nt = 0; nt < BLK_ROWS / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BLK_MAX_HD / 16; ++ks)
      if (ks * 16 < hd) {
        const bf16* kp = KS + (nt * 8 + g) * BLK_HS + ks * 16 + 2 * t;
        const uint32_t b[2] = {ld_u32(kp), ld_u32(kp + 8)};
        mma_bf16_16816(sc[nt], qf[ks], b);
      }
  }
  // keys [sa, ea) for row ra, [sb, eb) for row rb
  const int sa = (ra / L) * L, sb = (rb / L) * L;
  const int ea = min(min(sa + L, nrows), causal ? ra + 1 : BLK_ROWS);
  const int eb = min(min(sb + L, nrows), causal ? rb + 1 : BLK_ROWS);
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < BLK_ROWS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * t + e;
      sc[nt][e] = (col >= sa && col < ea) ? sc[nt][e] * scale : -INFINITY;
      sc[nt][2 + e] =
          (col >= sb && col < eb) ? sc[nt][2 + e] * scale : -INFINITY;
      ma = fmaxf(ma, sc[nt][e]);
      mb = fmaxf(mb, sc[nt][2 + e]);
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, o));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
  }
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int nt = 0; nt < BLK_ROWS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = nt * 8 + 2 * t + e;
      sc[nt][e] = (col >= sa && col < ea) ? expf(sc[nt][e] - ma) : 0.f;
      sc[nt][2 + e] =
          (col >= sb && col < eb) ? expf(sc[nt][2 + e] - mb) : 0.f;
      suma += sc[nt][e];
      sumb += sc[nt][2 + e];
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    suma += __shfl_xor_sync(0xffffffffu, suma, o);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, o);
  }
  // a pad row sees no key: all its P are 0
  if (suma == 0.f) suma = 1.f;
  if (sumb == 0.f) sumb = 1.f;

  float o[BLK_MAX_HD / 8][4];
#pragma unroll
  for (int ct = 0; ct < BLK_MAX_HD / 8; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ct][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < BLK_ROWS / 16; ++kt) {
    // P rounded to bf16: the S fragments of keys 16 kt .. 16 kt + 15 are
    // the A fragment of this step
    const uint32_t pf[4] = {
        pack_bf16(sc[2 * kt][0] / suma, sc[2 * kt][1] / suma),
        pack_bf16(sc[2 * kt][2] / sumb, sc[2 * kt][3] / sumb),
        pack_bf16(sc[2 * kt + 1][0] / suma, sc[2 * kt + 1][1] / suma),
        pack_bf16(sc[2 * kt + 1][2] / sumb, sc[2 * kt + 1][3] / sumb)};
#pragma unroll
    for (int ct = 0; ct < BLK_MAX_HD / 8; ++ct)
      if (ct * 8 < hd) {
        const bf16* vp = VT + (ct * 8 + g) * BLK_HS + kt * 16 + 2 * t;
        const uint32_t b[2] = {ld_u32(vp), ld_u32(vp + 8)};
        mma_bf16_16816(o[ct], pf, b);
      }
  }
  __syncwarp();  // every lane has its q fragments before the rows change
#pragma unroll
  for (int ct = 0; ct < BLK_MAX_HD / 8; ++ct)
    if (ct * 8 < hd) {
      st_u32(QS + ra * BLK_HS + ct * 8 + 2 * t, pack_bf16(o[ct][0], o[ct][1]));
      st_u32(QS + rb * BLK_HS + ct * 8 + 2 * t, pack_bf16(o[ct][2], o[ct][3]));
    }
}

__global__ void __launch_bounds__(BLK_THREADS, 1)
    block_kernel_bf16(const BlockParams p) {
  extern __shared__ __align__(16) unsigned char blk_smem[];
  const int D = p.D, DP = D + BLK_PAD, hd = p.hd, L = p.seq_len;
  BlockSmem sm;
  sm.XS = reinterpret_cast<bf16*>(blk_smem);
  sm.ST = sm.XS + BLK_ROWS * DP;
  sm.LNS = sm.ST + BLK_STAGE;
  sm.LNP = sm.LNS + 2 * LN_SLAB;
  sm.RING = sm.LNP + 2 * D;
  sm.stats = reinterpret_cast<float2*>(sm.RING + BLK_RING);
#ifdef CMVE_BLK_PROFILE
  __shared__ long long blk_prof[18];
  sm.prof = blk_prof;
  if (threadIdx.x == 0)
    for (int i = 0; i < 18; ++i) blk_prof[i] = 0;
#endif
  bf16* const QS = sm.ST;                       // q, then att: [row][c]
  bf16* const KS = QS + BLK_ROWS * BLK_HS;      // k: [key][c]
  bf16* const VT = KS + BLK_ROWS * BLK_HS;      // v^T: [c][key]
  bf16* const HS = sm.ST;                       // hidden chunk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mh = warp / UP_NG, ng = warp % UP_NG;  // the up step's tiling
  const int row0 = blockIdx.x * p.rows_per_block;
  const int nrows = min(p.rows_per_block, p.n - row0);
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* wq = static_cast<const bf16*>(p.wq);
  const bf16* wk = static_cast<const bf16*>(p.wk);
  const bf16* wv = static_cast<const bf16*>(p.wv);
  const bf16* bq = static_cast<const bf16*>(p.bq);
  const bf16* bk = static_cast<const bf16*>(p.bk);
  const bf16* bv = static_cast<const bf16*>(p.bv);
  const bf16* w1 = static_cast<const bf16*>(p.w1);
  const bf16* b1 = static_cast<const bf16*>(p.b1);
  BLK_MARK(0, -1);

  // x, read once; pad rows are zeros
  const int vpr = D / 8;
  for (int i = tid; i < BLK_ROWS * vpr; i += BLK_THREADS) {
    const int r = i / vpr, c = (i % vpr) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * D + c));
    *reinterpret_cast<uint4*>(sm.XS + r * DP + c) = v;
  }
  __syncthreads();
  row_stats(sm.XS, DP, D, p.eps, sm.stats, warp, lane);
  load_ln_params(sm, D, static_cast<const bf16*>(p.ln1s),
                 static_cast<const bf16*>(p.ln1b), tid);
  __syncthreads();
  BLK_MARK(0, 0);  // x and its statistics

  float oacc[4][OUT_NT][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int i = 0; i < OUT_NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mi][i][e] = 0.f;

  // -- attention half, head by head -----------------------------------------
  const int tph = hd / 8;  // 8-column tiles of one head
  for (int h = 0; h < p.heads; ++h) {
    {
      float acc[2][UP_NT][4];
      // weight row R of [q | k | v] of this head
      auto rowptr = [&](int R) {
        const int m = R / hd, rr = R - m * hd;
        return (m == 0 ? wq : m == 1 ? wk : wv) + (size_t)(h * hd + rr) * D;
      };
      up_phase(acc, sm, DP, D, rowptr, 3 * hd, tid);
      BLK_MARK(0, 1);  // q | k | v products
#pragma unroll
      for (int i = 0; i < UP_NT; ++i) {
        const int j = UP_NT * ng + i;  // tile of [q | k | v]
        if (j < 3 * tph) {
          const int m = j / tph, c = (j % tph) * 8 + 2 * t;
          const bf16* bm = (m == 0 ? bq : m == 1 ? bk : bv) + h * hd + c;
          const float c0 = to_f32(bm[0]), c1 = to_f32(bm[1]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 32 * mh + 16 * mi + g + 8 * half;
              const float v0 = acc[mi][i][2 * half] + c0;
              const float v1 = acc[mi][i][2 * half + 1] + c1;
              const bool live = r < nrows;  // pad rows of k and v: zeros
              if (m == 0) {
                st_u32(QS + r * BLK_HS + c, pack_bf16(v0, v1));
              } else if (m == 1) {
                st_u32(KS + r * BLK_HS + c, live ? pack_bf16(v0, v1) : 0u);
              } else {
                VT[c * BLK_HS + r] = from_f32<bf16>(live ? v0 : 0.f);
                VT[(c + 1) * BLK_HS + r] = from_f32<bf16>(live ? v1 : 0.f);
              }
            }
        }
      }
    }
    __syncthreads();
    BLK_MARK(0, 2);  // their epilogue
    if (warp < BLK_ROWS / 16)
      attend_rows(QS, KS, VT, warp, hd, L, nrows, p.causal, p.scale, lane);
    __syncthreads();
    BLK_MARK(0, 3);  // softmax(q k^T) v
    down_phase(oacc, sm, QS, BLK_HS, hd, static_cast<const bf16*>(p.wo), D,
               h * hd, D, tid);
    BLK_MARK(0, 4);  // output projection
  }
  // y1 = x + (att W_o^T + b_o), in place
  residual_epilogue(oacc, static_cast<const bf16*>(p.bo), sm.XS, DP, D, warp,
                    lane);
  __syncthreads();

  // -- MLP half, a chunk of hidden columns at a time -------------------------
  row_stats(sm.XS, DP, D, p.eps, sm.stats, warp, lane);
  load_ln_params(sm, D, static_cast<const bf16*>(p.ln2s),
                 static_cast<const bf16*>(p.ln2b), tid);
  __syncthreads();
  BLK_MARK(0, 5);  // y1 and its statistics
  for (int h0 = 0; h0 < p.hidden; h0 += BLK_CHUNK) {
    const int cw = min(BLK_CHUNK, p.hidden - h0);
    {
      float acc[2][UP_NT][4];
      auto rowptr = [&](int R) { return w1 + (size_t)(h0 + R) * D; };
      up_phase(acc, sm, DP, D, rowptr, cw, tid);
      BLK_MARK(0, 6);  // hidden chunk products
#pragma unroll
      for (int i = 0; i < UP_NT; ++i) {
        const int c = (UP_NT * ng + i) * 8 + 2 * t;
        if (c < cw) {
          const float c0 = to_f32(b1[h0 + c]), c1 = to_f32(b1[h0 + c + 1]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = 32 * mh + 16 * mi + g + 8 * half;
              float v0 = acc[mi][i][2 * half] + c0;
              float v1 = acc[mi][i][2 * half + 1] + c1;
              v0 = v0 * (1.0f / (1.0f + expf(-1.702f * v0)));
              v1 = v1 * (1.0f / (1.0f + expf(-1.702f * v1)));
              st_u32(HS + r * BLK_CS + c, pack_bf16(v0, v1));
            }
        }
      }
    }
    __syncthreads();
    BLK_MARK(0, 7);  // gelu epilogue
    down_phase(oacc, sm, HS, BLK_CS, cw, static_cast<const bf16*>(p.w2),
               p.hidden, h0, D, tid);
    BLK_MARK(0, 8);  // second MLP product
  }
  // y = y1 + (hidden W2^T + b2), in place, then written once in 16-byte
  // pieces
  residual_epilogue(oacc, static_cast<const bf16*>(p.b2), sm.XS, DP, D, warp,
                    lane);
  __syncthreads();
  bf16* y = static_cast<bf16*>(p.y);
  for (int i = tid; i < nrows * vpr; i += BLK_THREADS) {
    const int r = i / vpr, c = (i % vpr) * 8;
    *reinterpret_cast<uint4*>(y + (size_t)(row0 + r) * D + c) =
        *reinterpret_cast<const uint4*>(sm.XS + r * DP + c);
  }
  BLK_MARK(0, 9);  // y
#ifdef CMVE_BLK_PROFILE
  if (tid == 0 && blockIdx.x == 0 && p.scratch != nullptr)
    for (int i = 0; i < 16; ++i) p.scratch[i] = (float)sm.prof[i];
#endif
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, intermediates through the per-block scratch
// ---------------------------------------------------------------------------

// epi(r, n, sum_k A[r][k] W[n][k]) for the tile's 64 rows and n < N.  A is
// read by every thread at the same address (a broadcast), W rows by 16-byte
// loads; a thread owns a column and 16 rows at a time.
template <typename Epi>
__device__ __forceinline__ void gemm_f32(const float* A, int lda,
                                         const float* __restrict__ W, int ldw,
                                         int K, int N, Epi epi) {
  for (int n = threadIdx.x; n < N; n += F32_THREADS) {
    const float* wr = W + (size_t)n * ldw;
    for (int rb = 0; rb < BLK_ROWS; rb += 16) {
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.f;
      for (int k = 0; k < K; k += 4) {
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wr + k));
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(A + (rb + r) * lda + k);
          acc[r] = fmaf(a4.x, w4.x, acc[r]);
          acc[r] = fmaf(a4.y, w4.y, acc[r]);
          acc[r] = fmaf(a4.z, w4.z, acc[r]);
          acc[r] = fmaf(a4.w, w4.w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) epi(rb + r, n, acc[r]);
    }
  }
}

__global__ void __launch_bounds__(F32_THREADS, 1)
    block_kernel_f32(const BlockParams p) {
  extern __shared__ __align__(16) unsigned char blk_smem[];
  const int D = p.D, hd = p.hd, L = p.seq_len, HID = p.hidden;
  float* const XS = reinterpret_cast<float*>(blk_smem);  // x, then y1
  float* const LN = p.scratch + (size_t)blockIdx.x * BLK_ROWS * (5 * D + HID);
  float* const Q = LN + BLK_ROWS * D;
  float* const Kp = Q + BLK_ROWS * D;
  float* const V = Kp + BLK_ROWS * D;
  float* const ATT = V + BLK_ROWS * D;
  float* const H = ATT + BLK_ROWS * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int nrows = min(p.rows_per_block, p.n - row0);
  const float* x = static_cast<const float*>(p.x);
  const float* bq = static_cast<const float*>(p.bq);
  const float* bk = static_cast<const float*>(p.bk);
  const float* bv = static_cast<const float*>(p.bv);
  const float* bo = static_cast<const float*>(p.bo);
  const float* b1 = static_cast<const float*>(p.b1);
  const float* b2 = static_cast<const float*>(p.b2);

  const int vpr = D / 4;
  for (int i = tid; i < BLK_ROWS * vpr; i += F32_THREADS) {
    const int r = i / vpr, c = (i % vpr) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows)
      v = __ldg(
          reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * D + c));
    *reinterpret_cast<float4*>(XS + r * D + c) = v;
  }
  __syncthreads();
  ln_tile_f32(XS, LN, D, static_cast<const float*>(p.ln1s),
              static_cast<const float*>(p.ln1b), p.eps, warp,
              F32_THREADS / 32, lane);
  __syncthreads();
  gemm_f32(LN, D, static_cast<const float*>(p.wq), D, D, D,
           [&](int r, int n, float v) { Q[r * D + n] = v + bq[n]; });
  gemm_f32(LN, D, static_cast<const float*>(p.wk), D, D, D,
           [&](int r, int n, float v) { Kp[r * D + n] = v + bk[n]; });
  gemm_f32(LN, D, static_cast<const float*>(p.wv), D, D, D,
           [&](int r, int n, float v) { V[r * D + n] = v + bv[n]; });
  __syncthreads();

  // one thread per (row, head); pad rows are skipped, so no pad key is read
  for (int task = tid; task < nrows * p.heads; task += F32_THREADS) {
    const int r = task / p.heads, h = task % p.heads;
    const int s0 = (r / L) * L;
    const int nk = (p.causal ? r + 1 : min(s0 + L, nrows)) - s0;
    const float* q = Q + r * D + h * hd;
    float sc[BLK_ROWS];
    float m = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      const float* kr = Kp + (s0 + j) * D + h * hd;
      float d = 0.f;
      for (int c = 0; c < hd; ++c) d = fmaf(q[c], kr[c], d);
      sc[j] = d * p.scale;
      m = fmaxf(m, sc[j]);
    }
    float sum = 0.f;
    for (int j = 0; j < nk; ++j) {
      sc[j] = expf(sc[j] - m);
      sum += sc[j];
    }
    for (int j = 0; j < nk; ++j) sc[j] = sc[j] / sum;
    for (int c = 0; c < hd; ++c) {
      float o = 0.f;
      for (int j = 0; j < nk; ++j)
        o = fmaf(sc[j], V[(s0 + j) * D + h * hd + c], o);
      ATT[r * D + h * hd + c] = o;
    }
  }
  // pad rows of the attention output: zeros, so that the products below
  // read nothing unwritten
  for (int i = tid; i < (BLK_ROWS - nrows) * D; i += F32_THREADS)
    ATT[nrows * D + i] = 0.f;
  __syncthreads();
  gemm_f32(ATT, D, static_cast<const float*>(p.wo), D, D, D,
           [&](int r, int n, float v) {
             XS[r * D + n] = (v + bo[n]) + XS[r * D + n];
           });
  __syncthreads();
  ln_tile_f32(XS, LN, D, static_cast<const float*>(p.ln2s),
              static_cast<const float*>(p.ln2b), p.eps, warp,
              F32_THREADS / 32, lane);
  __syncthreads();
  gemm_f32(LN, D, static_cast<const float*>(p.w1), D, D, HID,
           [&](int r, int n, float v) {
             v += b1[n];
             H[r * HID + n] = v * (1.0f / (1.0f + expf(-1.702f * v)));
           });
  __syncthreads();
  float* y = static_cast<float*>(p.y);
  gemm_f32(H, HID, static_cast<const float*>(p.w2), HID, HID, D,
           [&](int r, int n, float v) {
             if (r < nrows)
               y[(size_t)(row0 + r) * D + n] = (v + b2[n]) + XS[r * D + n];
           });
}

static int rows_per_block(int seq_len) {
  return (BLK_ROWS / seq_len) * seq_len;
}

static bool block_shape_ok(int n, int D, int heads, int hidden, int seq_len) {
  if (n <= 0 || heads <= 0 || seq_len < 1 || seq_len > BLK_ROWS) return false;
  if (n % seq_len || D % 64 || D < 64 || D > BLK_MAX_D || D % heads)
    return false;
  const int hd = D / heads;
  return hd % 16 == 0 && hd <= BLK_MAX_HD && hidden > 0 && hidden % 64 == 0;
}

}  // namespace cmve

// Bytes of device scratch cmve_block_sublayer needs for this call (0 in
// bf16, where everything stays on chip); -1 for a shape it does not take.
extern "C" long long cmve_block_scratch_bytes(int dtype, int n, int D,
                                              int heads, int hidden,
                                              int seq_len) {
  using namespace cmve;
  if (!block_shape_ok(n, D, heads, hidden, seq_len)) return -1;
  if (dtype == kBFloat16) return 0;
  if (dtype != kFloat32) return -1;
  const int rpb = rows_per_block(seq_len);
  const long long blocks = (n + rpb - 1) / rpb;
  return blocks * BLK_ROWS * (5LL * D + hidden) * (long long)sizeof(float);
}

// C entry: one launch for the whole block; returns cudaGetLastError() after
// it (0 on success).  Weights in torch Linear layout, (out, in) row-major,
// everything in the dtype of x and 16-byte aligned.
extern "C" int cmve_block_sublayer(
    int dtype, const void* x, const void* ln1s, const void* ln1b,
    const void* wq, const void* bq, const void* wk, const void* bk,
    const void* wv, const void* bv, const void* wo, const void* bo,
    const void* ln2s, const void* ln2b, const void* w1, const void* b1,
    const void* w2, const void* b2, void* y, void* scratch, int n, int D,
    int heads, int hidden, int seq_len, int causal, float eps, float scale,
    void* stream) {
  using namespace cmve;
  if (!block_shape_ok(n, D, heads, hidden, seq_len))
    return (int)cudaErrorInvalidValue;
  BlockParams p;
  p.x = x;
  p.ln1s = ln1s; p.ln1b = ln1b;
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk; p.wv = wv; p.bv = bv;
  p.wo = wo; p.bo = bo;
  p.ln2s = ln2s; p.ln2b = ln2b;
  p.w1 = w1; p.b1 = b1; p.w2 = w2; p.b2 = b2;
  p.y = y;
  p.scratch = static_cast<float*>(scratch);
  p.n = n; p.D = D; p.heads = heads; p.hd = D / heads; p.hidden = hidden;
  p.seq_len = seq_len; p.rows_per_block = rows_per_block(seq_len);
  p.causal = causal; p.eps = eps; p.scale = scale;
  const int grid = (n + p.rows_per_block - 1) / p.rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const int smem = (BLK_ROWS * (D + BLK_PAD) + BLK_STAGE + 2 * LN_SLAB +
                      2 * D + BLK_RING) * (int)sizeof(bf16) +
                     BLK_ROWS * (int)sizeof(float2);
    cudaFuncSetAttribute(block_kernel_bf16,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    block_kernel_bf16<<<grid, BLK_THREADS, smem, s>>>(p);
  } else if (dtype == kFloat32) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int smem = BLK_ROWS * D * (int)sizeof(float);
    cudaFuncSetAttribute(block_kernel_f32,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    block_kernel_f32<<<grid, F32_THREADS, smem, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// A whole transformer block in one launch: y1 = x + W_o MHA(LN1(x)) + b_o,
// then y = y1 + W2 quick_gelu(W1 LN2(y1) + b1) + b2, on flat (B*L, D) rows
// of whole sequences (bf16: no intermediate but y1 leaves the SM).
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
// What bounds it on the H100.  One 512-thread block owns a tile of up to 64
// rows (as many whole sequences as fit: one at L = 50), and every block
// streams all of the layer's weights, 14.16 MB at D = 768, from L2: at
// (51200, 768) that is 1024 blocks and 14.5 GB through L2 for 0.73 TFLOP.
// So the weight stream, not the tensor cores, sets the pace, and the 64 x D
// fp32 output sum of a sublayer takes 96 of a thread's 128 registers.
//
// bf16 design.  The layer's weight tiles are used in an order fixed before
// the launch (`load_tile`): per head the q|k rows of the head in 64-column
// slabs of K, then its v rows, then its W_o columns, one tile per output
// quarter of 192 columns; then per chunk of 128 hidden columns its W1 slabs
// and its W2 tiles.  The six matrices are 2-D TMA tensor maps with the
// 128-byte swizzle, kept on the host by (address, shape, box); tiles of up
// to 192 x 64 arrive in a ring of three 24 KB slots on full mbarriers, and
// the warp that finishes the last read of a slot starts the tile that
// takes the slot next: the ring runs ahead across heads, steps and the two
// halves, with no producer warp (a thread's 128 registers are all taken)
// and no block barrier between the slabs of a step.  The block barriers
// left hand the staging area (q | k | v^T of a head, or a hidden chunk)
// and the LayerNorm tile between steps.  LN(x) of the whole tile is made
// once per sublayer into shared memory (96 KB), where the products read
// it; x is read again from device memory for the residual, and y1 goes to
// y and is read back by the MLP half: 0.24 GB a layer at (51200, 768)
// against the 14.5 GB of weights, for no LayerNorm work inside the steps.
// An up step's result is at most 64 x 128 (16 registers a thread), and a
// thread parks 16 of its output sum's 96 registers in shared memory from
// before an up step to the down step that needs them (see PARK).  Two
// routes share all of this and differ in the products (`block_path` in
// ops/attention_sublayer.py names them):
//  * "wgmma" (width a multiple of 192, head dim 64): four consumer
//    warpgroups; an up step is wgmma m64n32k16 (m64n16k16 for v) a
//    warpgroup, A the LayerNorm tile by descriptor; a down step (into the
//    output sum) is m64n192k16 on the warpgroup's output quarter, A the
//    attention output or the hidden chunk, written swizzled by the
//    epilogues;
//  * "mma" (the other shapes): mma.sync m16n8k16, both operands by
//    ldmatrix at swizzled addresses, 16 warps.
// Softmax(q k^T) v of one head runs on four warps with mma.sync (under 2%
// of the operations; on 16 warps, four a row tile, it was slower); pad rows
// of k and v are written as zeros and masked as keys, and the softmax of
// one tile covers several sequences by a block-diagonal mask.
//
// -DCMVE_BLK_PROFILE stamps cycles by phase (bench/block_profile.py);
// -DCMVE_BLK_NO_MMA skips the products of the weight stream (up and down
// steps) and keeps the launch, the schedule and every load: its time is the
// load-side ceiling of this design; -DCMVE_BLK_NO_WGMMA keeps every shape
// on mma.sync, to time the two routes in one call.
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
// output columns of a quarter (of four warps, or one warpgroup), and the
// most rows of a ring slot
constexpr int QUARTER = 192;
// the most columns of an up step's result: q | k of a head, v of a head,
// or a chunk of hidden columns (an MLP step)
constexpr int UPW = 128;
constexpr int SUB = BLK_ROWS * 64;   // elements of a 64 x 64 tile: 8 KB
constexpr int SLOT = QUARTER * 64;   // elements of a ring slot: 24 KB
constexpr int NSLOT = 3;             // ring slots
constexpr int UP_NT = UPW / 8 / 8;          // mma up step: tiles of a warp
constexpr int OUT_NT = QUARTER / 4 / 8;     // mma down step: the same
static_assert(2 * BLK_MAX_HD <= UPW, "q | k of a head is one up step");
static_assert(UP_NT == 2 && OUT_NT == 6, "the mma tilings below");
static_assert(BLK_MAX_D == 4 * QUARTER, "four output quarters at most");

// the layer's tile schedule (see load_tile), made on the host
struct Sched {
  int ks;          // D / 64: slabs of an up step
  int nq;          // output quarters: ceil(D / 192)
  int per_head;    // 2 ks + nq
  int attn_tiles;  // heads * per_head
  int per_chunk;   // ks + 2 nq: tiles of a full hidden chunk
  int total;       // tiles of the layer
  int o_rows;      // rows of a wo / w2 box: min(192, D)
  int w1_rows;     // rows of a w1 box: min(128, hidden)
};

struct BlockParams {
  const void* x;
  const void *ln1s, *ln1b, *wq, *bq, *wk, *bk, *wv, *bv, *wo, *bo;
  const void *ln2s, *ln2b, *w1, *b1, *w2, *b2;
  void* y;
  float* scratch;       // f32 only: per-block LN, q, k, v, att, hidden
  int n, D, heads, hd, hidden, seq_len, rows_per_block, causal;
  float eps, scale;
  Sched sched;          // bf16 only
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
// bf16: the weight stream on TMA, tensor cores for the products
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
__shared__ long long blk_prof[18];  // 16 phase sums, the chains' last stamps
__device__ __forceinline__ void blk_mark(int chain, int i) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    if (i >= 0) blk_prof[i] += now - blk_prof[16 + chain];
    blk_prof[16 + chain] = now;
  }
}
#define BLK_MARK(chain, i) blk_mark(chain, i)
#else
#define BLK_MARK(chain, i)
#endif

// The six weight matrices as 2-D tensor maps (columns, rows), 128-byte
// swizzle, boxes of 64 columns: wq, wk, wv (hd rows), wo, w1, w2 (up to 192
// rows).
struct WeightMaps {
  const CUtensorMap* m[6];
};

// The ring: NSLOT slots of SLOT elements, a full barrier each (one arrival
// with the bytes, then the TMA bytes), and a count of the warps done with
// the slot's tile.
struct Ring {
  bf16* slots;
  uint64_t* full;
  int* done;
};

// Starts the loads of tile t of the layer's schedule into its slot.  The
// schedule, in the order the products use the tiles:
//   for each head h:  ks tiles "QK": rows h*hd .. of wq | wk, columns 64 s ..
//                       64 s + 63 (two boxes of hd rows);
//                     ks tiles "V": the same of wv (one box);
//                     nq tiles "O": rows 192 j .. of wo, columns h*hd ..
//                       h*hd + 63, for the output quarter j;
//   for each hidden chunk c of 128:  ks tiles "W1": rows 128 c .. of w1,
//                       columns 64 s ..;  then for each 64 columns k of the
//                       chunk, nq tiles "W2": rows 192 j .. of w2, columns
//                       128 c + 64 k ...
// Rows and columns past a matrix's end arrive as zeros.
__device__ __forceinline__ void load_tile(const BlockParams& p,
                                           const WeightMaps& w,
                                           const Ring& r, int t) {
  const Sched& s = p.sched;
  bf16* dst = r.slots + (t % NSLOT) * SLOT;
  uint64_t* bar = r.full + t % NSLOT;
  if (t < s.attn_tiles) {
    const int h = t / s.per_head, i = t - h * s.per_head;
    if (i < s.ks) {
      mbar_expect_tx(bar, 2 * p.hd * 128);
      tma_load_2d(dst, w.m[0], bar, 64 * i, h * p.hd);
      tma_load_2d(dst + p.hd * 64, w.m[1], bar, 64 * i, h * p.hd);
    } else if (i < 2 * s.ks) {
      mbar_expect_tx(bar, p.hd * 128);
      tma_load_2d(dst, w.m[2], bar, 64 * (i - s.ks), h * p.hd);
    } else {
      mbar_expect_tx(bar, s.o_rows * 128);
      tma_load_2d(dst, w.m[3], bar, h * p.hd, QUARTER * (i - 2 * s.ks));
    }
  } else {
    const int u = t - s.attn_tiles, c = u / s.per_chunk,
              i = u - c * s.per_chunk;
    if (i < s.ks) {
      mbar_expect_tx(bar, s.w1_rows * 128);
      tma_load_2d(dst, w.m[4], bar, 64 * i, UPW * c);
    } else {
      const int m = i - s.ks, k = m / s.nq, j = m - k * s.nq;
      mbar_expect_tx(bar, s.o_rows * 128);
      tma_load_2d(dst, w.m[5], bar, UPW * c + 64 * k, QUARTER * j);
    }
  }
}

__device__ __forceinline__ const bf16* tile_wait(const Ring& r, int t) {
  mbar_wait(&r.full[t % NSLOT], (t / NSLOT) & 1);
  return r.slots + (t % NSLOT) * SLOT;
}

// A warp is done with tile t.  Every warp waits for every tile and releases
// it, those of the other output quarters too (at once): a warp that skipped
// a fill of a slot could take a later phase of the same parity for the one
// it waits for.  The warp that completes the count starts the tile that
// takes the slot next, so the ring runs NSLOT tiles ahead of the slowest
// warp, across steps and phases, with no block barrier.
__device__ __forceinline__ void tile_release(const BlockParams& p,
                                             const WeightMaps& w,
                                             const Ring& r, int t, int lane) {
  __syncwarp();
  if (lane == 0) {
    const int slot = t % NSLOT;
    __threadfence_block();
    if (atomicAdd(&r.done[slot], 1) + 1 == BLK_WARPS) {
      r.done[slot] = 0;
      if (t + NSLOT < p.sched.total) load_tile(p, w, r, t + NSLOT);
    }
  }
  __syncwarp();
}

// LN(rows row0 .. row0 + nrows - 1 of src) into the LayerNorm tile (D / 64
// sub-tiles), one warp per row; rows past nrows are zero rows.  fp32
// statistics by two passes over the row held in registers, in
// layernorm.cu's order; scale and bias in x.dtype.  `ro`: src is read-only
// for the kernel's lifetime (x), else it was written by this block (y1).
__device__ __forceinline__ void ln_tile(const bf16* src, bool ro, int row0,
                                        int nrows, int D,
                                        const bf16* __restrict__ scale,
                                        const bf16* __restrict__ bias,
                                        float eps, bf16* LN, int warp,
                                        int lane) {
  constexpr int NV = BLK_MAX_D / 8 / 32;  // 8-element vectors per lane
  const int nvec = D / 8;
  for (int r = warp; r < BLK_ROWS; r += BLK_WARPS) {
    alignas(16) bf16 e[NV][8];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (v < nvec && r < nrows) {
        const uint4* g =
            reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D) + v;
        u = ro ? __ldg(g) : *g;
      }
      *reinterpret_cast<uint4*>(e[i]) = u;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int j = 0; j < 8; ++j) s += to_f32(e[i][j]);
    const float mu = warp_sum(s) / (float)D;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (lane + 32 * i < nvec)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = to_f32(e[i][j]) - mu;
          s2 += d * d;
        }
    const float rs = rsqrtf(warp_sum(s2) / (float)D + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        alignas(16) bf16 sc[8], bi[8];
        *reinterpret_cast<uint4*>(sc) =
            __ldg(reinterpret_cast<const uint4*>(scale) + v);
        *reinterpret_cast<uint4*>(bi) =
            __ldg(reinterpret_cast<const uint4*>(bias) + v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[i][j] = from_f32<bf16>((to_f32(e[i][j]) - mu) * rs *
                                       to_f32(sc[j]) +
                                   to_f32(bi[j]));
        *reinterpret_cast<uint4*>(LN + (v >> 3) * SUB + swz(r, (v & 7) * 8)) =
            *reinterpret_cast<const uint4*>(e[i]);
      }
    }
  }
}

// softmax(q k^T * scale) v of one head for 16 query rows (one warp), the
// tile's rows being whole sequences of L rows: row r sees the keys of its
// own sequence (and, when causal, none after itself).  q, k: [row][c], v^T:
// [c][key], swizzled tiles; the result is written over the warp's q rows,
// which is where the output projection reads it.
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
      ldmatrix_x4(qf[ks], QS + swz(mt * 16 + (lane & 15),
                                   ks * 16 + (lane >> 4) * 8));
  float sc[BLK_ROWS / 8][4];
#pragma unroll
  for (int nt = 0; nt < BLK_ROWS / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BLK_MAX_HD / 16; ++ks)
      if (ks * 16 < hd) {
        const int kr = nt * 8 + g, kc = ks * 16 + 2 * t;
        const uint32_t b[2] = {ld_u32(KS + swz(kr, kc)),
                               ld_u32(KS + swz(kr, kc + 8))};
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

  // P rounded to bf16: the S fragments of keys 16 kt .. 16 kt + 15 are the
  // A fragment of P v step kt
  uint32_t pf[BLK_ROWS / 16][4];
#pragma unroll
  for (int kt = 0; kt < BLK_ROWS / 16; ++kt) {
    pf[kt][0] = pack_bf16(sc[2 * kt][0] / suma, sc[2 * kt][1] / suma);
    pf[kt][1] = pack_bf16(sc[2 * kt][2] / sumb, sc[2 * kt][3] / sumb);
    pf[kt][2] = pack_bf16(sc[2 * kt + 1][0] / suma, sc[2 * kt + 1][1] / suma);
    pf[kt][3] = pack_bf16(sc[2 * kt + 1][2] / sumb, sc[2 * kt + 1][3] / sumb);
  }
  __syncwarp();  // every lane has its q fragments before the rows change
  // P v, 32 channels at a time (fewer live registers beside the output sum)
#pragma unroll
  for (int c0 = 0; c0 < BLK_MAX_HD; c0 += 32)
    if (c0 < hd) {
      float o[4][4];
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[ct][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < BLK_ROWS / 16; ++kt)
#pragma unroll
        for (int ct = 0; ct < 4; ++ct)
          if (c0 + ct * 8 < hd) {
            const int vr = c0 + ct * 8 + g, vc = kt * 16 + 2 * t;
            const uint32_t b[2] = {ld_u32(VT + swz(vr, vc)),
                                   ld_u32(VT + swz(vr, vc + 8))};
            mma_bf16_16816(o[ct], pf[kt], b);
          }
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
        if (c0 + ct * 8 < hd) {
          const int c = c0 + ct * 8 + 2 * t;
          st_u32(QS + swz(ra, c), pack_bf16(o[ct][0], o[ct][1]));
          st_u32(QS + swz(rb, c), pack_bf16(o[ct][2], o[ct][3]));
        }
    }
}

// -- the products ------------------------------------------------------------
//
// Two routes share the weight stream and the schedule and differ in the
// products.  Accumulators are flat register arrays: the output sum `oacc`
// (96 fp32: 64 rows x 48 columns a warp, or 64 x 192 a warpgroup) and an
// up step's `acc` (16 fp32: 64 x 128 over the block).
//  * "mma" (WG = false): mma.sync m16n8k16, both operands by ldmatrix.  Up
//    step: warp (mh, ng) = (warp / 8, warp % 8) owns rows 32 mh .. + 31 and
//    the 8-column tiles 2 ng, 2 ng + 1 (those below nB / 8) of the 64 x nB
//    result, acc[(mi * 2 + i) * 4 + e].  Down step: warp w owns output
//    columns 48 w .. 48 w + 47, rows 48 (w % 4) .. of its quarter's slot,
//    oacc[(mi * 6 + i) * 4 + e].
//  * "wgmma" (WG = true; width a multiple of 192, head dim 64): warpgroup
//    wg = warp / 4.  Up step: m64nNk16 on slot rows N wg .. N wg + N - 1
//    (N = nB / 4: 32, or 16 for v of a head), A the LayerNorm tile by
//    descriptor.  Down step: m64n192k16 on its quarter's slot, A the
//    attention output or a hidden chunk by descriptor.  Element j of a
//    thread's accumulators is row 16 (warp % 4) + lane / 4 + 8 ((j / 2) %
//    2), column 8 (j / 4) + 2 (lane % 4) + j % 2 of the warpgroup's result
//    (the mma.sync C fragment, repeated).

constexpr int UP_ACC = 2 * UP_NT * 4;   // 16
constexpr int OUT_ACC = 4 * OUT_NT * 4; // 96
static_assert(UP_ACC == UPW / 4 / 2 && OUT_ACC == QUARTER / 2,
              "the two routes hold the same registers");
// The output sum and an up step's accumulators would be 112 of a thread's
// 128 registers, and a wgmma's accumulators must be one run of registers.
// ptxas, left to itself, serialized every wgmma and swapped the up step's
// accumulators with part of the output sum through local memory at every
// slab (L2 traffic: with this much shared memory, L1 is small).  So a
// thread parks the last PARK registers of its output sum in shared memory
// from before each up step until the down step that needs them.
constexpr int PARK = 16;

__device__ __forceinline__ void park(const float (&oacc)[OUT_ACC], float* pk,
                                     int tid) {
#pragma unroll
  for (int j = 0; j < PARK; ++j)
    pk[j * BLK_THREADS + tid] = oacc[OUT_ACC - PARK + j];
}
__device__ __forceinline__ void unpark(float (&oacc)[OUT_ACC],
                                       const float* pk, int tid) {
#pragma unroll
  for (int j = 0; j < PARK; ++j)
    oacc[OUT_ACC - PARK + j] = pk[j * BLK_THREADS + tid];
}

// mma: acc (+)= A_s[64 x 64] B^T, B the nB rows of a slot; cnt the warp's
// tiles
__device__ __forceinline__ void mma_up_slab(float (&acc)[UP_ACC],
                                            const bf16* A, const bf16* B,
                                            int cnt, int mh, int ng,
                                            int lane) {
#ifndef CMVE_BLK_NO_MMA
  if (cnt <= 0) return;
  const int ar = 32 * mh + (lane & 15), ac = (lane >> 4) * 8;
  // tiles 2 ng and 2 ng + 1: lanes 16-31 address the second
  const int br = (UP_NT * ng + (lane >> 4)) * 8 + (lane & 7);
  const int bc = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    uint32_t af[2][4], b[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(af[mi], A + swz(ar + 16 * mi, kk + ac));
    ldmatrix_x4(b, B + swz(br, kk + bc));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_bf16_16816(&acc[(mi * UP_NT + 0) * 4], af[mi], b);
      if (cnt > 1) mma_bf16_16816(&acc[(mi * UP_NT + 1) * 4], af[mi], b + 2);
    }
  }
#endif
}

// mma: oacc += A[64 x kw] B^T over the warp's 48 rows of the slot B; A one
// swizzled 64-column tile, kw <= 64 a multiple of 16
__device__ __forceinline__ void mma_down(float (&oacc)[OUT_ACC], const bf16* A,
                                         int kw, const bf16* B, int cnt,
                                         int wl, int lane) {
#ifndef CMVE_BLK_NO_MMA
  if (cnt <= 0) return;
  const int br = 48 * wl + (lane & 7) + ((lane >> 4) << 3);
  const int bc = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < BLK_MAX_HD; kk += 16)
    if (kk < kw) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi],
                    A + swz(16 * mi + (lane & 15), kk + (lane >> 4) * 8));
#pragma unroll
      for (int pr = 0; pr < OUT_NT / 2; ++pr)
        if (2 * pr < cnt) {
          uint32_t b[4];  // tiles 2 pr and 2 pr + 1
          ldmatrix_x4(b, B + swz(br + 16 * pr, kk + bc));
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            mma_bf16_16816(&oacc[(mi * OUT_NT + 2 * pr) * 4], af[mi], b);
            if (2 * pr + 1 < cnt)
              mma_bf16_16816(&oacc[(mi * OUT_NT + 2 * pr + 1) * 4], af[mi],
                             b + 2);
          }
        }
    }
#endif
}

// wgmma: acc (+)= A_s[64 x 64] B_wg^T, B_wg slot rows N wg .. N wg + N - 1
// (N = 32 or 16); waits (the slot is free after it, and no accumulator is in
// flight while the release runs)
template <int N>
__device__ __forceinline__ void wg_up_slab(float (&acc)[UP_ACC],
                                           const bf16* A, const bf16* B,
                                           int wg, bool first) {
#ifndef CMVE_BLK_NO_MMA
  const uint64_t da = wgmma_desc_sw128(A, 16, 1024);
  const uint64_t db = wgmma_desc_sw128(B + N * wg * 64, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t a = wgmma_desc_advance(da, 32 * k);
    const uint64_t b = wgmma_desc_advance(db, 32 * k);
    if constexpr (N == 32)
      wgmma_m64n32k16_ss<0>(acc, a, b, !first || k > 0);
    else
      wgmma_m64n16k16_ss<0>(acc, a, b, !first || k > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin<N / 2>(acc);
#endif
}

// wgmma: oacc += A[64 x kw] B^T, B the 192 rows of the quarter's slot; waits
__device__ __forceinline__ void wg_down(float (&oacc)[OUT_ACC], const bf16* A,
                                        int kw, const bf16* B) {
#ifndef CMVE_BLK_NO_MMA
  const uint64_t da = wgmma_desc_sw128(A, 16, 1024);
  const uint64_t db = wgmma_desc_sw128(B, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < BLK_MAX_HD / 16; ++k)
    if (16 * k < kw)
      wgmma_m64n192k16_ss<0>(oacc, wgmma_desc_advance(da, 32 * k),
                             wgmma_desc_advance(db, 32 * k), 1);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin<OUT_ACC>(oacc);
#endif
}

// f(row, col, v0, v1) for each pair (col, col + 1) of an up step's 64 x nB
// result that this thread holds (col < nB)
template <bool WG, typename F>
__device__ __forceinline__ void up_each(const float (&acc)[UP_ACC], int nB,
                                        int warp, int lane, F f) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (WG) {
    const int n = nB > 64 ? 32 : 16;    // the warpgroup's columns
    const int r0 = 16 * (warp & 3) + g, c0 = n * (warp >> 2) + 2 * t;
#pragma unroll
    for (int i = 0; i < UP_ACC / 4; ++i)
      if (8 * i < n && c0 + 8 * i < nB)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          f(r0 + 8 * half, c0 + 8 * i, acc[4 * i + 2 * half],
            acc[4 * i + 2 * half + 1]);
  } else {
    const int mh = warp >> 3, ng = warp & 7;
#pragma unroll
    for (int i = 0; i < UP_NT; ++i)
      if ((UP_NT * ng + i) * 8 < nB)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            f(32 * mh + 16 * mi + g + 8 * half, (UP_NT * ng + i) * 8 + 2 * t,
              acc[(mi * UP_NT + i) * 4 + 2 * half],
              acc[(mi * UP_NT + i) * 4 + 2 * half + 1]);
  }
}

// y[r][c] = round(round(oacc + bias[c]) + res[r][c]) for the rows of the
// block (r < nrows) and the columns this thread holds; oacc is zeroed.
// res: x (read-only) or y1 (this block's own writes to y, read back by the
// thread that wrote them).
template <bool WG>
__device__ __forceinline__ void residual_out(float (&oacc)[OUT_ACC],
                                             const bf16* __restrict__ bias,
                                             const bf16* res, bool ro,
                                             bf16* y, int row0, int nrows,
                                             int D, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto one = [&](int r, int c, float v0, float v1) {
    if (r < nrows && c < D) {
      const size_t off = (size_t)(row0 + r) * D + c;
      const uint32_t* rp = reinterpret_cast<const uint32_t*>(res + off);
      const uint32_t rv = ro ? __ldg(rp) : *rp;
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
      const float p0 = round_to<bf16>(v0 + to_f32(bias[c]));
      const float p1 = round_to<bf16>(v1 + to_f32(bias[c + 1]));
      st_u32(y + off, pack_bf16(p0 + x.x, p1 + x.y));
    }
  };
  if constexpr (WG) {
    const int r0 = 16 * (warp & 3) + g, c0 = QUARTER * (warp >> 2) + 2 * t;
#pragma unroll
    for (int i = 0; i < OUT_ACC / 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        one(r0 + 8 * half, c0 + 8 * i, oacc[4 * i + 2 * half],
            oacc[4 * i + 2 * half + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < OUT_NT; ++i)
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          one(16 * mi + g + 8 * half, (OUT_NT * warp + i) * 8 + 2 * t,
              oacc[(mi * OUT_NT + i) * 4 + 2 * half],
              oacc[(mi * OUT_NT + i) * 4 + 2 * half + 1]);
  }
#pragma unroll
  for (int j = 0; j < OUT_ACC; ++j) oacc[j] = 0.f;
}

// acc = LN-tile . (the nB rows of tiles t0 .. t0 + ks - 1)^T, the
// products of one up step; every warp waits for and releases every tile
template <bool WG>
__device__ __forceinline__ void up_step(float (&acc)[UP_ACC], const bf16* LN,
                                        const BlockParams& p,
                                        const WeightMaps& wm, const Ring& ring,
                                        int t0, int nB, int warp, int lane) {
  const int ks = p.sched.ks;
#pragma unroll
  for (int j = 0; j < UP_ACC; ++j) acc[j] = 0.f;
  BLK_MARK(1, -1);
  const int mh = warp >> 3, ng = warp & 7;
  const int cnt = min(max(nB / 8 - UP_NT * ng, 0), UP_NT);
  for (int s = 0; s < ks; ++s) {
    const bf16* B = tile_wait(ring, t0 + s);
    BLK_MARK(1, 11);
    if constexpr (WG) {
      if (nB > 64)
        wg_up_slab<32>(acc, LN + s * SUB, B, warp >> 2, s == 0);
      else
        wg_up_slab<16>(acc, LN + s * SUB, B, warp >> 2, s == 0);
    } else {
      mma_up_slab(acc, LN + s * SUB, B, cnt, mh, ng, lane);
    }
    BLK_MARK(1, 10);
    tile_release(p, wm, ring, t0 + s, lane);
    BLK_MARK(1, 12);
  }
}

// oacc += A_k[64 x kw] . (this warp's part of its quarter's tile)^T for
// k < nk, over the tiles t0 + k nq + j, one per output quarter j: each warp
// waits for and releases them all, and multiplies its quarter's
template <bool WG>
__device__ __forceinline__ void down_step(float (&oacc)[OUT_ACC],
                                          const bf16* A, int kw,
                                          const BlockParams& p,
                                          const WeightMaps& wm,
                                          const Ring& ring, int t0, int nk,
                                          int warp, int lane) {
  const int nq = p.sched.nq, quarter = warp >> 2;
  const int cnt = min(max(p.D / 8 - OUT_NT * warp, 0), OUT_NT);
  BLK_MARK(1, -1);
  for (int k = 0; k < nk; ++k)
    for (int j = 0; j < nq; ++j) {
      const int t = t0 + k * nq + j;
      const bf16* B = tile_wait(ring, t);
      BLK_MARK(1, 14);
      if (j == quarter) {
        if constexpr (WG)
          wg_down(oacc, A + k * SUB, kw, B);
        else
          mma_down(oacc, A + k * SUB, kw, B, cnt, warp & 3, lane);
      }
      BLK_MARK(1, 13);
      tile_release(p, wm, ring, t, lane);
      BLK_MARK(1, 15);
    }
}

template <bool WG>
__global__ void __launch_bounds__(BLK_THREADS, 1)
    block_kernel_bf16(const __grid_constant__ CUtensorMap map_wq,
                      const __grid_constant__ CUtensorMap map_wk,
                      const __grid_constant__ CUtensorMap map_wv,
                      const __grid_constant__ CUtensorMap map_wo,
                      const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2,
                      const BlockParams p) {
  extern __shared__ unsigned char blk_smem_raw[];
  const int D = p.D, hd = p.hd, L = p.seq_len;
  const Sched& S = p.sched;
  bf16* const LN = reinterpret_cast<bf16*>(align_1024(blk_smem_raw));
  bf16* const ST = LN + (D / 64) * SUB;   // staging: three sub-tiles
  bf16* const QS = ST;                    // q, then the attention output
  bf16* const KS = ST + SUB;              // k: [key][c]
  bf16* const VT = ST + 2 * SUB;          // v^T: [c][key]
  bf16* const HS = ST;                    // a hidden chunk: 128 columns
  float* const PK = reinterpret_cast<float*>(ST + 3 * SUB);  // parked sums
  Ring ring;
  ring.slots = ST + 3 * SUB + PARK * BLK_THREADS * 2;
  ring.full = reinterpret_cast<uint64_t*>(ring.slots + NSLOT * SLOT);
  ring.done = reinterpret_cast<int*>(ring.full + NSLOT);
  const WeightMaps wm{{&map_wq, &map_wk, &map_wv, &map_wo, &map_w1, &map_w2}};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int nrows = min(p.rows_per_block, p.n - row0);
  const bf16* x = static_cast<const bf16*>(p.x);
  bf16* y = static_cast<bf16*>(p.y);
  const bf16* b1 = static_cast<const bf16*>(p.b1);

#ifdef CMVE_BLK_PROFILE
  if (tid == 0)
    for (int i = 0; i < 18; ++i) blk_prof[i] = 0;
#endif
  if (tid == 0) {
    for (int i = 0; i < NSLOT; ++i) {
      mbar_init(&ring.full[i], 1);
      ring.done[i] = 0;
    }
    mbar_init_fence();
    for (int t = 0; t < min(NSLOT, S.total); ++t) load_tile(p, wm, ring, t);
  }
  BLK_MARK(0, -1);
  // LN1(x) while the first tiles arrive
  ln_tile(x, true, row0, nrows, D, static_cast<const bf16*>(p.ln1s),
          static_cast<const bf16*>(p.ln1b), p.eps, LN, warp, lane);
  fence_proxy_async();
  __syncthreads();
  BLK_MARK(0, 0);  // x and LN1(x)

  float oacc[OUT_ACC];
#pragma unroll
  for (int j = 0; j < OUT_ACC; ++j) oacc[j] = 0.f;

  // q | k | v column C of a head, plus its bias, into the staging area
  auto store_qkv = [&](int h, int r, int C, float v0, float v1) {
    const int m = C / hd, c = C - m * hd;
    const bf16* bm = static_cast<const bf16*>(m == 0 ? p.bq : m == 1 ? p.bk
                                                                     : p.bv) +
                     h * hd + c;
    v0 += to_f32(bm[0]);
    v1 += to_f32(bm[1]);
    const bool live = r < nrows;  // pad rows of k and v: zeros
    if (m == 0) {
      st_u32(QS + swz(r, c), pack_bf16(v0, v1));
    } else if (m == 1) {
      st_u32(KS + swz(r, c), live ? pack_bf16(v0, v1) : 0u);
    } else {
      // a key of another sequence has P = 0, and 0 x inf is NaN: a value
      // that is not finite is stored as 0 (its own sequence's scores are
      // NaN then, as in the plain version)
      VT[swz(c, r)] = from_f32<bf16>(live && isfinite(v0) ? v0 : 0.f);
      VT[swz(c + 1, r)] = from_f32<bf16>(live && isfinite(v1) ? v1 : 0.f);
    }
  };

  int t = 0;  // the schedule's next tile
  // -- attention half, head by head -----------------------------------------
  for (int h = 0; h < p.heads; ++h) {
    park(oacc, PK, tid);
    {
      float acc[UP_ACC];
      up_step<WG>(acc, LN, p, wm, ring, t, 2 * hd, warp, lane);  // q | k
      t += S.ks;
      BLK_MARK(0, 1);  // q | k | v products
      __syncthreads();  // the staging area is free (last head's down step)
      up_each<WG>(acc, 2 * hd, warp, lane,
                  [&](int r, int C, float v0, float v1) {
                    store_qkv(h, r, C, v0, v1);
                  });
      BLK_MARK(0, 2);  // their epilogue
      up_step<WG>(acc, LN, p, wm, ring, t, hd, warp, lane);  // v
      t += S.ks;
      BLK_MARK(0, 1);
      up_each<WG>(acc, hd, warp, lane, [&](int r, int C, float v0, float v1) {
        store_qkv(h, r, 2 * hd + C, v0, v1);
      });
    }
    __syncthreads();
    BLK_MARK(0, 2);
    if (warp < BLK_ROWS / 16)
      attend_rows(QS, KS, VT, warp, hd, L, nrows, p.causal, p.scale, lane);
    fence_proxy_async();
    __syncthreads();
    BLK_MARK(0, 3);  // softmax(q k^T) v
    unpark(oacc, PK, tid);
    down_step<WG>(oacc, QS, hd, p, wm, ring, t, 1, warp, lane);
    t += S.nq;
    BLK_MARK(0, 4);  // output projection
  }
  // y1 = x + (att W_o^T + b_o), into y
  residual_out<WG>(oacc, static_cast<const bf16*>(p.bo), x, true, y, row0,
                   nrows, D, warp, lane);
  __syncthreads();

  // -- MLP half, a chunk of hidden columns at a time -------------------------
  ln_tile(y, false, row0, nrows, D, static_cast<const bf16*>(p.ln2s),
          static_cast<const bf16*>(p.ln2b), p.eps, LN, warp, lane);
  fence_proxy_async();
  __syncthreads();
  BLK_MARK(0, 5);  // y1 and LN2(y1)
  for (int h0 = 0; h0 < p.hidden; h0 += UPW) {
    const int cw = min(UPW, p.hidden - h0);
    park(oacc, PK, tid);
    {
      float acc[UP_ACC];
      up_step<WG>(acc, LN, p, wm, ring, t, cw, warp, lane);
      t += S.ks;
      BLK_MARK(0, 6);  // hidden chunk products
      __syncthreads();  // the staging area is free (last chunk's down step)
      up_each<WG>(acc, cw, warp, lane, [&](int r, int c, float v0, float v1) {
        v0 += to_f32(b1[h0 + c]);
        v1 += to_f32(b1[h0 + c + 1]);
        v0 = v0 * (1.0f / (1.0f + expf(-1.702f * v0)));
        v1 = v1 * (1.0f / (1.0f + expf(-1.702f * v1)));
        st_u32(HS + (c >> 6) * SUB + swz(r, c & 63), pack_bf16(v0, v1));
      });
    }
    fence_proxy_async();
    __syncthreads();
    BLK_MARK(0, 7);  // gelu epilogue
    unpark(oacc, PK, tid);
    down_step<WG>(oacc, HS, 64, p, wm, ring, t, cw / 64, warp, lane);
    t += (cw / 64) * S.nq;
    BLK_MARK(0, 8);  // second MLP product
  }
  // y = y1 + (hidden W2^T + b2), over y1 in y
  residual_out<WG>(oacc, static_cast<const bf16*>(p.b2), y, false, y, row0,
                   nrows, D, warp, lane);
  BLK_MARK(0, 9);  // y
#ifdef CMVE_BLK_PROFILE
  if (tid == 0 && blockIdx.x == 0 && p.scratch != nullptr)
    for (int i = 0; i < 16; ++i) p.scratch[i] = (float)blk_prof[i];
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

// The bf16 route (ops/attention_sublayer.block_path): wgmma where every
// output quarter is whole and a head's q | k | v is one 192-row slot, else
// mma.sync.  -DCMVE_BLK_NO_WGMMA keeps mma.sync everywhere (to time the two
// in one build's call).
static bool block_route_wgmma(int D, int hd) {
#ifdef CMVE_BLK_NO_WGMMA
  return false;
#else
  return D % QUARTER == 0 && hd == 64;
#endif
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
    const int hd = p.hd;
    Sched& S = p.sched;
    S.ks = D / 64;
    S.nq = (D + QUARTER - 1) / QUARTER;
    S.per_head = 2 * S.ks + S.nq;
    S.attn_tiles = heads * S.per_head;
    S.per_chunk = S.ks + (UPW / 64) * S.nq;
    S.total = S.attn_tiles;
    for (int h0 = 0; h0 < hidden; h0 += UPW)
      S.total += S.ks + (min(UPW, hidden - h0) / 64) * S.nq;
    S.o_rows = min(QUARTER, D);
    S.w1_rows = min(UPW, hidden);
    // the weights' maps, kept by (address, shape, box) across calls
    CUtensorMap maps[6];
    const cuuint64_t dd[2] = {(cuuint64_t)D, (cuuint64_t)D};
    const cuuint64_t d1[2] = {(cuuint64_t)D, (cuuint64_t)hidden};
    const cuuint64_t d2[2] = {(cuuint64_t)hidden, (cuuint64_t)D};
    const cuuint32_t box_h[2] = {64, (cuuint32_t)hd};
    const cuuint32_t box_o[2] = {64, (cuuint32_t)S.o_rows};
    const cuuint32_t box_1[2] = {64, (cuuint32_t)S.w1_rows};
    const void* wqkv[3] = {wq, wk, wv};
    for (int i = 0; i < 3; ++i)
      if (int err = cached_tensor_map_2d(&maps[i], wqkv[i], dd, 2ull * D,
                                         box_h))
        return err;
    if (int err = cached_tensor_map_2d(&maps[3], wo, dd, 2ull * D, box_o))
      return err;
    if (int err = cached_tensor_map_2d(&maps[4], w1, d1, 2ull * D, box_1))
      return err;
    if (int err = cached_tensor_map_2d(&maps[5], w2, d2, 2ull * hidden,
                                       box_o))
      return err;
    // LayerNorm tile, staging, ring, barriers, counts; 1024 for alignment
    const int smem = 1024 + ((D / 64) * SUB + 3 * SUB + NSLOT * SLOT) *
                                (int)sizeof(bf16) +
                     PARK * BLK_THREADS * (int)sizeof(float) +
                     NSLOT * (int)(sizeof(uint64_t) + sizeof(int));
    auto kernel = block_route_wgmma(D, hd) ? block_kernel_bf16<true>
                                           : block_kernel_bf16<false>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    kernel<<<grid, BLK_THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3],
                                           maps[4], maps[5], p);
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

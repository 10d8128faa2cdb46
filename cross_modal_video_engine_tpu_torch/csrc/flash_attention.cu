// Flash attention forward: softmax(q k^T * sm_scale) v over (B, H, S, D)
// without the (Sq, Skv) score matrix ever reaching device memory.
//
// Replaces cross_modal_video_engine_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_attention_impl, pallas_call at line 151).  What it
// computes, kept element for element:
//   s = (q . k in fp32) * sm_scale; masked scores get s + MASK_VALUE with
//   MASK_VALUE = -0.7 * FLT_MAX (finite, so exp gives exactly 0 and no
//   inf - inf appears); the mask is col < Skv and, when causal, col <= row,
//   aligned at the top left when Sq != Skv; running max m and sum l in
//   fp32, alpha = exp(m_prev - m_next); P = exp(s - m_next) rounded to
//   v.dtype UNNORMALISED before P v, while l sums the fp32 P; the output is
//   acc * (l == 0 ? 1 : 1 / l), rounded once to the output dtype.
// What it does not copy is the TPU blocking (blocks of >= 128 rows, D
// padded to 128 lanes, scratch carried across a sequential grid axis):
// one block owns one (query tile, batch * head) and loops over the key
// tiles itself, skipping, under causal masking, every tile that lies
// wholly above the diagonal, as the TPU kernel skips its grid steps.  A
// skipped tile would add exp(MASK) = 0 and leave m unchanged, so skipping
// is exact, and the key tile size does not change what is computed, only
// the order of the fp32 sums and where m stands when P is rounded.
//
// Inputs are strided (B, H, S, D) views with a unit stride on D (the
// transposed q/k/v of MHA need no copy); the output is written through its
// own strides, so MHA's head merge is a view too.  Head dims: multiples of
// 16 up to 128.
//
// Which path serves what:
//  * bf16, head dim 64 or 128 (TimeSformer, CLIP's MHA(use_flash), the bench
//    sweep): flash_fwd_wgmma, the design for this card, below.
//  * bf16, the other head dims (16, 32, 48, 80, 96, 112): flash_fwd_mma,
//    four warps of 16 query rows on mma.sync m16n8k16, K/V tiles (64 keys,
//    32 above head dim 64) double-buffered by cp.async, read by ldmatrix.
//  * f32, every head dim: CUDA-core FMA; four warps of 8 query rows each, a
//    lane per key for the scores and a lane per channel for P v, on 32-key
//    tiles in shared memory.  It serves f32 models (TimeSformerConfig's
//    default dtype) and holds the algorithm apart from rounding on the card.
// The routing is by dtype and head dim alone, decided before the launch;
// no path stands in for another that failed.
//
// What bounds it on the H100: at S = 1569 and head dim 64 one (b, h) does
// about 630 MFLOP on about 0.6 MB of q/k/v, so attention is tensor-core
// bound; the plain version instead writes and reads the fp32 scores and
// probabilities, about 1.9 GB per layer at 16 videos of 12 heads.  With
// scores and P in registers the limits are the rate of the products,
// the exp of every score on the special-function units, and whatever of
// the softmax arithmetic is not hidden under a product.  exp is __expf
// (one multiply and one ex2.approx, a relative error near 2^-21).
//
// flash_fwd_wgmma (the FlashAttention-3 shape): one persistent block of
// three warpgroups an SM walks over the (batch, head, 128 queries) items.
// One thread of the producer warpgroup loads Q and K/V tiles of 128 keys
// into a ring of stages by TMA, each on its mbarrier, running ahead into
// the next item while this one finishes; q, k and v are read in place as
// 4-D tensor maps (D, H, S, B) of the strided views, 64 channels (one
// 128-byte swizzle row) a box, and rows past the sequence arrive as zeros.
// Each consumer warpgroup owns 64 query rows: S = Q K^T is wgmma with both
// operands from shared memory; the online softmax runs on the accumulators
// in registers, in base 2 with sm_scale folded into the exponent's
// multiply-add; P, packed to bf16 from them, is the register operand of
// O += P V, with V read as it lies (keys by channels) through wgmma's
// transpose bit.  A warpgroup starts the next tile's Q K^T before this
// tile's P V and does the next softmax while P V runs; the other
// warpgroup's products fill the tensor cores meanwhile.  K/V are read once
// per 128 queries.  The `col < Skv` and causal masks stay on the scores: a
// zero-filled key scores 0, which is not "masked".  At head dim 64 the
// softmax's arithmetic and the exp unit, not the tensor cores, set the
// rate.

#include <type_traits>

#include "common.cuh"

namespace cmve {
namespace flash {

// DEFAULT_MASK_VALUE of the JAX kernel: a float64 product rounded to fp32
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e+38);
constexpr int THREADS = 128;  // four warps

struct Strides {
  long long b, h, s;  // in elements; the head-dim stride is 1
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int H, Sq, Skv, n_qt, causal;
  int items;  // (batch, head, query tile) triples: the wgmma path's work list
  float scale;
};

// the key tiles a query tile [q0, q0 + bq) needs: under causal masking,
// none whose first key lies past the tile's last row
__device__ __forceinline__ int kv_tiles(const Args& a, int q0, int bq,
                                        int bk) {
  const int n = (a.Skv + bk - 1) / bk;
  return a.causal ? min(n, (q0 + bq - 1) / bk + 1) : n;
}

// -- bf16, head dims 64 and 128: wgmma, TMA ring, warp-specialised -------------

namespace hopper {

using bf16 = __nv_bfloat16;
constexpr int BKV = 128;           // keys per tile

constexpr int NWG = 2;             // consumer warpgroups
constexpr int BQ = 64 * NWG;       // queries a block
constexpr int WG_THREADS = 128 * (NWG + 1);  // and the producer warpgroup

template <int HD> struct Cfg {
  static constexpr int NH = HD / 64;  // 64-channel halves, one swizzle row each
  static constexpr int Q_BYTES = BQ * HD * 2;    // [NH][BQ][64]
  static constexpr int KV_BYTES = BKV * HD * 2;  // a K or a V tile: [NH][BKV][64]
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  // Q, the ring of K and V tiles, and room to align to 1024 bytes
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

// Work item -> (first query row, batch * head).  Blocks take items round
// robin.  Without a causal mask all items cost the same, and the query tiles
// of one (batch, head) are neighbours, so the blocks running together share
// its K and V in L2.  Under the causal mask a later query tile needs more key
// tiles: the longest items come first, so that every block gets a like mix.
__device__ __forceinline__ void decode_item(const Args& a, int item, int& q0,
                                            int& bh) {
  if (a.causal) {
    const int n_bh = a.items / a.n_qt;
    q0 = (a.n_qt - 1 - item / n_bh) * BQ;
    bh = item % n_bh;
  } else {
    q0 = (item % a.n_qt) * BQ;
    bh = item / a.n_qt;
  }
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, Args a) {
  using C = Cfg<HD>;
  constexpr int STAGES = C::STAGES;
  constexpr int HALF_Q = BQ * 128, HALF_KV = BKV * 128;  // bytes of a half
  static_assert(HD == 64 || HD == 128, "head dims of the wgmma path");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const qs = align_1024(smem_raw);
  unsigned char* const ring = qs + C::Q_BYTES;
  __shared__ uint64_t full_q, empty_q, full_k[STAGES], full_v[STAGES],
      empty[STAGES];

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full_q, 1);
    mbar_init(&empty_q, NWG);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);  // the producer's expect_tx arrival
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], NWG);  // one thread of each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int stage = 0, phase = 0, item_phase = 0;
      // the block's items, one after another through the same ring: the
      // next item's Q and first K/V tiles load under this item's last steps
      for (int item = blockIdx.x; item < a.items;
           item += gridDim.x, item_phase ^= 1) {
        int q0, bh;
        decode_item(a, item, q0, bh);
        const int b = bh / a.H, h = bh % a.H;
        const int n_kt = kv_tiles(a, q0, BQ, BKV);
        mbar_wait(&empty_q, item_phase ^ 1);
        mbar_expect_tx(&full_q, C::Q_BYTES);
#pragma unroll
        for (int hf = 0; hf < C::NH; ++hf)
          tma_load_4d(qs + hf * HALF_Q, &map_q, &full_q, hf * 64, h, q0, b);
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* const ks = ring + stage * 2 * C::KV_BYTES;
          mbar_expect_tx(&full_k[stage], C::KV_BYTES);
#pragma unroll
          for (int hf = 0; hf < C::NH; ++hf)
            tma_load_4d(ks + hf * HALF_KV, &map_k, &full_k[stage], hf * 64, h,
                        kt * BKV, b);
          mbar_expect_tx(&full_v[stage], C::KV_BYTES);
#pragma unroll
          for (int hf = 0; hf < C::NH; ++hf)
            tma_load_4d(ks + C::KV_BYTES + hf * HALF_KV, &map_v, &full_v[stage],
                        hf * 64, h, kt * BKV, b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 ----
    setmaxnreg_inc<232>();
    const int cw = tid / 128 - 1, t128 = tid % 128;
    const int warp = t128 >> 5, lane = t128 & 31, g = lane >> 2, t = lane & 3;
    int qw;      // the warpgroup's first row in the item at hand
    int ra, rb;  // this thread's two rows

    float s[BKV / 2];      // S, then the unnormalised fp32 P, 64 x 128
    uint32_t pf[BKV / 4];  // P rounded to bf16: the A fragments of P V
    float o[HD / 2];       // O, 64 x HD
    float ma, mb;          // running max of rows ra, rb
    float la, lb;          // this lane's share of the sums

    // the descriptors of this warpgroup's Q rows and of stage 0's K and V
    const uint64_t dq0 = wgmma_desc_sw128(qs + cw * 64 * 128, 16, 1024);
    const uint64_t dk0 = wgmma_desc_sw128(ring, 16, 1024);
    const uint64_t dv0 = wgmma_desc_sw128(ring + C::KV_BYTES, HALF_KV, 1024);
    // S = Q K^T of the tile in `stage`, one group
    auto start_s = [&](int stage) {
      const uint64_t dk = wgmma_desc_advance(dk0, stage * 2 * C::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int hf = kk / 4, in = 32 * (kk % 4);
        wgmma_m64n128k16_ss<0>(s, wgmma_desc_advance(dq0, hf * HALF_Q + in),
                               wgmma_desc_advance(dk, hf * HALF_KV + in),
                               kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of the tile in `stage`, one group: V lies keys by channels,
    // the MN-major operand; 16 keys a step, the halves HALF_KV apart
    auto start_pv = [&](int stage) {
      const uint64_t dvs = wgmma_desc_advance(dv0, stage * 2 * C::KV_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t dv = wgmma_desc_advance(dvs, kk * 2048);
        if constexpr (HD == 64)
          wgmma_m64n64k16_rs<1>(o, pf + 4 * kk, dv, 1);
        else
          wgmma_m64n128k16_rs<1>(o, pf + 4 * kk, dv, 1);
      }
      wgmma_commit();
    };
    // the online softmax of a key tile on s, in place; returns the factors
    // that rescale O for rows ra and rb.  The running max and the exponent
    // are kept in the base-2 domain, m = max(s) * (sm_scale * log2 e), so
    // that an unmasked tile costs a max, one fused multiply-add, one ex2 and
    // an add per score; sm_scale >= 0 (the launch refuses another), so the
    // max of the scaled scores is the scaled max.  A masked tile scales
    // first and adds MASK_VALUE to the scaled score, as the TPU kernel does.
    const float scale2 = a.scale * 1.4426950408889634f;
    auto softmax_tile = [&](auto masked, int k0, float& alpha_a,
                            float& alpha_b) {
      constexpr bool MASKED = decltype(masked)::value;
      // four chains a row for the max and for the sum: one warp has no
      // other work to hide a chain of 32 dependent operations under
      float mxa[4], mxb[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) mxa[c] = mxb[c] = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * (nt & 1) + e;
          float sa = s[4 * nt + e], sb = s[4 * nt + 2 + e];
          if constexpr (MASKED) {
            const int col = k0 + nt * 8 + 2 * t + e;
            const bool kv_ok = col < a.Skv;
            sa *= scale2;
            sb *= scale2;
            if (!(kv_ok && (!a.causal || col <= ra))) sa += MASK_VALUE;
            if (!(kv_ok && (!a.causal || col <= rb))) sb += MASK_VALUE;
            s[4 * nt + e] = sa;
            s[4 * nt + 2 + e] = sb;
          }
          mxa[c] = fmaxf(mxa[c], sa);
          mxb[c] = fmaxf(mxb[c], sb);
        }
      float mca = fmaxf(fmaxf(mxa[0], mxa[1]), fmaxf(mxa[2], mxa[3]));
      float mcb = fmaxf(fmaxf(mxb[0], mxb[1]), fmaxf(mxb[2], mxb[3]));
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {  // the 4 lanes of a group share rows
        mca = fmaxf(mca, __shfl_xor_sync(0xffffffffu, mca, x));
        mcb = fmaxf(mcb, __shfl_xor_sync(0xffffffffu, mcb, x));
      }
      if constexpr (!MASKED) {
        mca *= scale2;
        mcb *= scale2;
      }
      const float mna = fmaxf(ma, mca), mnb = fmaxf(mb, mcb);
      alpha_a = ex2_approx(ma - mna);
      alpha_b = ex2_approx(mb - mnb);
      ma = mna;
      mb = mnb;
      float sma[4] = {0.f, 0.f, 0.f, 0.f}, smb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * (nt & 1) + e;
          float& pa = s[4 * nt + e];
          float& pb = s[4 * nt + 2 + e];
          pa = ex2_approx(MASKED ? pa - mna : fmaf(pa, scale2, -mna));
          pb = ex2_approx(MASKED ? pb - mnb : fmaf(pb, scale2, -mnb));
          sma[c] += pa;
          smb[c] += pb;
        }
      la = alpha_a * la + ((sma[0] + sma[1]) + (sma[2] + sma[3]));
      lb = alpha_b * lb + ((smb[0] + smb[1]) + (smb[2] + smb[3]));
      wgmma_pin<BKV / 2>(s);  // all of it before the wait that follows
    };
    // scale, then the mask as the TPU kernel adds it; the tile needs no mask
    // when all its keys are valid and (causal) none lies past the
    // warpgroup's first row
    auto softmax = [&](int kt, float& alpha_a, float& alpha_b) {
      const int k0 = kt * BKV;
      if (k0 + BKV <= a.Skv && (!a.causal || k0 + BKV - 1 <= qw))
        softmax_tile(std::false_type(), k0, alpha_a, alpha_b);
      else
        softmax_tile(std::true_type(), k0, alpha_a, alpha_b);
    };
    // rescale O, then round the fp32 P, unnormalised, to bf16: the S
    // fragments of keys 16 kk .. +15 are the A fragment of step kk
    auto rescale_and_pack = [&](float alpha_a, float alpha_b) {
#pragma unroll
      for (int ct = 0; ct < HD / 8; ++ct) {
        o[4 * ct] *= alpha_a;
        o[4 * ct + 1] *= alpha_a;
        o[4 * ct + 2] *= alpha_b;
        o[4 * ct + 3] *= alpha_b;
      }
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i)
        pf[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };

    int stage = 0, phase = 0, item_phase = 0;
    for (int item = blockIdx.x; item < a.items;
         item += gridDim.x, item_phase ^= 1) {
      int q0, bh;
      decode_item(a, item, q0, bh);
      const int b = bh / a.H, h = bh % a.H;
      const int n_kt = kv_tiles(a, q0, BQ, BKV);
      qw = q0 + cw * 64;
      ra = qw + warp * 16 + g;
      rb = ra + 8;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      ma = mb = -INFINITY;
      la = lb = 0.f;

      // the item's first key tile sits in `stage`
      float alpha_a, alpha_b;
      mbar_wait(&full_q, item_phase);
      mbar_wait(&full_k[stage], phase);
      start_s(stage);
      wgmma_wait<0>();
      wgmma_pin<BKV / 2>(s);
      softmax(0, alpha_a, alpha_b);
      rescale_and_pack(alpha_a, alpha_b);
      for (int kt = 1; kt < n_kt; ++kt) {
        // tile kt - 1 sits in `stage`, tile kt in the next
        const int prev = stage, prev_phase = phase;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        mbar_wait(&full_k[stage], phase);
        start_s(stage);
        mbar_wait(&full_v[prev], prev_phase);
        start_pv(prev);
        wgmma_wait<1>();  // S of tile kt is there; P V of tile kt - 1 runs
        wgmma_pin<BKV / 2>(s);
        softmax(kt, alpha_a, alpha_b);
        wgmma_wait<0>();
        wgmma_pin<HD / 2>(o);
        if (t128 == 0) mbar_arrive(&empty[prev]);
        rescale_and_pack(alpha_a, alpha_b);
      }
      // every product that reads Q is done: the next item's Q may land
      if (t128 == 0) mbar_arrive(&empty_q);
      mbar_wait(&full_v[stage], phase);
      start_pv(stage);
      wgmma_wait<0>();
      wgmma_pin<HD / 2>(o);
      if (t128 == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }

#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        la += __shfl_xor_sync(0xffffffffu, la, x);
        lb += __shfl_xor_sync(0xffffffffu, lb, x);
      }
      const float ia = la == 0.f ? 1.f : 1.f / la;
      const float ib = lb == 0.f ? 1.f : 1.f / lb;
      bf16* op = static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
      for (int ct = 0; ct < HD / 8; ++ct) {
        const int c = ct * 8 + 2 * t;
        if (ra < a.Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + ra * a.so.s + c) =
              __floats2bfloat162_rn(o[4 * ct] * ia, o[4 * ct + 1] * ia);
        if (rb < a.Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + rb * a.so.s + c) =
              __floats2bfloat162_rn(o[4 * ct + 2] * ib, o[4 * ct + 3] * ib);
      }
    }
  }
}

// q, k or v, a strided (B, H, S, D) view with a unit stride on D, as the
// 4-D map (D, H, S, B) with boxes of 64 channels x `rows` sequence positions
static int make_map(CUtensorMap* map, const void* base, const Strides& st,
                    int B, int H, int S, int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return make_tensor_map_bf16(map, base, 4, dims, strides, box);
}

template <int HD>
static int launch(Args a, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  if (!(a.scale >= 0.f)) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (int err = make_map(&mq, a.q, a.sq, B, a.H, a.Sq, HD, BQ)) return err;
  if (int err = make_map(&mk, a.k, a.sk, B, a.H, a.Skv, HD, BKV)) return err;
  if (int err = make_map(&mv, a.v, a.sv, B, a.H, a.Skv, HD, BKV)) return err;
  a.n_qt = (a.Sq + BQ - 1) / BQ;
  const long long items = (long long)B * a.H * a.n_qt;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.items = (int)items;
  int dev = 0, sms = 0;  // one persistent block an SM
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms <= 0)
    return (int)cudaErrorInvalidDevice;
  cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  flash_fwd_wgmma<HD><<<a.items < sms ? a.items : sms, WG_THREADS, C::SMEM,
                        stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

}  // namespace hopper

// -- bf16, the other head dims: mma.sync ----------------------------------------

// four blocks per SM up to head dim 64 (at most 128 registers a thread)
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 4 : 2)
    flash_fwd_mma(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = 64;                    // 4 warps x 16 rows
  constexpr int BK = HD <= 64 ? 64 : 32;    // keys per tile
  constexpr int STR = HD + 8;               // 16-byte rows, banks spread
  constexpr int KS = HD / 16;               // k-steps of q k^T
  constexpr int NT = BK / 8;                // 8-key tiles of S
  constexpr int CT = HD / 8;                // 8-channel tiles of O
  constexpr int VPR = HD / 8;               // 16-byte pieces per row
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  __shared__ __align__(16) bf16 Ks[2][BK][STR];
  __shared__ __align__(16) bf16 Vs[2][BK][STR];

  const int qt = blockIdx.x % a.n_qt, bh = blockIdx.x / a.n_qt;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * BQ;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  bf16* op = static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h;

  const int n_kt = kv_tiles(a, q0, BQ, BK);
  auto load_kv = [&](int kt, int buf) {
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int j = i / VPR, c = (i % VPR) * 8, key = kt * BK + j;
      const bool ok = key < a.Skv;
      cp_async16(&Ks[buf][j][c], ok ? kp + key * a.sk.s + c : kp, ok);
      cp_async16(&Vs[buf][j][c], ok ? vp + key * a.sv.s + c : vp, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // this lane's two rows; the q fragments stay in registers (zero past Sq)
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;
    const bf16* pa = qp + ra * a.sq.s + c;
    const bf16* pb = qp + rb * a.sq.s + c;
    qf[ks][0] = ra < a.Sq ? ld_u32(pa) : 0u;
    qf[ks][1] = rb < a.Sq ? ld_u32(pb) : 0u;
    qf[ks][2] = ra < a.Sq ? ld_u32(pa + 8) : 0u;
    qf[ks][3] = rb < a.Sq ? ld_u32(pb + 8) : 0u;
  }

  float acc[CT][4];
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ct][e] = 0.f;
  float ma = -INFINITY, mb = -INFINITY;  // running max of rows ra, rb
  float la = 0.f, lb = 0.f;              // this lane's share of the sums

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) load_kv(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // keys np*16 .. +15 as two n-tiles, channels ks*16 .. +15
        uint32_t r[4];
        ldmatrix_x4(r, &Ks[buf][np * 16 + (lane & 7) + ((lane >> 4) << 3)]
                          [ks * 16 + ((lane >> 3) & 1) * 8]);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16_16816(s[2 * np], qf[ks], b0);
        mma_bf16_16816(s[2 * np + 1], qf[ks], b1);
      }

    // scale, then the mask as the TPU kernel adds it; the tile needs no
    // mask when all its keys are valid and (causal) none lies past the
    // block's first row
    const int k0 = kt * BK;
    const bool full = k0 + BK <= a.Skv && (!a.causal || k0 + BK - 1 <= q0);
    float mca = -INFINITY, mcb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sa = s[nt][e] * a.scale, sb = s[nt][2 + e] * a.scale;
        if (!full) {
          const int col = k0 + nt * 8 + 2 * t + e;
          const bool kv_ok = col < a.Skv;
          if (!(kv_ok && (!a.causal || col <= ra))) sa += MASK_VALUE;
          if (!(kv_ok && (!a.causal || col <= rb))) sb += MASK_VALUE;
        }
        s[nt][e] = sa;
        s[nt][2 + e] = sb;
        mca = fmaxf(mca, sa);
        mcb = fmaxf(mcb, sb);
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the 4 lanes of a group share rows
      mca = fmaxf(mca, __shfl_xor_sync(0xffffffffu, mca, o));
      mcb = fmaxf(mcb, __shfl_xor_sync(0xffffffffu, mcb, o));
    }
    const float mna = fmaxf(ma, mca), mnb = fmaxf(mb, mcb);
    const float alpha_a = __expf(ma - mna), alpha_b = __expf(mb - mnb);
    ma = mna;
    mb = mnb;
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = __expf(s[nt][e] - mna);
        s[nt][2 + e] = __expf(s[nt][2 + e] - mnb);
        suma += s[nt][e];
        sumb += s[nt][2 + e];
      }
    la = alpha_a * la + suma;
    lb = alpha_b * lb + sumb;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      acc[ct][0] *= alpha_a;
      acc[ct][1] *= alpha_a;
      acc[ct][2] *= alpha_b;
      acc[ct][3] *= alpha_b;
    }

    // O += P v: the S fragments of keys 16 kk .. +15, rounded to bf16
    // unnormalised, are the A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int cp = 0; cp < CT / 2; ++cp) {
        // keys kk*16 .. +15, channels cp*16 .. +15 as two n-tiles
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Vs[buf][kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8]
                                     [cp * 16 + (lane >> 4) * 8]);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16_16816(acc[2 * cp], pf, b0);
        mma_bf16_16816(acc[2 * cp + 1], pf, b1);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, o);
    lb += __shfl_xor_sync(0xffffffffu, lb, o);
  }
  const float ia = la == 0.f ? 1.f : 1.f / la;
  const float ib = lb == 0.f ? 1.f : 1.f / lb;
#pragma unroll
  for (int ct = 0; ct < CT; ++ct) {
    const int c = ct * 8 + 2 * t;
    if (ra < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + ra * a.so.s + c) =
          __floats2bfloat162_rn(acc[ct][0] * ia, acc[ct][1] * ia);
    if (rb < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + rb * a.so.s + c) =
          __floats2bfloat162_rn(acc[ct][2] * ib, acc[ct][3] * ib);
  }
}

// -- float32, CUDA cores -------------------------------------------------------

constexpr int F32_R = 8;                  // query rows per warp
constexpr int F32_BQ = 4 * F32_R;         // 32 rows per block
constexpr int F32_BK = 32;                // one key per lane

template <int HD>
constexpr int f32_smem_bytes() {
  // q tile and K tile (rows padded to HD + 4), V tile, P rows per warp
  return (int)sizeof(float) *
         (F32_BQ * (HD + 4) + F32_BK * (HD + 4) + F32_BK * HD +
          F32_BQ * F32_BK);
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32(Args a) {
  constexpr int QSTR = HD + 4;            // float4 rows, conflict-free
  constexpr int NC = (HD + 31) / 32;      // channels per lane in P v
  constexpr int VPR = HD / 4;             // float4 pieces per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // F32_BQ x QSTR
  float* Ks = Qs + F32_BQ * QSTR;         // F32_BK x QSTR
  float* Vs = Ks + F32_BK * QSTR;         // F32_BK x HD
  float* Ps = Vs + F32_BK * HD;           // F32_BQ x F32_BK

  const int qt = blockIdx.x % a.n_qt, bh = blockIdx.x / a.n_qt;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * F32_BQ;
  const float* qp = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kp = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  float* op = static_cast<float*>(a.o) + b * a.so.b + h * a.so.h;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < F32_BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    *reinterpret_cast<float4*>(Qs + r * QSTR + c) =
        q0 + r < a.Sq
            ? *reinterpret_cast<const float4*>(qp + (q0 + r) * a.sq.s + c)
            : zero4;
  }

  const int rw = warp * F32_R;            // this warp's rows in the tile
  float m[F32_R], l[F32_R], acc[F32_R][NC];
#pragma unroll
  for (int r = 0; r < F32_R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;  // this lane's share: the P of its keys
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }

  const int n_kt = kv_tiles(a, q0, F32_BQ, F32_BK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * F32_BK;
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int i = tid; i < F32_BK * VPR; i += THREADS) {
      const int j = i / VPR, c = (i % VPR) * 4;
      const bool ok = k0 + j < a.Skv;
      *reinterpret_cast<float4*>(Ks + j * QSTR + c) =
          ok ? *reinterpret_cast<const float4*>(kp + (k0 + j) * a.sk.s + c)
             : zero4;
      *reinterpret_cast<float4*>(Vs + j * HD + c) =
          ok ? *reinterpret_cast<const float4*>(vp + (k0 + j) * a.sv.s + c)
             : zero4;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[F32_R];
#pragma unroll
    for (int r = 0; r < F32_R; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(Ks + lane * QSTR + c);
#pragma unroll
      for (int r = 0; r < F32_R; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (rw + r) * QSTR + c);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }
    const int col = k0 + lane;
    float* prow = Ps + rw * F32_BK;
#pragma unroll
    for (int r = 0; r < F32_R; ++r) {
      const int row = q0 + rw + r;
      float sr = s[r] * a.scale;
      if (!(col < a.Skv && (!a.causal || col <= row))) sr += MASK_VALUE;
      const float mn = fmaxf(m[r], warp_max(sr));
      const float alpha = __expf(m[r] - mn);
      m[r] = mn;
      const float p = __expf(sr - mn);
      l[r] = alpha * l[r] + p;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= alpha;
      prow[r * F32_BK + lane] = p;
    }
    __syncwarp();

    // O += P v: lane owns channels lane + 32 i
#pragma unroll 4
    for (int j = 0; j < F32_BK; j += 4) {
      float vv[NC][4];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vv[i][e] = c < HD ? Vs[(j + e) * HD + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < F32_R; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(prow + r * F32_BK + j);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          acc[r][i] = fmaf(pp.x, vv[i][0], acc[r][i]);
          acc[r][i] = fmaf(pp.y, vv[i][1], acc[r][i]);
          acc[r][i] = fmaf(pp.z, vv[i][2], acc[r][i]);
          acc[r][i] = fmaf(pp.w, vv[i][3], acc[r][i]);
        }
      }
    }
    __syncwarp();  // P rows are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < F32_R; ++r) {
    const int row = q0 + rw + r;
    const float lr = warp_sum(l[r]);
    const float inv = lr == 0.f ? 1.f : 1.f / lr;
    if (row < a.Sq) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        if (c < HD) op[row * a.so.s + c] = acc[r][i] * inv;
      }
    }
  }
}

// -- launch -------------------------------------------------------------------

template <int HD>
static int launch(int dtype, Args a, int B, cudaStream_t stream) {
  const long long batch_heads = (long long)B * a.H;
  if (dtype == kBFloat16) {
    if constexpr (HD == 64 || HD == 128) {
      return hopper::launch<HD>(a, B, stream);
    } else {
      a.n_qt = (a.Sq + 63) / 64;
      const long long blocks = batch_heads * a.n_qt;
      if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      flash_fwd_mma<HD><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
      return (int)cudaGetLastError();
    }
  }
  if (dtype == kFloat32) {
    constexpr int smem = f32_smem_bytes<HD>();  // above 48 KB after opt-in
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(flash_fwd_f32<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    a.n_qt = (a.Sq + F32_BQ - 1) / F32_BQ;
    const long long blocks = batch_heads * a.n_qt;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    flash_fwd_f32<HD><<<(unsigned)blocks, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace cmve

// C entry: returns 0, the tensor-map encoder's error, or cudaGetLastError()
// after the launch.
// strides: 12 element strides, (batch, head, sequence) of q, k, v and o;
// the head dimension is contiguous in all four.
extern "C" int cmve_flash_attention(int dtype, const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Sq, int Skv, int hd,
                                    const long long* strides, float scale,
                                    int causal, void* stream) {
  using namespace cmve::flash;
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.so = {strides[9], strides[10], strides[11]};
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.n_qt = 0;
  a.items = 0;
  a.causal = causal != 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(dtype, a, B, s);
    case 32: return launch<32>(dtype, a, B, s);
    case 48: return launch<48>(dtype, a, B, s);
    case 64: return launch<64>(dtype, a, B, s);
    case 80: return launch<80>(dtype, a, B, s);
    case 96: return launch<96>(dtype, a, B, s);
    case 112: return launch<112>(dtype, a, B, s);
    case 128: return launch<128>(dtype, a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

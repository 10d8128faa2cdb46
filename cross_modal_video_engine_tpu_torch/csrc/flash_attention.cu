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
// bf16 path: four warps, each owning 16 query rows of a 64-row tile,
// four blocks an SM up to head dim 64.
// S = q k^T and O += P v run on mma.sync m16n8k16 with fp32 accumulators;
// the online softmax works on the S fragments in registers, and P, packed
// to bf16 from them, is the A operand of P v.  K and V tiles (64 keys, 32
// above head dim 64) are double-buffered in shared memory by cp.async,
// zero-filled past Skv, and read by ldmatrix (V transposed by .trans).
// f32 path: CUDA-core FMA; four warps of 8 query rows each, a lane per key
// for the scores and a lane per channel for P v, on 32-key tiles in shared
// memory.  It serves f32 models (TimeSformerConfig's default dtype) and
// holds the algorithm apart from rounding on the card.
//
// What bounds it on the H100: at S = 1569 and head dim 64 one (b, h) does
// about 630 MFLOP on about 0.6 MB of q/k/v, so attention is tensor-core
// bound; the plain version instead writes and reads the fp32 scores and
// probabilities, about 1.9 GB per layer at 16 videos of 12 heads.  This
// kernel keeps scores and P in registers and reads each K/V tile once per
// 64 queries, so its limit is the mma.sync issue rate, the exp of every
// score on the special-function units, and the softmax arithmetic between
// the two products.  exp is __expf (one multiply and one ex2.approx, a
// relative error near 2^-21): the accurate expf costs about ten
// instructions a score, which made the softmax, not the products, the
// larger share of the instructions issued.  wgmma with TMA-fed K/V rings
// and warp-specialised softmax (the FlashAttention-3 shape) is the way
// past it.

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
  float scale;
};

// the key tiles a query tile [q0, q0 + bq) needs: under causal masking,
// none whose first key lies past the tile's last row
__device__ __forceinline__ int kv_tiles(const Args& a, int q0, int bq,
                                        int bk) {
  const int n = (a.Skv + bk - 1) / bk;
  return a.causal ? min(n, (q0 + bq - 1) / bk + 1) : n;
}

// -- bf16, tensor cores -------------------------------------------------------

// four blocks per SM up to head dim 64 (at most 128 registers a thread)
template <int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 4 : 2)
    flash_fwd_bf16(Args a) {
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
static int launch(int dtype, Args a, long long batch_heads,
                  cudaStream_t stream) {
  if (dtype == kBFloat16) {
    a.n_qt = (a.Sq + 63) / 64;
    const long long blocks = batch_heads * a.n_qt;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    flash_fwd_bf16<HD><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
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

// C entry: returns cudaGetLastError() after the launch (0 on success).
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
  a.causal = causal != 0;
  a.scale = scale;
  const long long bh = (long long)B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(dtype, a, bh, s);
    case 32: return launch<32>(dtype, a, bh, s);
    case 48: return launch<48>(dtype, a, bh, s);
    case 64: return launch<64>(dtype, a, bh, s);
    case 80: return launch<80>(dtype, a, bh, s);
    case 96: return launch<96>(dtype, a, bh, s);
    case 112: return launch<112>(dtype, a, bh, s);
    case 128: return launch<128>(dtype, a, bh, s);
  }
  return (int)cudaErrorInvalidValue;
}

// GEMM with three epilogues: the projections of the attention and MLP
// sublayers.
//
// Replaces (with layernorm.cu and attention_core.cu) the projection GEMMs
// inside the Pallas kernels of
// cross_modal_video_engine_tpu/ops/attention_sublayer.py:
//   _kernel / _attn_pallas                      (fused_attention_sublayer)
//   _attn_body_compact / _attn_pallas_compact   (fused_attention_sublayer_compact)
//   _mlp_kernel / _mlp_pallas                   (fused_mlp_sublayer)
// out[M, N] = epilogue(a[M, K] @ W[N, K]^T + bias), W in torch Linear
// layout.  One launch may run up to three products that share `a` (q, k
// and v).  Rounding points follow the Pallas kernels: every weight and
// bias in x.dtype (the wrapper casts), fp32 accumulation, quick_gelu in
// fp32 before the cast, the projection rounded to x.dtype before the
// residual add in x.dtype.
//
// What bounds it on the H100: at the ViT-B/32 shapes (M = frames*50 rows,
// K = 768 or 3072) the products are compute-bound, and only wgmma reaches
// the tensor cores' full rate.
//
// bf16 path (gemm_wgmma): one persistent block of three warpgroups on each
// SM walks over the output tiles of all the launch's products.  One thread
// of the producer warpgroup keeps TMA loads of A (128 x 64) and W (BN x 64)
// tiles in flight on a ring of full/empty mbarriers; the boxes land with the
// 128-byte swizzle, K-major, which is what wgmma reads.  Each of the two
// consumer warpgroups owns 64 rows of the 128 x BN tile, runs
// m64nBNk16 from shared memory with one group of products in flight, and
// frees a stage when the group that read it has finished.  The epilogue
// (bias, quick_gelu, rounding) goes from the accumulators through a
// per-warpgroup staging tile to 16-byte stores, the residual added there;
// the producer is already loading the next tile meanwhile.  BN is 256 or
// 128, chosen per launch so that the last wave of tiles is not mostly
// empty.  Ragged M, N and K: TMA fills with zeros, the stores are guarded.
// The MLP's hidden activation still goes through device memory (at (6400,
// 3072) most of it stays in L2): keeping it on chip needs a 64 x 768 fp32
// sum per block in registers, which is block_sublayer.cu's design and
// spills there.  LayerNorm stays a launch of its own (layernorm.cu).
//
// float32 runs on the CUDA cores (a register-tiled FMA loop over a
// four-stage cp.async ring) and exists to separate algorithm from
// rounding on the card.

#include "common.cuh"

namespace cmve {

// up to three products sharing the A operand (q, k, v)
struct GemmBatch {
  const void* w[3];     // (N, K) row-major
  const void* bias[3];  // (N,)
  void* out[3];         // (M, N) row-major
};

// bias (+ quick_gelu in fp32) on an accumulator.  FAST: the sigmoid from one
// ex2 and one reciprocal of the special-function units (relative error near
// 2^-21, far below the bf16 rounding that follows); with the accurate expf
// and division the epilogue of a 128 x 256 tile took as long as its
// products over K = 768.
template <int EPI, bool FAST>
__device__ __forceinline__ float finish(float v, float b) {
  v += b;
  if (EPI == kBiasQuickGelu) {
    if (FAST)
      v = __fdividef(v, 1.0f + ex2_approx(-1.702f * 1.4426950408889634f * v));
    else
      v = v * (1.0f / (1.0f + expf(-1.702f * v)));
  }
  return v;
}

// -- bf16: wgmma from a TMA/mbarrier ring, persistent ---------------------------

namespace wg {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;        // two consumer warpgroups x 64 rows
constexpr int BK = 64;         // 128 bytes of bf16: one swizzle row
constexpr int THREADS = 384;   // producer + two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;

template <int BN> struct Cfg {
  static constexpr int STAGES = BN == 256 ? 3 : 5;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr int CP = BN + 8;  // staging row: 16-byte rows, banks spread
  static constexpr int C_BYTES = 64 * CP * 2;  // one warpgroup's staging tile
  // ring, two staging tiles, and room to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * C_BYTES + 1024;
};

template <int BN>
__device__ __forceinline__ void mma_step(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 256)
    wgmma_m64n256k16_ss<0>(d, da, db, scale_d);
  else
    wgmma_m64n128k16_ss<0>(d, da, db, scale_d);
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_w0,
               const __grid_constant__ CUtensorMap map_w1,
               const __grid_constant__ CUtensorMap map_w2, GemmBatch batch,
               const bf16* __restrict__ resid, int nmat, int M, int N, int K) {
  using C = Cfg<BN>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const ring = align_1024(smem_raw);
  bf16* const staging = reinterpret_cast<bf16*>(ring + STAGES * C::STAGE_BYTES);
  __shared__ uint64_t full[STAGES], empty[STAGES];

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 2);  // one thread of each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the schedule: tiles in row-major order over (row tile, product, column
  // tile), so the blocks running together share rows of A and all of W
  const int nt_n = (N + BN - 1) / BN, cols = nmat * nt_n;
  const int tiles = ((M + BM - 1) / BM) * cols;
  const int ktiles = (K + BK - 1) / BK;

  if (tid < 128) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (tid == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / cols) * BM, c = tile % cols;
        const int mat = c / nt_n, n0 = (c % nt_n) * BN;
        const CUtensorMap* map_w =
            mat == 0 ? &map_w0 : mat == 1 ? &map_w1 : &map_w2;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* const st = ring + stage * C::STAGE_BYTES;
          mbar_expect_tx(&full[stage], C::STAGE_BYTES);
          tma_load_2d(st, &map_a, &full[stage], kt * BK, m0);
          tma_load_2d(st + A_BYTES, map_w, &full[stage], kt * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows 64 cw .. + 63 of the tile ----
    setmaxnreg_inc<232>();
    const int cw = tid / 128 - 1, t128 = tid % 128;
    const int warp = t128 >> 5, lane = t128 & 31, g = lane >> 2, tq = lane & 3;
    bf16* const ct = staging + cw * 64 * C::CP;
    float d[BN / 2];
    int stage = 0, phase = 0;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / cols) * BM + cw * 64, c = tile % cols;
      const int mat = c / nt_n, n0 = (c % nt_n) * BN;

      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[stage], phase);
        unsigned char* const st = ring + stage * C::STAGE_BYTES;
        const uint64_t da = wgmma_desc_sw128(st + cw * 64 * BK * 2, 16, 1024);
        const uint64_t db = wgmma_desc_sw128(st + A_BYTES, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          mma_step<BN>(d, wgmma_desc_advance(da, 32 * ks),
                       wgmma_desc_advance(db, 32 * ks), (kt | ks) != 0);
        wgmma_commit();
        if (kt > 0) {  // the group that read the previous stage is done
          wgmma_wait<1>();
          if (t128 == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      wgmma_pin<BN / 2>(d);
      if (t128 == 0) mbar_arrive(&empty[prev]);

      // epilogue, first half: bias (+ quick_gelu in fp32) on the
      // accumulators, rounded to bf16 into this warpgroup's staging tile
      const bf16* __restrict__ bias = static_cast<const bf16*>(
          mat == 0 ? batch.bias[0] : mat == 1 ? batch.bias[1] : batch.bias[2]);
      bf16* __restrict__ out = static_cast<bf16*>(
          mat == 0 ? batch.out[0] : mat == 1 ? batch.out[1] : batch.out[2]);
      named_barrier_sync(1 + cw, 128);  // the last tile's staging is read
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        float b0 = 0.f, b1 = 0.f;
        if (n0 + col < N) {  // N is a multiple of 8: the pair is in or out
          const __nv_bfloat162 bb =
              *reinterpret_cast<const __nv_bfloat162*>(bias + n0 + col);
          b0 = __low2float(bb);
          b1 = __high2float(bb);
        }
        bf16* const p = ct + (warp * 16 + g) * C::CP + col;
        *reinterpret_cast<uint32_t*>(p) =
            pack_bf16(finish<EPI, true>(d[4 * j], b0),
                      finish<EPI, true>(d[4 * j + 1], b1));
        *reinterpret_cast<uint32_t*>(p + 8 * C::CP) =
            pack_bf16(finish<EPI, true>(d[4 * j + 2], b0),
                      finish<EPI, true>(d[4 * j + 3], b1));
      }
      named_barrier_sync(1 + cw, 128);

      // second half: whole 16-byte pieces of rows to device memory; the
      // residual is added here, in bf16, to the rounded projection
      constexpr int VPR = BN / 8;
      for (int i = t128; i < 64 * VPR; i += 128) {
        const int r = i / VPR, col = (i % VPR) * 8;
        if (m0 + r >= M || n0 + col >= N) continue;
        const size_t o = (size_t)(m0 + r) * N + n0 + col;
        alignas(16) bf16 e[8];
        *reinterpret_cast<uint4*>(e) =
            *reinterpret_cast<const uint4*>(ct + r * C::CP + col);
        if (EPI == kBiasResidual) {
          alignas(16) bf16 x[8];
          *reinterpret_cast<uint4*>(x) =
              *reinterpret_cast<const uint4*>(resid + o);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = from_f32<bf16>(to_f32(e[j]) + to_f32(x[j]));
        }
        *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(e);
      }
    }
  }
}

// the cost of a launch in units of 128 x 128 tiles of one SM's time: full
// waves of tiles, the wider tile a little cheaper per column
static double waves_cost(int bn, int nmat, int M, int N, int sms) {
  const long long tiles =
      (long long)((M + BM - 1) / BM) * nmat * ((N + bn - 1) / bn);
  return (double)((tiles + sms - 1) / sms) * (bn == 256 ? 1.85 : 1.0);
}

template <int BN, int EPI>
static int launch(const CUtensorMap* maps, const GemmBatch& batch,
                  const void* resid, int nmat, int M, int N, int K, int sms,
                  cudaStream_t stream) {
  using C = Cfg<BN>;
  cudaFuncSetAttribute(gemm_wgmma<BN, EPI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  const long long tiles =
      (long long)((M + BM - 1) / BM) * nmat * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_wgmma<BN, EPI><<<grid, THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], batch,
      static_cast<const bf16*>(resid), nmat, M, N, K);
  return (int)cudaGetLastError();
}

template <int BN>
static int dispatch(int epilogue, const void* a, const void* resid,
                    const GemmBatch& batch, int nmat, int M, int N, int K,
                    int sms, cudaStream_t stream) {
  // the activations' map is made per call; the weights' maps are kept by
  // address, shape and box (a map encodes no contents)
  CUtensorMap maps[4];
  const cuuint64_t stride[1] = {(cuuint64_t)K * 2};
  const cuuint64_t dims_a[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dims_w[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint32_t box_a[2] = {BK, BM}, box_w[2] = {BK, BN};
  if (int err = make_tensor_map_bf16(&maps[0], a, 2, dims_a, stride, box_a))
    return err;
  for (int i = 0; i < 3; ++i)  // unused products repeat the first
    if (int err = cached_tensor_map_2d(&maps[1 + i], batch.w[i < nmat ? i : 0],
                                       dims_w, stride[0], box_w))
      return err;
  switch (epilogue) {
    case kBias:
      return launch<BN, kBias>(maps, batch, resid, nmat, M, N, K, sms, stream);
    case kBiasQuickGelu:
      return launch<BN, kBiasQuickGelu>(maps, batch, resid, nmat, M, N, K, sms,
                                        stream);
    case kBiasResidual:
      return launch<BN, kBiasResidual>(maps, batch, resid, nmat, M, N, K, sms,
                                       stream);
  }
  return (int)cudaErrorInvalidValue;
}

static int run(int epilogue, const void* a, const void* resid,
               const GemmBatch& batch, int nmat, int M, int N, int K,
               cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (waves_cost(256, nmat, M, N, sms) < waves_cost(128, nmat, M, N, sms))
    return dispatch<256>(epilogue, a, resid, batch, nmat, M, N, K, sms, stream);
  return dispatch<128>(epilogue, a, resid, batch, nmat, M, N, K, sms, stream);
}

}  // namespace wg

// -- float32: CUDA cores over a cp.async ring ---------------------------------

namespace f32 {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;
constexpr int STAGES = 4;  // k-tiles in flight in the shared-memory ring
// rows stay 16-byte aligned, and the padding spreads the reads over the 32
// shared-memory banks
constexpr int BK = 16, PAD = 4, BKP = BK + PAD;
constexpr int SMEM = STAGES * (BM + BN) * BKP * (int)sizeof(float);

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const float* __restrict__ a, const float* __restrict__ resid,
                GemmBatch batch, int M, int N, int K) {
  using T = float;
  constexpr int VEC = 16 / sizeof(T);           // elements per 16-byte load
  constexpr int VPR = BK / VEC;                 // 16-byte loads per tile row
  constexpr int NV = BM * VPR / THREADS;        // loads per thread per operand
  static_assert(BM == BN, "A and B tiles share the load mapping");
  static_assert(NV * THREADS == BM * VPR, "tile must split evenly");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  constexpr int STAGE = (BM + BN) * BKP;       // elements per ring stage
  auto As = [&](int st, int r, int c) { return smem + st * STAGE + r * BKP + c; };
  auto Bs = [&](int st, int r, int c) {
    return smem + st * STAGE + (BM + r) * BKP + c;
  };

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // select by comparison: indexing the parameter arrays by blockIdx.z
  // would copy them to the stack
  const int z = blockIdx.z;
  const T* __restrict__ w = static_cast<const T*>(
      z == 0 ? batch.w[0] : z == 1 ? batch.w[1] : batch.w[2]);
  const T* __restrict__ bias = static_cast<const T*>(
      z == 0 ? batch.bias[0] : z == 1 ? batch.bias[1] : batch.bias[2]);
  T* __restrict__ out = static_cast<T*>(
      z == 0 ? batch.out[0] : z == 1 ? batch.out[1] : batch.out[2]);

  const int ktiles = (K + BK - 1) / BK;
  // start the copies of k-tile kt into ring stage kt % STAGES
  auto load_tile = [&](int kt) {
    const int st = kt % STAGES;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / VPR, c = (idx % VPR) * VEC, gk = kt * BK + c;
      const bool pa = gk < K && m0 + r < M, pb = gk < K && n0 + r < N;
      cp_async16(As(st, r, c), pa ? a + (size_t)(m0 + r) * K + gk : a, pa);
      cp_async16(Bs(st, r, c), pb ? w + (size_t)(n0 + r) * K + gk : w, pb);
    }
  };
  // k-tile kt has landed and every warp is done with tile kt - 1, whose
  // stage the next copies overwrite
  auto next_tile = [&](int kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load_tile(kt + STAGES - 1);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s);
    cp_async_commit();
  }

  // 16 x 16 threads, each owning rows ty + 16 i and columns tx + 16 j of
  // the tile (conflict-light shared-memory reads)
  const int tx = tid & 15, ty = tid >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    next_tile(kt);
    const int st = kt % STAGES;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = *As(st, ty + 16 * i, k);
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = *Bs(st, tx + 16 * j, k);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue, first half: bias (+ quick_gelu) on the accumulators into an
  // output tile that reuses the ring
  constexpr int CP = BN + 16 / sizeof(T);  // 16-byte rows, banks spread
  static_assert(BM * CP <= STAGES * STAGE, "output tile fits in the ring");
  T* const ctile = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      ctile[r * CP + c] =
          finish<EPI, false>(acc[i][j], n0 + c < N ? bias[n0 + c] : 0.f);
    }
  __syncthreads();

  // second half: whole 16-byte pieces of rows to device memory, the
  // residual added to the projection
  for (int i = tid; i < BM * (BN / VEC); i += THREADS) {
    const int r = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
    if (m0 + r >= M || n0 + c >= N) continue;
    const size_t o = (size_t)(m0 + r) * N + n0 + c;
    float4 e = *reinterpret_cast<const float4*>(ctile + r * CP + c);
    if (EPI == kBiasResidual) {
      const float4 x = *reinterpret_cast<const float4*>(resid + o);
      e.x += x.x;
      e.y += x.y;
      e.z += x.z;
      e.w += x.w;
    }
    *reinterpret_cast<float4*>(out + o) = e;
  }
}

template <int EPI>
static int launch(const void* a, const void* resid, const GemmBatch& batch,
                  int nmat, int M, int N, int K, cudaStream_t stream) {
  cudaFuncSetAttribute(gemm_kernel<EPI>,  // above 48 KB only after opting in
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nmat);
  gemm_kernel<EPI><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(resid), batch,
      M, N, K);
  return (int)cudaGetLastError();
}

static int run(int epilogue, const void* a, const void* resid,
               const GemmBatch& batch, int nmat, int M, int N, int K,
               cudaStream_t stream) {
  switch (epilogue) {
    case kBias:
      return launch<kBias>(a, resid, batch, nmat, M, N, K, stream);
    case kBiasQuickGelu:
      return launch<kBiasQuickGelu>(a, resid, batch, nmat, M, N, K, stream);
    case kBiasResidual:
      return launch<kBiasResidual>(a, resid, batch, nmat, M, N, K, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace f32
}  // namespace cmve

// C entry: returns 0, the tensor-map encoder's error, or cudaGetLastError()
// after the launch.
extern "C" int cmve_gemm(int dtype, int epilogue, const void* a,
                         const void* resid, const void* w0, const void* b0,
                         void* o0, const void* w1, const void* b1, void* o1,
                         const void* w2, const void* b2, void* o2, int nmat,
                         int M, int N, int K, void* stream) {
  using namespace cmve;
  if (nmat < 1 || nmat > 3 || M <= 0 || N <= 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  GemmBatch batch = {{w0, w1, w2}, {b0, b1, b2}, {o0, o1, o2}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return wg::run(epilogue, a, resid, batch, nmat, M, N, K, s);
  if (dtype == kFloat32)
    return f32::run(epilogue, a, resid, batch, nmat, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

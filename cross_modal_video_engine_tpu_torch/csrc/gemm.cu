// Tiled GEMM with three epilogues: the projections of the attention and
// MLP sublayers.
//
// Replaces (with layernorm.cu and attention_core.cu) the projection GEMMs
// inside the Pallas kernels of
// cross_modal_video_engine_tpu/ops/attention_sublayer.py:
//   _kernel / _attn_pallas                      (fused_attention_sublayer)
//   _attn_body_compact / _attn_pallas_compact   (fused_attention_sublayer_compact)
//   _mlp_kernel / _mlp_pallas                   (fused_mlp_sublayer)
// out[M, N] = epilogue(a[M, K] @ W[N, K]^T + bias), W in torch Linear
// layout.  One launch may run up to three products that share `a` (q, k
// and v), selected by blockIdx.z.  Rounding points follow the Pallas
// kernels: every weight and bias in x.dtype (the wrapper casts), fp32
// accumulation, quick_gelu in fp32 before the cast, the projection
// rounded to x.dtype before the residual add in x.dtype.
//
// What bounds it on the H100: at the ViT-B/32 shapes (M = frames*50 rows,
// K = 768 or 3072) the products are compute-bound.  This kernel feeds
// mma.sync m16n8k16 bf16 (ldmatrix fragments) from a four-stage cp.async
// ring in shared memory, two 256-thread blocks per SM, so it reaches a
// fraction of the tensor cores' rate: mma.sync issues from every warp,
// and wgmma is the only way to the full rate.  q/k/v and the MLP hidden
// go through device memory.  float32 runs on the CUDA cores (a
// register-tiled FMA loop over the same ring) and exists to separate
// algorithm from rounding on the card.
//
// A faster design: TMA loads into an mbarrier ring, wgmma from shared
// memory with a producer warp and two consumer warpgroups, a persistent
// grid, the LayerNorm applied while staging the A tile, and the attention
// core fused between the projections so that q/k/v and the 4x-wide MLP
// hidden never leave the SM.

#include "common.cuh"

namespace cmve {

enum Epilogue { kBias = 0, kBiasQuickGelu = 1, kBiasResidual = 2 };

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;
constexpr int STAGES = 4;  // k-tiles in flight in the shared-memory ring

// BK and row padding per element type: rows stay 16-byte aligned, and the
// padding spreads the fragment loads over the 32 shared-memory banks
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BK = 32, PAD = 8;
};
template <> struct Tile<float> {
  static constexpr int BK = 16, PAD = 4;
};

// up to three products sharing the A operand (q, k, v)
struct GemmBatch {
  const void* w[3];     // (N, K) row-major
  const void* bias[3];  // (N,)
  void* out[3];         // (M, N) row-major
};

template <typename T> constexpr int smem_bytes() {
  return STAGES * (BM + BN) * (Tile<T>::BK + Tile<T>::PAD) * (int)sizeof(T);
}

// bf16: two blocks per SM, so at most 128 registers a thread
template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ resid,
                GemmBatch batch, int M, int N, int K) {
  constexpr int BK = Tile<T>::BK;
  constexpr int BKP = BK + Tile<T>::PAD;
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
  const int warp = tid >> 5, lane = tid & 31;
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
  // issue the copies of k-tile kt into ring stage kt % STAGES
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

  // epilogue, first half: bias (+ quick_gelu in fp32) on the accumulators,
  // rounded to T into an output tile that reuses the ring
  constexpr int CP = BN + 16 / sizeof(T);  // 16-byte rows, banks spread
  static_assert(BM * CP <= STAGES * STAGE, "output tile fits in the ring");
  T* const ctile = smem;
  auto put = [&](int r, int c, float v) {
    if (n0 + c < N) v += to_f32(bias[n0 + c]);
    if (EPI == kBiasQuickGelu) v = v * (1.0f / (1.0f + expf(-1.702f * v)));
    ctile[r * CP + c] = from_f32<T>(v);
  };
  auto ring_done = [&]() {
    cp_async_wait<0>();
    __syncthreads();
  };

  if constexpr (sizeof(T) == 2) {
    // 8 warps as 2 (rows) x 4 (columns); each owns a 64 x 32 output tile
    // of 4 x 4 m16n8 fragments
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int kt = 0; kt < ktiles; ++kt) {
      next_tile(kt);
      const int st = kt % STAGES;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], As(st, wm + mi * 16 + (lane & 15),
                                 kk + (lane >> 4) * 8));
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t r[4];
          ldmatrix_x4(r, Bs(st, wn + nj * 16 + (lane & 7) + ((lane >> 4) << 3),
                            kk + ((lane >> 3) & 1) * 8));
          bfr[2 * nj][0] = r[0];
          bfr[2 * nj][1] = r[1];
          bfr[2 * nj + 1][0] = r[2];
          bfr[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
      }
    }
    ring_done();
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int r = wm + mi * 16 + g, c = wn + ni * 8 + 2 * t;
        put(r, c, acc[mi][ni][0]);
        put(r, c + 1, acc[mi][ni][1]);
        put(r + 8, c, acc[mi][ni][2]);
        put(r + 8, c + 1, acc[mi][ni][3]);
      }
  } else {
    // float32: 16 x 16 threads, each owning rows ty + 16 i and columns
    // tx + 16 j of the tile (conflict-light shared-memory reads)
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
    ring_done();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) put(ty + 16 * i, tx + 16 * j, acc[i][j]);
  }
  __syncthreads();

  // second half: whole 16-byte pieces of rows to device memory; the
  // residual is added here, in T, to the rounded projection
  for (int i = tid; i < BM * (BN / VEC); i += THREADS) {
    const int r = i / (BN / VEC), c = (i % (BN / VEC)) * VEC;
    if (m0 + r >= M || n0 + c >= N) continue;
    const size_t o = (size_t)(m0 + r) * N + n0 + c;
    alignas(16) T e[VEC];
    *reinterpret_cast<uint4*>(e) =
        *reinterpret_cast<const uint4*>(ctile + r * CP + c);
    if (EPI == kBiasResidual) {
      alignas(16) T x[VEC];
      *reinterpret_cast<uint4*>(x) = *reinterpret_cast<const uint4*>(resid + o);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        e[j] = from_f32<T>(to_f32(e[j]) + to_f32(x[j]));
    }
    *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(e);
  }
}

template <typename T, int EPI>
static int launch(const void* a, const void* resid, const GemmBatch& batch,
                  int nmat, int M, int N, int K, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();  // above 48 KB only after opting in
  cudaFuncSetAttribute(gemm_kernel<T, EPI>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nmat);
  gemm_kernel<T, EPI><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(resid), batch, M, N,
      K);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int epilogue, const void* a, const void* resid,
                    const GemmBatch& batch, int nmat, int M, int N, int K,
                    cudaStream_t stream) {
  switch (epilogue) {
    case kBias:
      return launch<T, kBias>(a, resid, batch, nmat, M, N, K, stream);
    case kBiasQuickGelu:
      return launch<T, kBiasQuickGelu>(a, resid, batch, nmat, M, N, K,
                                       stream);
    case kBiasResidual:
      return launch<T, kBiasResidual>(a, resid, batch, nmat, M, N, K, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cmve

// C entry: returns cudaGetLastError() after the launch (0 on success).
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
    return dispatch<__nv_bfloat16>(epilogue, a, resid, batch, nmat, M, N, K,
                                   s);
  if (dtype == kFloat32)
    return dispatch<float>(epilogue, a, resid, batch, nmat, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}

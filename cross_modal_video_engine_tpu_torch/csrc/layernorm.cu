// LayerNorm with fp32 statistics, output rounded to x.dtype: the first
// stage of both sublayers, ahead of the QKV and c_fc projections of
// gemm.cu.
//
// Replaces the `_ln_f32` step inside the Pallas kernels of
// cross_modal_video_engine_tpu/ops/attention_sublayer.py (_kernel line 78,
// _attn_body_compact line 263, _mlp_kernel line 434): mean and variance in
// fp32 by two passes over the row, (x - mu) * rsqrt(var + eps) * scale +
// bias in fp32 with scale and bias rounded to x.dtype (the wrapper casts),
// rounded once to x.dtype.
//
// What bounds it on the H100: device-memory bandwidth (one read and one
// write of the rows; the row is re-read from L1/L2 by the second and third
// passes).  One warp per row, 16-byte loads.  A faster design applies the
// normalisation while the GEMM stages its A tile, from per-row statistics,
// so that LN(x) never goes through device memory.

#include "common.cuh"

namespace cmve {

constexpr int LN_THREADS = 256;  // 8 rows per block

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
    layernorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                     const T* __restrict__ bias, T* __restrict__ out, int M,
                     int K, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  T* yr = out + (size_t)row * K;
  const int nvec = K / VEC;

  float s = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    alignas(16) T e[VEC];
    *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xr)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += to_f32(e[j]);
  }
  const float mu = warp_sum(s) / (float)K;
  float s2 = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    alignas(16) T e[VEC];
    *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xr)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = to_f32(e[j]) - mu;
      s2 += d * d;
    }
  }
  const float rs = rsqrtf(warp_sum(s2) / (float)K + eps);
  for (int v = lane; v < nvec; v += 32) {
    alignas(16) T e[VEC], sc[VEC], bi[VEC];
    *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xr)[v];
    *reinterpret_cast<uint4*>(sc) = reinterpret_cast<const uint4*>(scale)[v];
    *reinterpret_cast<uint4*>(bi) = reinterpret_cast<const uint4*>(bias)[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      e[j] = from_f32<T>((to_f32(e[j]) - mu) * rs * to_f32(sc[j]) +
                         to_f32(bi[j]));
    reinterpret_cast<uint4*>(yr)[v] = *reinterpret_cast<uint4*>(e);
  }
}

}  // namespace cmve

// C entry: returns cudaGetLastError() after the launch (0 on success).
// K must be a multiple of 8 and every pointer 16-byte aligned.
extern "C" int cmve_layernorm(int dtype, const void* x, const void* scale,
                              const void* bias, void* out, int M, int K,
                              float eps, void* stream) {
  using namespace cmve;
  if (M <= 0 || K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  const int grid = (M + LN_THREADS / 32 - 1) / (LN_THREADS / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    layernorm_kernel<T><<<grid, LN_THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<const T*>(bias), static_cast<T*>(out), M, K, eps);
  } else if (dtype == kFloat32) {
    layernorm_kernel<float><<<grid, LN_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(out), M, K, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

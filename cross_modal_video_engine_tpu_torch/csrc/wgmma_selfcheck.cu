// One 64 x 64 x 64 tile through the Hopper building blocks of common.cuh,
// so that a wrong tensor map, swizzle or descriptor shows at the smallest
// size and not inside gemm.cu or flash_attention.cu:
//   d1 = a b^T      a (64, 64) and b (64, 64) row-major, both K-major: three
//                   TMA boxes on one mbarrier, wgmma from shared memory;
//   d2 = bf16(d1) v v (64, 64) row-major is the MN-major B operand (wgmma's
//                   transpose bit), and the A operand is the first product's
//                   accumulators packed to bf16 in registers: the P v
//                   product of flash attention.
// Replaces no TPU kernel; tests/test_torch_kernels_cuda.py holds it against
// torch.matmul.

#include "common.cuh"

namespace cmve {

__global__ void __launch_bounds__(128)
    wgmma_selfcheck_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_v,
                           float* __restrict__ d1, float* __restrict__ d2) {
  constexpr int TILE = 64 * 64 * 2;  // bytes of one operand
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const tiles = align_1024(smem_raw);
  __shared__ uint64_t full;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&full, 3 * TILE);
    tma_load_2d(tiles, &map_a, &full, 0, 0);
    tma_load_2d(tiles + TILE, &map_b, &full, 0, 0);
    tma_load_2d(tiles + 2 * TILE, &map_v, &full, 0, 0);
  }
  mbar_wait(&full, 0);

  const uint64_t da = wgmma_desc_sw128(tiles, 16, 1024);
  const uint64_t db = wgmma_desc_sw128(tiles + TILE, 16, 1024);
  const uint64_t dv = wgmma_desc_sw128(tiles + 2 * TILE, 16, 1024);
  float s[32], o[32];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_m64n64k16_ss<0>(s, wgmma_desc_advance(da, 32 * ks),
                          wgmma_desc_advance(db, 32 * ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();

  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t pf[4] = {pack_bf16(s[8 * ks], s[8 * ks + 1]),
                            pack_bf16(s[8 * ks + 2], s[8 * ks + 3]),
                            pack_bf16(s[8 * ks + 4], s[8 * ks + 5]),
                            pack_bf16(s[8 * ks + 6], s[8 * ks + 7])};
    wgmma_m64n64k16_rs<1>(o, pf, wgmma_desc_advance(dv, 2048 * ks), ks > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();

  const int row = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + col;
    d1[row * 64 + c] = s[4 * j];
    d1[row * 64 + c + 1] = s[4 * j + 1];
    d1[(row + 8) * 64 + c] = s[4 * j + 2];
    d1[(row + 8) * 64 + c + 1] = s[4 * j + 3];
    d2[row * 64 + c] = o[4 * j];
    d2[row * 64 + c + 1] = o[4 * j + 1];
    d2[(row + 8) * 64 + c] = o[4 * j + 2];
    d2[(row + 8) * 64 + c + 1] = o[4 * j + 3];
  }
}

}  // namespace cmve

// C entry: a, b, v are contiguous (64, 64) bf16, d1 and d2 (64, 64) fp32.
// Returns 0, the tensor-map encoder's error, or cudaGetLastError().
extern "C" int cmve_wgmma_selfcheck(const void* a, const void* b,
                                    const void* v, void* d1, void* d2,
                                    void* stream) {
  using namespace cmve;
  const cuuint64_t dims[2] = {64, 64}, strides[1] = {128};
  const cuuint32_t box[2] = {64, 64};
  CUtensorMap maps[3];
  const void* base[3] = {a, b, v};
  for (int i = 0; i < 3; ++i)
    if (int err = make_tensor_map_bf16(&maps[i], base[i], 2, dims, strides,
                                       box))
      return err;
  constexpr int smem = 3 * 64 * 64 * 2 + 1024;
  cudaFuncSetAttribute(wgmma_selfcheck_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_selfcheck_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(d1),
      static_cast<float*>(d2));
  return (int)cudaGetLastError();
}

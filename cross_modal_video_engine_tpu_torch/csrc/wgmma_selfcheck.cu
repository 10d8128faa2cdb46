// One 64 x 64 x 64 tile through the Hopper building blocks of common.cuh,
// so that a wrong tensor map, swizzle or descriptor shows at the smallest
// size and not inside gemm.cu, flash_attention.cu or attention_core.cu:
//   d1 = a b^T      a (64, 64) and b (64, 64) row-major, both K-major: three
//                   TMA boxes on one mbarrier, wgmma from shared memory;
//   d2 = bf16(d1) v v (64, 64) row-major is the MN-major B operand (wgmma's
//                   transpose bit), and the A operand is the first product's
//                   accumulators packed to bf16 in registers: the P v
//                   product of flash attention.
// and, for attention_core.cu, one 64 x 80 x 64 tile through what is new there:
//   d1 = a k^T      k is sequence 1 of a (2, 80, 64) buffer, read through a
//                   3-D tensor map (channels, rows bounded at 77, sequences)
//                   with a box of 80 rows: the hardware zero-fills rows 77-79
//                   whatever the buffer holds there; wgmma m64n80k16;
//   d2 = bf16(d1) v v read the same way, five 16-key steps of the P v form.
// and, for block_sublayer.cu, its two product forms:
//   d1 = a b^T      a (64, 64) written into shared memory by the threads at
//                   `swz` addresses (as the kernel writes LN(x), the attention
//                   output and the hidden chunk), b columns 64-127 of a
//                   (192, 128) matrix, one TMA box of 192 rows: wgmma
//                   m64n192k16, the down step's output quarter;
//   d2 = a b'^T     b' rows 32-63 of the same box: m64n32k16 from a
//                   descriptor 32 rows into the tile, an up step's slice.
// Replaces no TPU kernel; tests/test_torch_kernels_cuda.py holds both against
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

// the key-tile forms of attention_core.cu: a 3-D box bounded below its
// extent, a 64 x 80 product, five k-steps of the register-operand product
constexpr int SC_KT = 80, SC_VALID = 77;

__global__ void __launch_bounds__(128)
    wgmma_selfcheck_keys_kernel(const __grid_constant__ CUtensorMap map_a,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                float* __restrict__ d1,
                                float* __restrict__ d2) {
  constexpr int A_BYTES = 64 * 128, KV_BYTES = SC_KT * 128;
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
    mbar_expect_tx(&full, A_BYTES + 2 * KV_BYTES);
    tma_load_3d(tiles, &map_a, &full, 0, 0, 0);
    tma_load_3d(tiles + A_BYTES, &map_k, &full, 0, 0, 1);
    tma_load_3d(tiles + A_BYTES + KV_BYTES, &map_v, &full, 0, 0, 1);
  }
  mbar_wait(&full, 0);

  const uint64_t da = wgmma_desc_sw128(tiles, 16, 1024);
  const uint64_t dk = wgmma_desc_sw128(tiles + A_BYTES, 16, 1024);
  const uint64_t dv = wgmma_desc_sw128(tiles + A_BYTES + KV_BYTES, 16, 1024);
  float s[SC_KT / 2], o[32];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_m64n80k16_ss<0>(s, wgmma_desc_advance(da, 32 * ks),
                          wgmma_desc_advance(dk, 32 * ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin<SC_KT / 2>(s);

  uint32_t pf[SC_KT / 4];
#pragma unroll
  for (int i = 0; i < SC_KT / 4; ++i) pf[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < SC_KT / 16; ++ks)
    wgmma_m64n64k16_rs<1>(o, pf + 4 * ks, wgmma_desc_advance(dv, 2048 * ks),
                          ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin<32>(o);

  const int row = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < SC_KT / 8; ++j) {
    const int c = 8 * j + col;
    d1[row * SC_KT + c] = s[4 * j];
    d1[row * SC_KT + c + 1] = s[4 * j + 1];
    d1[(row + 8) * SC_KT + c] = s[4 * j + 2];
    d1[(row + 8) * SC_KT + c + 1] = s[4 * j + 3];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + col;
    d2[row * 64 + c] = o[4 * j];
    d2[row * 64 + c + 1] = o[4 * j + 1];
    d2[(row + 8) * 64 + c] = o[4 * j + 2];
    d2[(row + 8) * 64 + c + 1] = o[4 * j + 3];
  }
}

// block_sublayer.cu's forms: A by st.shared at swizzled addresses, a
// 192-row box, N = 192 and an N = 32 slice 32 rows into it
__global__ void __launch_bounds__(128)
    wgmma_selfcheck_block_kernel(const __grid_constant__ CUtensorMap map_b,
                                 const __nv_bfloat16* __restrict__ a,
                                 float* __restrict__ d1,
                                 float* __restrict__ d2) {
  constexpr int A_BYTES = 64 * 128, B_ROWS = 192;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const tiles = align_1024(smem_raw);
  __nv_bfloat16* const A = reinterpret_cast<__nv_bfloat16*>(tiles);
  __shared__ uint64_t full;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&full, B_ROWS * 128);
    tma_load_2d(tiles + A_BYTES, &map_b, &full, 64, 0);
  }
  for (int i = tid; i < 64 * 8; i += 128)
    *reinterpret_cast<uint4*>(A + swz(i >> 3, (i & 7) * 8)) =
        reinterpret_cast<const uint4*>(a)[i];
  fence_proxy_async();
  __syncthreads();
  mbar_wait(&full, 0);

  const uint64_t da = wgmma_desc_sw128(tiles, 16, 1024);
  const uint64_t db = wgmma_desc_sw128(tiles + A_BYTES, 16, 1024);
  const uint64_t db32 = wgmma_desc_sw128(tiles + A_BYTES + 32 * 128, 16, 1024);
  float s[96], o[16];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_m64n192k16_ss<0>(s, wgmma_desc_advance(da, 32 * ks),
                           wgmma_desc_advance(db, 32 * ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_m64n32k16_ss<0>(o, wgmma_desc_advance(da, 32 * ks),
                          wgmma_desc_advance(db32, 32 * ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  wgmma_pin<96>(s);
  wgmma_pin<16>(o);

  const int row = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int c = 8 * j + col;
    d1[row * 192 + c] = s[4 * j];
    d1[row * 192 + c + 1] = s[4 * j + 1];
    d1[(row + 8) * 192 + c] = s[4 * j + 2];
    d1[(row + 8) * 192 + c + 1] = s[4 * j + 3];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 8 * j + col;
    d2[row * 32 + c] = o[4 * j];
    d2[row * 32 + c + 1] = o[4 * j + 1];
    d2[(row + 8) * 32 + c] = o[4 * j + 2];
    d2[(row + 8) * 32 + c + 1] = o[4 * j + 3];
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

// C entry: a is contiguous (64, 64) bf16, k and v contiguous (2, 80, 64) bf16
// of which rows 0-76 of sequence 1 are read; d1 (64, 80) and d2 (64, 64)
// fp32.  Returns 0, the tensor-map encoder's error, or cudaGetLastError().
extern "C" int cmve_wgmma_selfcheck_keys(const void* a, const void* k,
                                         const void* v, void* d1, void* d2,
                                         void* stream) {
  using namespace cmve;
  const cuuint64_t strides[2] = {128, (cuuint64_t)SC_KT * 128};
  const cuuint64_t dims_a[3] = {64, 64, 1}, dims_kv[3] = {64, SC_VALID, 2};
  const cuuint32_t box_a[3] = {64, 64, 1}, box_kv[3] = {64, SC_KT, 1};
  CUtensorMap ma, mk, mv;
  if (int err = make_tensor_map_bf16(&ma, a, 3, dims_a, strides, box_a))
    return err;
  if (int err = make_tensor_map_bf16(&mk, k, 3, dims_kv, strides, box_kv))
    return err;
  if (int err = make_tensor_map_bf16(&mv, v, 3, dims_kv, strides, box_kv))
    return err;
  constexpr int smem = 64 * 128 + 2 * SC_KT * 128 + 1024;
  cudaFuncSetAttribute(wgmma_selfcheck_keys_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_selfcheck_keys_kernel<<<1, 128, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      ma, mk, mv, static_cast<float*>(d1), static_cast<float*>(d2));
  return (int)cudaGetLastError();
}

// C entry: a contiguous (64, 64) bf16, b contiguous (192, 128) bf16; d1 =
// a b[:, 64:]^T (64, 192) and d2 = a b[32:64, 64:]^T (64, 32) fp32.  Returns
// 0, the tensor-map encoder's error, or cudaGetLastError().
extern "C" int cmve_wgmma_selfcheck_block(const void* a, const void* b,
                                          void* d1, void* d2, void* stream) {
  using namespace cmve;
  const cuuint64_t dims[2] = {128, 192}, strides[1] = {256};
  const cuuint32_t box[2] = {64, 192};
  CUtensorMap mb;
  if (int err = make_tensor_map_bf16(&mb, b, 2, dims, strides, box))
    return err;
  constexpr int smem = 64 * 128 + 192 * 128 + 1024;
  cudaFuncSetAttribute(wgmma_selfcheck_block_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_selfcheck_block_kernel<<<1, 128, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      mb, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(d1),
      static_cast<float*>(d2));
  return (int)cudaGetLastError();
}

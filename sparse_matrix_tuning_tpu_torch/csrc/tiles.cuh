// Tile constants and helpers shared by the attention kernels
// (attention.cu, K3; cached_attention.cu, K7): 64-row tiles, WMMA bf16
// fragments with fp32 accumulation, fp32 dot products, and the dynamic
// shared-memory opt-in.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int T64 = 64;          // rows per tile (queries or keys), bf16
constexpr int SLD = T64 + 4;     // fp32 64-wide tile pitch (floats)
constexpr int PLD = T64 + 8;     // bf16 64-wide tile pitch (elements)
constexpr int NT_BF16 = 128;     // 4 warps x 16 rows
constexpr int NT_F32 = 256;      // 4 threads per row
constexpr int F32_BK = 32;       // keys per tile (fp32 paths)

using namespace nvcuda;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// S_w (16 x 64) = A_w (16 x hd, cached fragments) . B^T, B rows = 64 keys in
// shared memory (pitch HD + 8); stored to st (pitch SLD) at the warp's rows.
template <int HD>
__device__ __forceinline__ void scores_16x64(float* st, const FragA* a, const bf16* bs) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int d = 0; d < HD / 16; ++d) {
      FragBc b;
      wmma::load_matrix_sync(b, bs + n * 16 * LD + d * 16, LD);
      wmma::mma_sync(c, a[d], b, c);
    }
    wmma::store_matrix_sync(st + n * 16, c, SLD, wmma::mem_row_major);
  }
}

// out[j] = a . b[j * stride .. +HD] over HD, for the N rows b, b + stride, ..
template <int N, int HD>
__device__ __forceinline__ void dots(float (&out)[N], const float* a, const float* b,
                                     int stride) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = 0.f;
  for (int d = 0; d < HD; ++d) {
    const float x = a[d];
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = fmaf(x, b[j * stride + d], out[j]);
  }
}

// Raise the dynamic shared-memory limit above 48 KB where needed; the
// launch is refused otherwise.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

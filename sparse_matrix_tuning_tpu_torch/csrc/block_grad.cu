// K1 block_grad: the selected-block weight gradient of SMT's sparse backward.
//
//   out[i][r][c] = sum_t g[t, rb[i]*256 + r] * x[t, cb[i]*256 + c]
//   g: (T, O), x: (T, I) row-major, bf16 or fp32; rb/cb: (n,) int32 on the
//   device; out: (n, 256, 256) fp32, the layout of plan.gather's blocks.
//
// Replaces the Pallas TPU kernel
//   sparse_matrix_tuning_tpu/ops/pallas/block_grad.py block_grad_weight_dyn
//   (_kernel), whose sequential grid zeroes the output block at
//   program_id(1) == 0 and accumulates over T tiles in VMEM.
//
// What bounds it on the H100: arithmetic (2*n*T*65536 FLOP for n*T*512
// bf16 input elements read, ~128 FLOP/byte per 64x64 tile pass) and the
// small grid (n is tens of blocks per linear). Design:
//   * CTAs run in parallel and in no order, so nothing carries over between
//     them: one CTA owns one (block i, 64x64 output tile) pair, n*16 CTAs,
//     and loops over all of T itself, accumulating in registers; it writes
//     its tile once. No atomics, so repeated coordinates are just two CTAs
//     reading the same panels.
//   * Each CTA reads rb[i]/cb[i] from device memory itself (the Pallas
//     kernel's scalar prefetch); no host sync, no per-step index upload.
//   * The ragged T edge is masked in the load (zero rows), instead of the
//     JAX wrapper's padded copies of g and x.
//   * bf16: tensor cores through WMMA 16x16x16 fragments, fp32 accumulate;
//     4 warps, each a 32x32 quarter of the tile. fp32: CUDA-core FMA, 256
//     threads each holding a 4x4 sub-tile. Both stage 16-byte vector loads
//     of the g and x panels in shared memory.
// Simple first: no cp.async/TMA pipelining, no wgmma, no split-T.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // SMT block edge
constexpr int TILE = 64;    // output tile edge owned by one CTA
constexpr int TK = 64;      // tokens staged per shared-memory pass (bf16)
constexpr int LDS = TILE + 8;  // padded shared row, in bf16 elements
constexpr int TK32 = 32;    // tokens staged per pass (fp32)

__global__ void __launch_bounds__(128)
block_grad_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                       const __nv_bfloat16* __restrict__ x,
                       const int* __restrict__ rb, const int* __restrict__ cb,
                       float* __restrict__ out, int T, int O, int I) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 gs[TK * LDS];
  __shared__ __align__(128) __nv_bfloat16 xs[TK * LDS];

  const int i = blockIdx.y;
  const int tr = blockIdx.x / (BLOCK / TILE);
  const int tc = blockIdx.x % (BLOCK / TILE);
  const int g_col0 = rb[i] * BLOCK + tr * TILE;
  const int x_col0 = cb[i] * BLOCK + tc * TILE;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32;  // warp's rows within the tile
  const int wc = (warp % 2) * 32;  // warp's cols within the tile

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.0f);

  constexpr int VEC_PER_ROW = TILE / 8;  // uint4 = 8 bf16
  for (int t0 = 0; t0 < T; t0 += TK) {
    for (int v = threadIdx.x; v < TK * VEC_PER_ROW; v += blockDim.x) {
      const int r = v / VEC_PER_ROW;
      const int c8 = (v % VEC_PER_ROW) * 8;
      const int t = t0 + r;
      uint4 gv = make_uint4(0u, 0u, 0u, 0u);
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if (t < T) {
        gv = *reinterpret_cast<const uint4*>(g + (size_t)t * O + g_col0 + c8);
        xv = *reinterpret_cast<const uint4*>(x + (size_t)t * I + x_col0 + c8);
      }
      *reinterpret_cast<uint4*>(&gs[r * LDS + c8]) = gv;
      *reinterpret_cast<uint4*>(&xs[r * LDS + c8]) = xv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; k += 16) {
      // A = g-panel^T: A(r, t) = gs[t][r], i.e. column-major with ld LDS
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[2];
      // B = x-panel: B(t, c) = xs[t][c], row-major with ld LDS
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(af[a], gs + k * LDS + wr + a * 16, LDS);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(bf[b], xs + k * LDS + wc + b * 16, LDS);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], af[a], bf[b], acc[a][b]);
    }
    __syncthreads();
  }

  float* o = out + (size_t)i * BLOCK * BLOCK + (size_t)(tr * TILE + wr) * BLOCK
             + tc * TILE + wc;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wmma::store_matrix_sync(o + a * 16 * BLOCK + b * 16, acc[a][b], BLOCK,
                              wmma::mem_row_major);
}

__global__ void __launch_bounds__(256)
block_grad_f32_kernel(const float* __restrict__ g, const float* __restrict__ x,
                      const int* __restrict__ rb, const int* __restrict__ cb,
                      float* __restrict__ out, int T, int O, int I) {
  __shared__ __align__(16) float gs[TK32][TILE];
  __shared__ __align__(16) float xs[TK32][TILE];

  const int i = blockIdx.y;
  const int tr = blockIdx.x / (BLOCK / TILE);
  const int tc = blockIdx.x % (BLOCK / TILE);
  const int g_col0 = rb[i] * BLOCK + tr * TILE;
  const int x_col0 = cb[i] * BLOCK + tc * TILE;
  const int tx = threadIdx.x % 16;  // 4 output columns: tx*4 ..
  const int ty = threadIdx.x / 16;  // 4 output rows:    ty*4 ..

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  constexpr int VEC_PER_ROW = TILE / 4;  // float4
  for (int t0 = 0; t0 < T; t0 += TK32) {
    for (int v = threadIdx.x; v < TK32 * VEC_PER_ROW; v += blockDim.x) {
      const int r = v / VEC_PER_ROW;
      const int c4 = (v % VEC_PER_ROW) * 4;
      const int t = t0 + r;
      float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) {
        gv = *reinterpret_cast<const float4*>(g + (size_t)t * O + g_col0 + c4);
        xv = *reinterpret_cast<const float4*>(x + (size_t)t * I + x_col0 + c4);
      }
      *reinterpret_cast<float4*>(&gs[r][c4]) = gv;
      *reinterpret_cast<float4*>(&xs[r][c4]) = xv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TK32; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&gs[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&xs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
    }
    __syncthreads();
  }

  float* o = out + (size_t)i * BLOCK * BLOCK + (size_t)(tr * TILE + ty * 4) * BLOCK
             + tc * TILE + tx * 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(o + (size_t)a * BLOCK) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int smt_block_grad(const void* g, const void* x, const void* rb,
                              const void* cb, void* out, int T, int O, int I,
                              int n, int dtype, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const dim3 grid((BLOCK / TILE) * (BLOCK / TILE), n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    block_grad_bf16_kernel<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(x),
        static_cast<const int*>(rb), static_cast<const int*>(cb),
        static_cast<float*>(out), T, O, I);
  } else if (dtype == 0) {
    block_grad_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<const int*>(rb), static_cast<const int*>(cb),
        static_cast<float*>(out), T, O, I);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

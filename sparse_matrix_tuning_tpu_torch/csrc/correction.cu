// K5 block_correction: the exact selected-block correction on top of the
// int8 base matmul, in place.
//
//   out[:, o_j*256 : +256] += src[:, i_j*256 : +256] @ D_j      j = 0..n-1
//   D_j = delta[j] (transpose == 0) or delta[j]^T (transpose == 1)
//   out (T, O), src (T, I) row-major, bf16 or fp32; delta (n, 256, 256) in
//   src's type; fp32 accumulation, ONE rounding per touched out tile.
//
// Replaces the Pallas TPU kernel
//   sparse_matrix_tuning_tpu/ops/pallas/correction.py block_correction_dyn
//   (_kernel), whose sequential grid keeps an out block in VMEM across a
//   run of equal o ("first of a run" test, write-back every step).
//
// What bounds it on the H100: operations at the main path's n (2*n*T*65536
// FLOP for the touched out tiles read and written, the source panels and
// delta), on a small grid. Design:
//   * CTAs run in no order, so a run of equal o cannot be carried from one
//     grid step to the next. The wrapper groups the coordinates by o (CSR:
//     run_o, run_start, run_j) and ONE CTA owns a (T tile, out block,
//     64-column quarter): it seeds an fp32 accumulator from its out tile,
//     loops over its run's j itself, and writes the tile once. Out tiles of
//     different CTAs never overlap: no atomics.
//   * delta is indexed through run_j, so the sorted order needs no permuted
//     copy of it, and the transpose flag picks the WMMA B-fragment layout
//     (or the FMA index), so delta^T is never materialised.
//   * Ragged T is masked (zero rows on load, no write), not padded.
//   * bf16: WMMA 16x16x16, fp32 accumulate, 8 warps each a 32 x 32 part of a
//     128 x 64 tile; the opaque accumulator is seeded and drained through a
//     per-warp fp32 patch in shared memory. fp32: CUDA-core FMA, 256 threads
//     each a 4 x 4 part of a 64 x 64 tile.
// Simple first: no cp.async/TMA pipelining, no wgmma, not fused into K4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;   // SMT block edge
constexpr int QN = 64;       // out columns per CTA (a quarter block)
constexpr int NT = 256;

// ---- bf16 -----------------------------------------------------------------
constexpr int TM16 = 128;         // tokens per CTA
constexpr int KC16 = 64;          // contraction elements per pass
constexpr int LD16 = KC16 + 8;    // shared pitch (elements) of all three tiles

template <bool TRANS>
__global__ void __launch_bounds__(NT)
correction_bf16_kernel(__nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ src,
                       const __nv_bfloat16* __restrict__ delta,
                       const int* __restrict__ run_o, const int* __restrict__ run_start,
                       const int* __restrict__ run_j, const int* __restrict__ idx_in,
                       int T, int O, int I) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 ss[TM16 * LD16];  // src tile [t][k]
  __shared__ __align__(128) __nv_bfloat16 ds[QN * LD16];    // D tile: [k][c], TRANS: [c][k]
  __shared__ __align__(128) float patch[NT / 32][16 * 16];  // per-warp fp32 staging

  const int run = blockIdx.x / (BLOCK / QN);
  const int quarter = blockIdx.x % (BLOCK / QN);
  const int t0 = blockIdx.y * TM16;
  const int out_col0 = run_o[run] * BLOCK + quarter * QN;
  const int j_begin = run_start[run], j_end = run_start[run + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32;   // warp's rows within the tile
  const int wn = (warp % 2) * 32;   // warp's columns within the quarter
  float* my = patch[warp];
  const int pr = lane / 2, pc = (lane % 2) * 8;  // lane's 8 elements of a 16 x 16 patch

  // seed the accumulators from the out tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int t = t0 + wm + a * 16 + pr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < T)
        v = *reinterpret_cast<const uint4*>(out + (size_t)t * O + out_col0 + wn + b * 16 + pc);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) my[pr * 16 + pc + i] = __bfloat162float(e[i]);
      __syncwarp();
      wmma::load_matrix_sync(acc[a][b], my, 16, wmma::mem_row_major);
      __syncwarp();
    }

  for (int jj = j_begin; jj < j_end; ++jj) {
    const int j = run_j[jj];
    const int src_col0 = idx_in[j] * BLOCK;
    const __nv_bfloat16* dj = delta + (size_t)j * BLOCK * BLOCK;
    for (int k0 = 0; k0 < BLOCK; k0 += KC16) {
      // src tile: 128 rows x 64 elements = 1024 16-byte vectors
      for (int v = threadIdx.x; v < TM16 * (KC16 / 8); v += NT) {
        const int r = v / (KC16 / 8), c8 = (v % (KC16 / 8)) * 8;
        const int t = t0 + r;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (t < T) x = *reinterpret_cast<const uint4*>(src + (size_t)t * I + src_col0 + k0 + c8);
        *reinterpret_cast<uint4*>(&ss[r * LD16 + c8]) = x;
      }
      // D tile, copied as it lies in delta[j]: rows k (or, TRANS, rows c)
      for (int v = threadIdx.x; v < QN * (KC16 / 8); v += NT) {
        const int r = v / (KC16 / 8), c8 = (v % (KC16 / 8)) * 8;
        const __nv_bfloat16* p = TRANS
            ? dj + (size_t)(quarter * QN + r) * BLOCK + k0 + c8   // delta[c][k]
            : dj + (size_t)(k0 + r) * BLOCK + quarter * QN + c8;  // delta[k][c]
        *reinterpret_cast<uint4*>(&ds[r * LD16 + c8]) = *reinterpret_cast<const uint4*>(p);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC16; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
          wmma::load_matrix_sync(af[a], ss + (wm + a * 16) * LD16 + k, LD16);
        if (TRANS) {
          // B(k, c) = delta[c][k] = ds[c][k]: column-major with pitch LD16
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[2];
#pragma unroll
          for (int b = 0; b < 2; ++b)
            wmma::load_matrix_sync(bf[b], ds + (wn + b * 16) * LD16 + k, LD16);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], af[a], bf[b], acc[a][b]);
        } else {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
          for (int b = 0; b < 2; ++b)
            wmma::load_matrix_sync(bf[b], ds + k * LD16 + wn + b * 16, LD16);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], af[a], bf[b], acc[a][b]);
        }
      }
      __syncthreads();
    }
  }

  // one rounding, one write of the tile
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wmma::store_matrix_sync(my, acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      const int t = t0 + wm + a * 16 + pr;
      if (t < T) {
        uint4 v;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(my[pr * 16 + pc + i]);
        *reinterpret_cast<uint4*>(out + (size_t)t * O + out_col0 + wn + b * 16 + pc) = v;
      }
      __syncwarp();
    }
}

// ---- fp32 -----------------------------------------------------------------
constexpr int TM32 = 64;          // tokens per CTA
constexpr int KC32 = 32;          // contraction elements per pass
constexpr int LDP = KC32 + 1;     // odd pitch for the tiles read down a column

template <bool TRANS>
__global__ void __launch_bounds__(NT)
correction_f32_kernel(float* __restrict__ out, const float* __restrict__ src,
                      const float* __restrict__ delta, const int* __restrict__ run_o,
                      const int* __restrict__ run_start, const int* __restrict__ run_j,
                      const int* __restrict__ idx_in, int T, int O, int I) {
  __shared__ float ss[TM32 * LDP];                       // src tile [t][k]
  __shared__ float ds[TRANS ? QN * LDP : KC32 * QN];     // D tile: [k][c], TRANS: [c][k]

  const int run = blockIdx.x / (BLOCK / QN);
  const int quarter = blockIdx.x % (BLOCK / QN);
  const int t0 = blockIdx.y * TM32;
  const int out_col0 = run_o[run] * BLOCK + quarter * QN;
  const int j_begin = run_start[run], j_end = run_start[run + 1];
  const int tx = threadIdx.x % 16;  // 4 out columns: tx*4 ..
  const int ty = threadIdx.x / 16;  // 4 tokens:      ty*4 ..

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + ty * 4 + a;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) v = *reinterpret_cast<const float4*>(out + (size_t)t * O + out_col0 + tx * 4);
    acc[a][0] = v.x; acc[a][1] = v.y; acc[a][2] = v.z; acc[a][3] = v.w;
  }

  for (int jj = j_begin; jj < j_end; ++jj) {
    const int j = run_j[jj];
    const int src_col0 = idx_in[j] * BLOCK;
    const float* dj = delta + (size_t)j * BLOCK * BLOCK;
    for (int k0 = 0; k0 < BLOCK; k0 += KC32) {
      for (int v = threadIdx.x; v < TM32 * KC32; v += NT) {
        const int r = v / KC32, c = v % KC32;
        const int t = t0 + r;
        ss[r * LDP + c] = t < T ? src[(size_t)t * I + src_col0 + k0 + c] : 0.f;
      }
      if (TRANS) {
        for (int v = threadIdx.x; v < QN * KC32; v += NT) {
          const int r = v / KC32, c = v % KC32;   // delta[c = quarter*64 + r][k0 + c]
          ds[r * LDP + c] = dj[(size_t)(quarter * QN + r) * BLOCK + k0 + c];
        }
      } else {
        for (int v = threadIdx.x; v < KC32 * QN; v += NT) {
          const int r = v / QN, c = v % QN;       // delta[k0 + r][quarter*64 + c]
          ds[r * QN + c] = dj[(size_t)(k0 + r) * BLOCK + quarter * QN + c];
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC32; ++k) {
        float ar[4], br[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ar[a] = ss[(ty * 4 + a) * LDP + k];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          br[b] = TRANS ? ds[(tx * 4 + b) * LDP + k] : ds[k * QN + tx * 4 + b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ar[a], br[b], acc[a][b]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = t0 + ty * 4 + a;
    if (t < T)
      *reinterpret_cast<float4*>(out + (size_t)t * O + out_col0 + tx * 4) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. run_o (R,), run_start (R + 1,), run_j (n,),
// idx_in (n,): int32 on the device. Returns cudaGetLastError() after the
// launch.
extern "C" int smt_block_correction(void* out, const void* src, const void* delta,
                                    const void* run_o, const void* run_start,
                                    const void* run_j, const void* idx_in, int T, int O,
                                    int I, int R, int transpose, int dtype, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ro = static_cast<const int*>(run_o);
  const int* rs = static_cast<const int*>(run_start);
  const int* rj = static_cast<const int*>(run_j);
  const int* ii = static_cast<const int*>(idx_in);
  if (dtype == 1) {
    const dim3 grid(R * (BLOCK / QN), (T + TM16 - 1) / TM16);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(src);
    const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(delta);
    if (transpose)
      correction_bf16_kernel<true><<<grid, NT, 0, s>>>(o, x, d, ro, rs, rj, ii, T, O, I);
    else
      correction_bf16_kernel<false><<<grid, NT, 0, s>>>(o, x, d, ro, rs, rj, ii, T, O, I);
  } else if (dtype == 0) {
    const dim3 grid(R * (BLOCK / QN), (T + TM32 - 1) / TM32);
    float* o = static_cast<float*>(out);
    const float* x = static_cast<const float*>(src);
    const float* d = static_cast<const float*>(delta);
    if (transpose)
      correction_f32_kernel<true><<<grid, NT, 0, s>>>(o, x, d, ro, rs, rj, ii, T, O, I);
    else
      correction_f32_kernel<false><<<grid, NT, 0, s>>>(o, x, d, ro, rs, rj, ii, T, O, I);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

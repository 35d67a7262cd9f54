// K5 block_correction: the exact selected-block correction on top of the
// int8 base matmul, in place.
//
//   out[:, o_j*256 : +256] += src[:, i_j*256 : +256] @ D_j      j = 0..n-1
//   D_j = delta[j] (transpose == 0) or delta[j]^T (transpose == 1)
//   out (T, O), src (T, I) row-major, bf16, fp16 or fp32; delta (n, 256, 256) in
//   src's type; fp32 accumulation, ONE rounding per touched out tile.
//
// Replaces the Pallas TPU kernel
//   sparse_matrix_tuning_tpu/ops/pallas/correction.py block_correction_dyn
//   (_kernel), whose sequential grid keeps an out block in VMEM across a
//   run of equal o ("first of a run" test, write-back every step).
//
// What bounds it on the H100: bytes (the touched out tiles read and
// written, the source panels and delta read once: ~64 FLOP a byte at the
// main path's shapes, under the bf16 tensor cores' ~295). Design:
//   * CTAs run in no order, so a run of equal o cannot be carried from one
//     grid step to the next. The wrapper groups the coordinates by o (CSR:
//     run_o, run_start, run_j; the longest runs first, so that their CTAs,
//     which take longest, start first) and ONE CTA owns (run, a tile of
//     token rows, a range of the out block's columns): it seeds its fp32
//     accumulators from its out tile, loops over its run's j itself,
//     rounds once and writes the tile once. Out tiles of different CTAs
//     never overlap: no atomics. The out tile comes in and goes out by TMA
//     (128-byte-swizzled 64 x 64 boxes in shared memory, read and written
//     in the accumulators' layout without bank conflicts); rows past T
//     arrive as zeros and are not stored.
//   * bf16: wgmma.mma_async m64nNk16 f32.bf16.bf16, one consumer warpgroup
//     per 64 rows, accumulators in registers. One producer thread keeps TMA
//     loads (128-byte swizzle, zeros past T: ragged T needs no load mask)
//     in flight over a ring of stages (j in run order, 64-element
//     contraction chunk), each with a "full" mbarrier (transaction bytes)
//     and an "empty" one (released by each consumer warpgroup once its
//     wgmma has read the stage; one group of wgmma stays in flight while
//     the next stage is waited for). A is the src panel, K-major as it lies.
//     delta is read through a 2-D map over (n * 256, 256) at row
//     run_j[jj] * 256 + (c or k), so the sorted order needs no permuted copy
//     of it: the forward's B(k, c) = delta[c][k] is K-major, grad_input's
//     B(k, c) = delta[k][c] N-major, and bf16 wgmma takes both through the
//     descriptor's transpose bit (delta^T is never materialised).
//   * The launch plan comes from the wrapper (ops/cuda/correction.py plan):
//     128 x 256 tiles when the runs times the 128-row tiles fill the SMs,
//     64-row tiles below that, and the 256 columns split over 2 or 4 CTAs
//     where even the 64-row tiles leave most SMs idle (decode rows), so
//     delta streams through more SMs.
//   * fp16 (--dtype fp16 over the int8 base): the bf16 design with wgmma
//     ... f32.f16.f16, FLOAT16 TMA maps and fp16 conversions of the out tile
//     (one template, F16), at the bf16 tile plans; the one rounding of a
//     tile is round to nearest even and overflows to inf, as the plain
//     version's cast does.
//   * fp32 (--dtype fp32 runs only): CUDA-core FMA, 256 threads each a 4 x 4
//     part of a 64 x 64 tile, synchronous loads; rows past T masked.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK = 256;   // SMT block edge

// ---- bf16 and fp16 ----------------------------------------------------------
constexpr int KC = 64;                     // contraction elements per stage: one swizzle row
constexpr int BOX = 64 * KC * 2;           // one 64 x 64 16-bit TMA box, 8 KB
constexpr int SMEM_BUDGET = 220 * 1024;    // the ring
constexpr int SMEM_SLACK = 1024 + 256;     // 1024-byte alignment of the tiles, the mbarriers

template <int NWG, int BN>
struct Cfg {
  static constexpr int BM = 64 * NWG;      // token rows per CTA
  static constexpr int NC = 128 * NWG;     // consumer threads
  static constexpr int O_BYTES = BM * BN * 2;  // the out tile: (BM / 64) x (BN / 64) boxes
  static constexpr int A_BYTES = BM * KC * 2;
  static constexpr int B_BYTES = BN * KC * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT = (SMEM_BUDGET - O_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = O_BYTES + STAGES * STAGE + SMEM_SLACK;
  static_assert(STAGES >= 3, "the ring needs at least 3 stages");
};

// two 16-bit values of the out tile <-> fp32 (F16: fp16, else bf16); the
// store rounds to nearest even, overflowing to inf
template <bool F16>
__device__ __forceinline__ float2 load2(const uint8_t* p) {
  if constexpr (F16) return __half22float2(*reinterpret_cast<const __half2*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <bool F16>
__device__ __forceinline__ void store2(uint8_t* p, float a, float b) {
  if constexpr (F16)
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid R * tiles_m * (256 / BN): CTA b takes column range b % (256 / BN),
// row tile (b / (256 / BN)) % tiles_m of run b / ((256 / BN) * tiles_m);
// F16: fp16 out, src and delta, else bf16
template <int NWG, int BN, bool TRANS, bool F16>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
correction_wgmma_kernel(const __grid_constant__ CUtensorMap tmS,
                        const __grid_constant__ CUtensorMap tmD,
                        const __grid_constant__ CUtensorMap tmO,
                        const int* __restrict__ run_o, const int* __restrict__ run_start,
                        const int* __restrict__ run_j, const int* __restrict__ idx_in, int T) {
  using C = Cfg<NWG, BN>;
  constexpr int BM = C::BM, STAGES = C::STAGES, NCS = BLOCK / BN, R = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem_1024(smem_raw);
  uint8_t* sO = smem;  // box (w, q): rows 64 w.., columns 64 q.. of the tile
  uint8_t* sA = sO + C::O_BYTES;
  uint8_t* sB = sA + STAGES * C::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + STAGES * C::B_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* o_full = empty + STAGES;

  const int tiles_m = (T + BM - 1) / BM;
  const int cs = blockIdx.x % NCS;
  const int tm = (blockIdx.x / NCS) % tiles_m;
  const int run = blockIdx.x / (NCS * tiles_m);
  const int j_begin = run_start[run], j_end = run_start[run + 1];
  const int t0 = tm * BM, c0 = cs * BN;
  const int o_col = run_o[run] * BLOCK + c0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_init(o_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every load
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // the out tile first (zeros past T): it seeds the accumulators
      mbar_expect_tx(o_full, C::O_BYTES);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          tma_load_2d(sO + (w * (BN / 64) + q) * BOX, &tmO, o_full, o_col + 64 * q, t0 + 64 * w);
      int stage = 0;
      uint32_t phase = 0;
      for (int jj = j_begin; jj < j_end; ++jj) {
        const int j = run_j[jj];
        const int src_col = idx_in[j] * BLOCK;
        for (int kc = 0; kc < BLOCK; kc += KC) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], C::STAGE);
          uint8_t* a = sA + stage * C::A_BYTES;
          uint8_t* b = sB + stage * C::B_BYTES;
#pragma unroll
          for (int w = 0; w < NWG; ++w)
            tma_load_2d(a + w * BOX, &tmS, &full[stage], src_col + kc, t0 + 64 * w);
#pragma unroll
          for (int q = 0; q < BN / 64; ++q) {
            if (TRANS)  // rows c of delta[j], elements k: B(k, c) K-major
              tma_load_2d(b + q * BOX, &tmD, &full[stage], kc, j * BLOCK + c0 + 64 * q);
            else        // rows k of delta[j], elements c: B(k, c) N-major
              tma_load_2d(b + q * BOX, &tmD, &full[stage], c0 + 64 * q, j * BLOCK + kc);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups
  if constexpr (NWG == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128;
  const int cwg = ct / 128;
  const int warp = (ct % 128) / 32, lane = ct % 32;
  // accumulator register 4j + 2h + e: row 16 warp + lane/4 + 8h of the
  // warpgroup's 64, column 8j + 2 (lane % 4) + e; its place in the out
  // tile's swizzled boxes (a warp's 8 rows hit 8 different 16-byte chunks:
  // no bank conflicts)
  uint8_t* o_tile = sO + cwg * (BN / 64) * BOX;
  auto o_at = [&](int j, int h) {
    return o_tile + (j / 8) * BOX +
           sw128(warp * 16 + lane / 4 + 8 * h, (j % 8) * 16 + 4 * (lane % 4));
  };

  // seed the accumulators from the out tile
  float acc[R];
  mbar_wait(o_full, 0);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = load2<F16>(o_at(j, h));
      acc[4 * j + 2 * h] = v.x;
      acc[4 * j + 2 * h + 1] = v.y;
    }
  fence_acc(acc);

  const int n_stages = (j_end - j_begin) * (BLOCK / KC);
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int it = 0; it < n_stages; ++it) {
    mbar_wait(&full[stage], phase);
    const uint64_t da = gmma_desc(sA + stage * C::A_BYTES + cwg * BOX, 16, 1024);
    const uint64_t db = gmma_desc(sB + stage * C::B_BYTES, TRANS ? 16 : BOX, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {  // A: +32 bytes a k16; B: +32 bytes, or +16 rows
      if constexpr (F16)
        wgmma_f16<BN, 0, TRANS ? 0 : 1>(acc, da + 2 * kk, db + (TRANS ? 2 : 128) * kk);
      else
        wgmma_bf16<BN, 0, TRANS ? 0 : 1>(acc, da + 2 * kk, db + (TRANS ? 2 : 128) * kk);
    }
    wgmma_commit();
    // one group stays in flight while the next stage is waited for; the
    // stage before is then read and released
    wgmma_wait<1>();
    fence_acc(acc);
    if (prev >= 0 && ct % 128 == 0) mbar_arrive(&empty[prev]);
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // one rounding, into the tile's own place in shared memory, then one TMA
  // store of the tile (rows past T are not written)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2<F16>(o_at(j, h), acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  fence_proxy_async_smem();
  named_sync(1, C::NC);
  if (ct == 0) {
#pragma unroll
    for (int w = 0; w < NWG; ++w)
#pragma unroll
      for (int q = 0; q < BN / 64; ++q)
        tma_store_2d(&tmO, sO + (w * (BN / 64) + q) * BOX, o_col + 64 * q, t0 + 64 * w);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int NWG, int BN, bool TRANS, bool F16>
int launch_half(const CUtensorMap& ms, const CUtensorMap& md, const CUtensorMap& mo,
                const int* ro, const int* rs, const int* rj, const int* ii, int T, int R,
                cudaStream_t s) {
  using C = Cfg<NWG, BN>;
  auto kern = correction_wgmma_kernel<NWG, BN, TRANS, F16>;
  static bool smem_set[64] = {};
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), C::SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  const int grid = R * ((T + C::BM - 1) / C::BM) * (BLOCK / BN);
  kern<<<grid, (NWG + 1) * 128, C::SMEM, s>>>(ms, md, mo, ro, rs, rj, ii, T);
  return (int)cudaGetLastError();
}

template <bool TRANS, bool F16>
int launch_plan(const CUtensorMap& ms, const CUtensorMap& md, const CUtensorMap& mo,
                const int* ro, const int* rs, const int* rj, const int* ii, int T, int R, int bm,
                int bn, cudaStream_t s) {
  if (bm == 128 && bn == 256)
    return launch_half<2, 256, TRANS, F16>(ms, md, mo, ro, rs, rj, ii, T, R, s);
  if (bm == 64 && bn == 256)
    return launch_half<1, 256, TRANS, F16>(ms, md, mo, ro, rs, rj, ii, T, R, s);
  if (bm == 64 && bn == 128)
    return launch_half<1, 128, TRANS, F16>(ms, md, mo, ro, rs, rj, ii, T, R, s);
  if (bm == 64 && bn == 64)
    return launch_half<1, 64, TRANS, F16>(ms, md, mo, ro, rs, rj, ii, T, R, s);
  return (int)cudaErrorInvalidValue;
}

// ---- fp32 -----------------------------------------------------------------
constexpr int QN = 64;            // out columns per CTA (a quarter block)
constexpr int NT = 256;
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

// dtype: 0 = fp32, 1 = bf16, 2 = fp16. run_o (R,), run_start (R + 1,), run_j (n,),
// idx_in (n,): int32 on the device. bf16 / fp16: bm x bn tiles (the wrapper's
// plan: 128 x 256, or 64 x 256 / 128 / 64); fp32 ignores them. Returns
// cudaGetLastError() after the launch.
extern "C" int smt_block_correction(void* out, const void* src, const void* delta,
                                    const void* run_o, const void* run_start,
                                    const void* run_j, const void* idx_in, int T, int O,
                                    int I, int R, int n, int transpose, int dtype, int bm,
                                    int bn, void* stream) {
  if (R <= 0 || T <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ro = static_cast<const int*>(run_o);
  const int* rs = static_cast<const int*>(run_start);
  const int* rj = static_cast<const int*>(run_j);
  const int* ii = static_cast<const int*>(idx_in);
  if (dtype == 1 || dtype == 2) {
    CUtensorMap ms, md, mo;
    const CUtensorMapDataType dt =
        dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (n <= 0 || !make_map(&ms, dt, 2, src, I, T, 64, 64) ||
        !make_map(&md, dt, 2, delta, BLOCK, n * BLOCK, 64, 64) ||
        !make_map(&mo, dt, 2, out, O, T, 64, 64))
      return (int)cudaErrorInvalidValue;
    if (dtype == 2)
      return transpose ? launch_plan<true, true>(ms, md, mo, ro, rs, rj, ii, T, R, bm, bn, s)
                       : launch_plan<false, true>(ms, md, mo, ro, rs, rj, ii, T, R, bm, bn, s);
    return transpose ? launch_plan<true, false>(ms, md, mo, ro, rs, rj, ii, T, R, bm, bn, s)
                     : launch_plan<false, false>(ms, md, mo, ro, rs, rj, ii, T, R, bm, bn, s);
  }
  if (dtype == 0) {
    const dim3 grid(R * (BLOCK / QN), (T + TM32 - 1) / TM32);
    float* o = static_cast<float*>(out);
    const float* x = static_cast<const float*>(src);
    const float* d = static_cast<const float*>(delta);
    if (transpose)
      correction_f32_kernel<true><<<grid, NT, 0, s>>>(o, x, d, ro, rs, rj, ii, T, O, I);
    else
      correction_f32_kernel<false><<<grid, NT, 0, s>>>(o, x, d, ro, rs, rj, ii, T, O, I);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

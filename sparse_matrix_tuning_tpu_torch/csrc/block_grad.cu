// K1 block_grad: the selected-block weight gradient of SMT's sparse backward.
//
//   out[i][r][c] = sum_t g[t, rb[i]*256 + r] * x[t, cb[i]*256 + c]
//   g: (T, O), x: (T, I) row-major, bf16, fp16 or fp32; rb/cb: (n,) int32 on the
//   device; out: (n, 256, 256) fp32, the layout of plan.gather's blocks.
//
// Replaces the Pallas TPU kernel
//   sparse_matrix_tuning_tpu/ops/pallas/block_grad.py block_grad_weight_dyn
//   (_kernel), whose sequential grid zeroes the output block at
//   program_id(1) == 0 and accumulates over T tiles in VMEM.
//
// What bounds it on the H100: bytes at small n (the selected row and
// column panels of g and x read once, the fp32 blocks written: ~200 FLOP a
// byte at n 24, under the bf16 tensor cores' ~295), operations at large n
// (140 blocks of one panel pair); and a grid that the main path's small n
// (a median of 4 blocks a linear) leaves short of the 132 SMs. Design:
//   * bf16: one CTA owns (block i, 64 or 128 of its rows, a split of T): a
//     64 x 256 or 128 x 256 fp32 tile in one or two consumer warpgroups of
//     wgmma.mma_async m64n256k16 f32.bf16.bf16, accumulators in registers.
//     A CTA's products, not its loads, set its pace: the 64-row tiles
//     spread a block over four SMs and win while they fit one wave; past
//     that the 128-row tiles, whose two warpgroups keep an SM's tensor
//     cores busier, win (timed on the card, PERF.md; the wrapper's plan).
//     The contraction runs down the rows of g and x, so both operands are
//     MN-major as they lie: A = g panel^T (M-major) and B = x panel
//     (N-major), read from 128-byte-swizzled 64 x 64 TMA boxes through the
//     descriptors' transpose bits; nothing is transposed, in memory or in
//     registers.
//   * One producer thread keeps TMA loads in flight over a ring of 64-token
//     stages ("full" mbarrier with transaction bytes, "empty" released by
//     each consumer warpgroup once its wgmma has read the stage; one group
//     of wgmma stays in flight while the next stage is waited for); it reads
//     rb[i] / cb[i] from device memory itself (the Pallas kernel's scalar
//     prefetch), so there is no host sync. Rows past T arrive as zeros (no
//     padded copies, no masks).
//   * Split T: at small n the (block, rows) tiles leave SMs idle, so the
//     wrapper's plan (ops/cuda/block_grad.py) splits the 64-token chunks
//     over 2 or 4 CTAs. Each split writes its fp32 partial to a workspace
//     (thread-major, coalesced), and the last CTA of a tile to arrive (a
//     per-tile counter, which it resets for the next launch) adds the
//     partials in split order 0, 1, ... and writes the block: one launch,
//     no atomics on the data, the same bits from every launch.
//   * fp16 (--dtype fp16): the bf16 design with wgmma ... f32.f16.f16 and
//     TMA maps of CU_TENSOR_MAP_DATA_TYPE_FLOAT16 (one template, F16), at
//     the same plans; fp32 accumulation. A NaN or inf in g or x reaches the
//     blocks whose panels hold it, as in the plain version.
//   * fp32 (--dtype fp32 runs only): CUDA-core FMA, 256 threads each holding
//     a 4x4 part of a 64x64 tile, 16-byte vector loads staged in shared
//     memory, every CTA looping over all of T.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BLOCK = 256;  // SMT block edge

// ---- bf16 and fp16 ----------------------------------------------------------
constexpr int TK = 64;                   // tokens per stage, and per unit of a T split
constexpr int BOX = 64 * TK * 2;         // one 64-column x 64-token 16-bit TMA box, 8 KB
constexpr int SMEM_BUDGET = 220 * 1024;  // the ring
constexpr int SMEM_SLACK = 1024 + 256;   // 1024-byte alignment of the tiles, the mbarriers

template <int NWG>
struct Cfg {
  static constexpr int BM = 64 * NWG;           // rows of the block per CTA
  static constexpr int NC = 128 * NWG;          // consumer threads
  static constexpr int A_BYTES = BM * TK * 2;   // g: NWG boxes of 64 rows x 64 tokens
  static constexpr int B_BYTES = BLOCK * TK * 2;  // x: 4 boxes of 64 columns x 64 tokens
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT = SMEM_BUDGET / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = STAGES * STAGE + SMEM_SLACK;
  static_assert(STAGES >= 3, "the ring needs at least 3 stages");
};

// grid n * (256 / BM) * splits: CTA b takes split b % splits of tile
// b / splits = (block i, row part h); F16: fp16 operands, else bf16
template <int NWG, bool F16>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
block_grad_wgmma_kernel(const __grid_constant__ CUtensorMap tmG,
                        const __grid_constant__ CUtensorMap tmX, const int* __restrict__ rb,
                        const int* __restrict__ cb, float* __restrict__ out,
                        float* __restrict__ ws, unsigned* __restrict__ counters, int T,
                        int splits) {
  using C = Cfg<NWG>;
  constexpr int BM = C::BM, NC = C::NC, STAGES = C::STAGES, PARTS = BLOCK / BM;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* smem = align_smem_1024(smem_raw);
  uint8_t* sA = smem;
  uint8_t* sB = sA + STAGES * C::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + STAGES * C::B_BYTES);
  uint64_t* empty = full + STAGES;

  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int i = tile / PARTS, part = tile % PARTS;
  const int chunks = (T + TK - 1) / TK;
  const int c_begin = (int)((long long)split * chunks / splits);
  const int c_end = (int)((long long)(split + 1) * chunks / splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every load
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int g_col = rb[i] * BLOCK + part * BM;
      const int x_col = cb[i] * BLOCK;
      int stage = 0;
      uint32_t phase = 0;
      for (int c = c_begin; c < c_end; ++c) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], C::STAGE);
#pragma unroll
        for (int w = 0; w < NWG; ++w)
          tma_load_2d(sA + stage * C::A_BYTES + w * BOX, &tmG, &full[stage], g_col + 64 * w,
                      c * TK);
#pragma unroll
        for (int q = 0; q < BLOCK / 64; ++q)
          tma_load_2d(sB + stage * C::B_BYTES + q * BOX, &tmX, &full[stage], x_col + 64 * q,
                      c * TK);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
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
  float acc[128];
#pragma unroll
  for (int r = 0; r < 128; ++r) acc[r] = 0.f;
  fence_acc(acc);
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int c = c_begin; c < c_end; ++c) {
    mbar_wait(&full[stage], phase);
    // A = g^T: M-major, one 64-row box; B = x: N-major, 4 boxes of 64 columns
    // BOX bytes apart; 8-token groups 1024 bytes apart in both
    const uint64_t da = gmma_desc(sA + stage * C::A_BYTES + cwg * BOX, BOX, 1024);
    const uint64_t db = gmma_desc(sB + stage * C::B_BYTES, BOX, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {  // 16 tokens: 16 rows of 128 bytes, 2048 bytes
      if constexpr (F16)
        wgmma_f16<256, 1, 1>(acc, da + 128 * kk, db + 128 * kk);
      else
        wgmma_bf16<256, 1, 1>(acc, da + 128 * kk, db + 128 * kk);
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

  if (splits > 1) {
    // each thread's 128 accumulators as 32 float4, thread-major: the partial
    // of (split, tile) is written and read in coalesced 16-byte vectors
    const int tiles = gridDim.x / splits;
    float4* mine = reinterpret_cast<float4*>(ws) + ((size_t)split * tiles + tile) * 32 * NC;
#pragma unroll
    for (int r4 = 0; r4 < 32; ++r4)
      mine[(size_t)r4 * NC + ct] =
          make_float4(acc[4 * r4], acc[4 * r4 + 1], acc[4 * r4 + 2], acc[4 * r4 + 3]);
    __threadfence();
    named_sync(1, NC);
    if (ct == 0) s_last = atomicAdd(&counters[tile], 1u) == (unsigned)(splits - 1);
    named_sync(1, NC);
    if (!s_last) return;
    __threadfence();
    // the last split to arrive sums every split's partial in split order
    for (int s = 0; s < splits; ++s) {
      const float4* src = reinterpret_cast<const float4*>(ws) + ((size_t)s * tiles + tile) * 32 * NC;
#pragma unroll
      for (int r4 = 0; r4 < 32; ++r4) {
        const float4 w = __ldcg(src + (size_t)r4 * NC + ct);
        if (s == 0) {
          acc[4 * r4] = w.x;
          acc[4 * r4 + 1] = w.y;
          acc[4 * r4 + 2] = w.z;
          acc[4 * r4 + 3] = w.w;
        } else {
          acc[4 * r4] += w.x;
          acc[4 * r4 + 1] += w.y;
          acc[4 * r4 + 2] += w.z;
          acc[4 * r4 + 3] += w.w;
        }
      }
    }
    if (ct == 0) counters[tile] = 0;  // every split has arrived: ready for the next launch
  }

  // accumulator register 4j + 2h + e: row 16 warp + lane/4 + 8h of the
  // warpgroup's 64, column 8j + 2 (lane % 4) + e
  float* o = out + (size_t)i * BLOCK * BLOCK +
             (size_t)(part * BM + cwg * 64 + warp * 16 + lane / 4) * BLOCK + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(o + 8 * h * BLOCK + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

template <int NWG, bool F16>
int launch_half(const CUtensorMap& mg, const CUtensorMap& mx, const int* rb, const int* cb,
                float* out, float* ws, unsigned* counters, int T, int n, int splits,
                cudaStream_t s) {
  using C = Cfg<NWG>;
  auto kern = block_grad_wgmma_kernel<NWG, F16>;
  static bool smem_set[64] = {};
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), C::SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  kern<<<n * (BLOCK / C::BM) * splits, (NWG + 1) * 128, C::SMEM, s>>>(mg, mx, rb, cb, out, ws,
                                                                       counters, T, splits);
  return (int)cudaGetLastError();
}

// ---- fp32 -----------------------------------------------------------------
constexpr int TILE = 64;    // output tile edge owned by one CTA
constexpr int TK32 = 32;    // tokens staged per pass

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

// dtype: 0 = fp32, 1 = bf16, 2 = fp16. bf16 / fp16: bm (64 or 128) rows of a block per CTA,
// T split over `splits` CTAs (1 to ceil(T / 64)); with splits > 1 a
// workspace ws of splits * n * 256 * 256 fp32 (16-byte aligned) and
// counters, one zeroed unsigned per (block, bm rows) tile (left zeroed).
// fp32 ignores bm, splits, ws and counters. Returns cudaGetLastError()
// after the launch.
extern "C" int smt_block_grad(const void* g, const void* x, const void* rb, const void* cb,
                              void* out, void* ws, void* counters, int T, int O, int I, int n,
                              int bm, int splits, int dtype, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rb);
  const int* c = static_cast<const int*>(cb);
  float* o = static_cast<float*>(out);
  if (dtype == 1 || dtype == 2) {
    if (T <= 0 || splits < 1 || splits > (T + TK - 1) / TK ||
        (splits > 1 && (ws == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    CUtensorMap mg, mx;
    const CUtensorMapDataType dt =
        dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!make_map(&mg, dt, 2, g, O, T, 64, TK) || !make_map(&mx, dt, 2, x, I, T, 64, TK))
      return (int)cudaErrorInvalidValue;
    float* w = static_cast<float*>(ws);
    unsigned* k = static_cast<unsigned*>(counters);
    if (bm != 64 && bm != 128) return (int)cudaErrorInvalidValue;
    if (dtype == 2)
      return bm == 128 ? launch_half<2, true>(mg, mx, r, c, o, w, k, T, n, splits, s)
                       : launch_half<1, true>(mg, mx, r, c, o, w, k, T, n, splits, s);
    return bm == 128 ? launch_half<2, false>(mg, mx, r, c, o, w, k, T, n, splits, s)
                     : launch_half<1, false>(mg, mx, r, c, o, w, k, T, n, splits, s);
  }
  if (dtype == 0) {
    const dim3 grid((BLOCK / TILE) * (BLOCK / TILE), n);
    block_grad_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(x), r, c, o, T, O, I);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// K4 q8_matmul: the int8 frozen-base matmul with the scales fused into its
// epilogue, redesigned for Hopper (wgmma, TMA, mbarrier ring, persistent
// CTAs).
//
//   t form (forward):     out[t][o] = (sum_k xq[t][k] * wq[o][k]) * sx[t] * sw[o]
//   g form (grad_input):  out[t][i] = (sum_o gq[t][o] * wq[o][i]) * sg[t]
//   xq (T, K) / gq (T, O) int8 row-quantized activations (csrc/row_quant.cu),
//   sx / sg (T,) fp32; wq (O, K) int8 row-major (ONE copy serves both forms),
//   sw (O,) fp32; out bf16, fp16 or fp32. The int32 sum is exact; the scales
//   are applied to it in fp32 in the order (acc * sx) * sw, rounded once to
//   the output type (to nearest even; fp16 overflows to inf, as torch's and
//   XLA's casts do), so the result equals the plain version bit for bit.
//
// Replaces the Pallas TPU kernels
//   sparse_matrix_tuning_tpu/ops/pallas/q8_matmul.py q8mm_t_core (_kernel_t)
//   and q8mm_g_core (_kernel_g), whose sequential grid comes back to one
//   VMEM accumulator block K step after K step.
//
// What bounds it on the H100: operations at the training shapes (2*T*O*K
// int8 operations against T*K + O*K + 2*T*O bytes, ~1000 a byte at the
// TinyLlama MLP, over the card's ~590 for int8); bytes at the decode shapes
// (T <= 64: the weight streams once). Design:
//   * The product is wgmma.mma_async m64nNk32 s32.s8.s8, both operands read
//     from shared memory in the K-major 128-byte-swizzled layout, int32
//     accumulators in registers; 8-bit wgmma takes only K-major operands.
//   * One producer thread keeps TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle, zero fill past the edges: ragged T, O and K need no masks on
//     load) in flight over a ring of 4-8 stages of 128 contraction bytes,
//     each stage with a "full" mbarrier (transaction bytes) and an "empty"
//     one (released by each consumer warpgroup once its wgmma has read it).
//     One or two consumer warpgroups of 64 rows each issue the wgmma and
//     keep one group in flight (wait_group 1) while the next stage lands.
//   * Persistent CTAs (at most one per SM) walk the output tiles; the producer
//     runs ahead into the next tile, so a tile's epilogue overlaps the next
//     tile's loads.
//   * t form: xq and wq are both K-major as they lie; 128 x 256 tiles at
//     training rows.
//   * g form: the contraction runs over O, wq's SLOW axis. Each landed wq
//     tile (128 rows of O x 128 columns) is transposed once in shared memory
//     by the consumer threads into the K-major swizzled layout (4 x 4 byte
//     blocks, __byte_perm), into one of three buffers, so a buffer is
//     rewritten only after both warpgroups' wgmma on it are done (one named
//     barrier per stage orders it). The lane -> block map makes both the
//     reads of the landed tile and the writes of the transposed one free of
//     bank conflicts. No transposed copy of wq exists in device memory.
//   * Decode rows (T <= 64): 64-row tiles, 128 columns, each CTA streaming
//     its tile's whole contraction. (The contraction split over CTAs, with
//     the partials summed in the launch, was timed at the four TinyLlama
//     decode shapes on the card and lost at three of them, PERF.md.)
//   * The launch plan (tile, grid) is chosen by the wrapper
//     (ops/cuda/q8_matmul.py plan) from T and the output width.
// The contraction length must be a multiple of 16 (TMA row strides); the
// wrapper checks it.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BK = 128;                    // contraction bytes per stage: one swizzle row
constexpr int SMEM_BUDGET = 200 * 1024;    // ring and transposed buffers
constexpr int SMEM_SLACK = 1024 + 256;     // 1024-byte alignment of the tiles, the mbarriers

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_n256(d, da, db);
  else
    wgmma_n128(d, da, db);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (second) p[1] = v1;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (second) p[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ void store2(__half* p, float v0, float v1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
  } else {
    p[0] = __float2half_rn(v0);
    if (second) p[1] = __float2half_rn(v1);
  }
}

// the 4 x 4 byte transpose: r[i] holds bytes (i, 0..3); w[c] gets bytes (0..3, c)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(t0, t1, 0x5410);
  w[1] = __byte_perm(t0, t1, 0x7632);
  w[2] = __byte_perm(t2, t3, 0x5410);
  w[3] = __byte_perm(t2, t3, 0x7632);
}

template <bool G, int NWG, int BN>
struct Cfg {
  static constexpr int BM = 64 * NWG;                  // output rows per tile
  static constexpr int NC = 128 * NWG;                 // consumer threads
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;              // t: wq tile; g: the landed wq tile
  static constexpr int T_BYTES = G ? BN * BK : 0;      // g: one transposed buffer (x 3)
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT = (SMEM_BUDGET - 3 * T_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = STAGES * STAGE + 3 * T_BYTES + SMEM_SLACK;
  static_assert(STAGES >= 3, "the ring needs at least 3 stages");
  static_assert(!G || BN == 128, "the g form transposes 128 x 128 tiles");
};

// One kernel for both forms. out (M, N) = A (M, Kc) . B, scaled; A is
// row-major (tmA over (Kc, M)). t form: tmB over wq (N, Kc), B(k, n) =
// wq[n][k]. g form: tmB over wq (Kc, N), B(k, n) = wq[k][n]. Tiles are
// walked m-fastest (neighbouring CTAs share a weight tile in L2).
template <bool G, int NWG, int BN, typename OutT>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
q8mm_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
            const float* __restrict__ srow, const float* __restrict__ scol,
            OutT* __restrict__ out, int M, int N, int Kc) {
  using C = Cfg<G, NWG, BN>;
  constexpr int BM = C::BM, NC = C::NC, STAGES = C::STAGES, R = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem_1024(smem_raw);
  uint8_t* sA = smem;
  uint8_t* sB = sA + STAGES * C::A_BYTES;
  uint8_t* sT = sB + STAGES * C::B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sT + 3 * C::T_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  const int nkb = (Kc + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every load
    // two consumer warpgroups take the producer's registers (128 int32
    // accumulators a thread at 256 columns)
    if constexpr (NWG == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int tm = tile % tiles_m, tn = tile / tiles_m;
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], C::STAGE);
          tma_load_2d(sA + stage * C::A_BYTES, &tmA, &full[stage], kb * BK, tm * BM);
          if (G)
            tma_load_2d(sB + stage * C::B_BYTES, &tmB, &full[stage], tn * BN, kb * BK);
          else
            tma_load_2d(sB + stage * C::B_BYTES, &tmB, &full[stage], kb * BK, tn * BN);
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
  const bool even = (N % 2) == 0;
  int stage = 0, it = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tm = tile % tiles_m, tn = tile / tiles_m;
    int acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    fence_acc(acc);
    int prev = -1;
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      mbar_wait(&full[stage], phase);
      const uint8_t* b_tile = sB + stage * C::B_BYTES;
      if constexpr (G) {
        // transpose the landed (o, n) tile into the K-major (n, o) buffer:
        // thread block (ob, nb) = 4 rows of o x 4 columns of n
        const uint8_t* raw = b_tile;
        uint8_t* bt = sT + (it % 3) * C::T_BYTES;
        constexpr int TPW = 32 / (NWG * 4);  // 4 x 4 blocks per thread
        const int ob = ((lane & 15) << 1) | (lane >> 4);
        const int cw = ct / 32;
#pragma unroll
        for (int j = 0; j < TPW; ++j) {
          const int nb = (lane & 15) ^ (cw * TPW + j);
          uint32_t r[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = *reinterpret_cast<const uint32_t*>(raw + sw128(4 * ob + i, 4 * nb));
          transpose4x4(r, w);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            *reinterpret_cast<uint32_t*>(bt + sw128(4 * nb + c, 4 * ob)) = w[c];
        }
        fence_proxy_async_smem();
        named_sync(1, NC);
        b_tile = bt;
      }
      // K-major descriptors; the start address advances by 32 bytes (2 units) per k32
      const uint64_t da = gmma_desc(sA + stage * C::A_BYTES + cwg * 64 * BK, 16, 1024);
      const uint64_t db = gmma_desc(b_tile, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
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
    if (prev >= 0 && ct % 128 == 0) mbar_arrive(&empty[prev]);

    // accumulator layout: register 4j + 2h + e holds row 16 warp + lane/4 + 8h,
    // column 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN tile
    const int m_base = tm * BM + cwg * 64 + warp * 16 + lane / 4;
    const int n_base = tn * BN + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + 8 * h;
      if (m >= M) continue;
      const float sr = srow[m];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n_base + 8 * j;
        if (n >= N) continue;
        const bool second = n + 1 < N;
        float v0 = (float)acc[4 * j + 2 * h] * sr;
        float v1 = (float)acc[4 * j + 2 * h + 1] * sr;
        if (!G) {
          v0 *= scol[n];
          if (second) v1 *= scol[n + 1];
        }
        store2(out + (size_t)m * N + n, v0, v1, even && second, second);
      }
    }
  }
}

template <bool G, int NWG, int BN, typename OutT>
int launch_cfg(const CUtensorMap& ma, const CUtensorMap& mb, const float* sr, const float* sc,
               void* out, int M, int N, int Kc, int grid, cudaStream_t s) {
  using C = Cfg<G, NWG, BN>;
  auto kern = q8mm_kernel<G, NWG, BN, OutT>;
  static bool smem_set[64] = {};
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), C::SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, (NWG + 1) * 128, C::SMEM, s>>>(ma, mb, sr, sc, static_cast<OutT*>(out), M, N,
                                               Kc);
  return (int)cudaGetLastError();
}

template <bool G, typename OutT>
int launch_form(const CUtensorMap& ma, const CUtensorMap& mb, const float* sr, const float* sc,
                void* out, int M, int N, int Kc, int bm, int bn, int grid, cudaStream_t s) {
  if (bm == 64 && bn == 128)
    return launch_cfg<G, 1, 128, OutT>(ma, mb, sr, sc, out, M, N, Kc, grid, s);
  if constexpr (G) {
    if (bm == 128 && bn == 128)
      return launch_cfg<G, 2, 128, OutT>(ma, mb, sr, sc, out, M, N, Kc, grid, s);
  } else {
    if (bm == 128 && bn == 256)
      return launch_cfg<G, 2, 256, OutT>(ma, mb, sr, sc, out, M, N, Kc, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

// A (M, Kc) int8; t form: W (N, Kc); g form: W (Kc, N)
template <bool G>
int launch(const void* a, const void* w, const void* srow, const void* scol, void* out, int M,
           int N, int Kc, int out_dtype, int bm, int bn, int grid, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (Kc <= 0 || Kc % 16 || (G && N % 16) || grid < 1 || (bm != 64 && bm != 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  constexpr CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!make_map(&ma, U8, 1, a, Kc, M, BK, bm)) return (int)cudaErrorInvalidValue;
  if (!(G ? make_map(&mb, U8, 1, w, N, Kc, BK, BK) : make_map(&mb, U8, 1, w, Kc, N, BK, bn)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sr = static_cast<const float*>(srow);
  const float* sc = static_cast<const float*>(scol);
  if (out_dtype == 1)
    return launch_form<G, __nv_bfloat16>(ma, mb, sr, sc, out, M, N, Kc, bm, bn, grid, s);
  if (out_dtype == 2)
    return launch_form<G, __half>(ma, mb, sr, sc, out, M, N, Kc, bm, bn, grid, s);
  if (out_dtype == 0)
    return launch_form<G, float>(ma, mb, sr, sc, out, M, N, Kc, bm, bn, grid, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out_dtype: 0 = fp32, 1 = bf16, 2 = fp16. The plan (bm x bn tiles, grid CTAs) comes
// from the wrapper. Both return cudaGetLastError() after the launch.

// out (T, O) = ((xq (T, K) . wq (O, K)^T) * sx (T,)) * sw (O,); K % 16 == 0.
extern "C" int smt_q8mm_t(const void* xq, const void* sx, const void* wq, const void* sw,
                          void* out, int T, int O, int K, int out_dtype, int bm, int bn,
                          int grid, void* stream) {
  return launch<false>(xq, wq, sx, sw, out, T, O, K, out_dtype, bm, bn, grid, stream);
}

// out (T, K) = (gq (T, O) . wq (O, K)) * sg (T,); O % 16 == 0 and K % 16 == 0.
extern "C" int smt_q8mm_g(const void* gq, const void* sg, const void* wq, void* out, int T,
                          int O, int K, int out_dtype, int bm, int bn, int grid, void* stream) {
  return launch<true>(gq, wq, sg, nullptr, out, T, K, O, out_dtype, bm, bn, grid, stream);
}

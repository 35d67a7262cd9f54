// K6 q4_matmul: the decode matmul over the nibble-packed int4 frozen base,
// unpacked in registers, with the per-group scales applied to each group's
// partial sum.
//
//   out[t][o] = sum_g ( sum_{c in group g} x[t][c] * q[o][c] ) * s4[o][g]
//   x (T, I) bf16, T <= 64 (decode: batch x beams rows); w4 (O, K) int8,
//   K = I / 2 packed columns, SPLIT-HALF: packed column c holds q[o][c] in its
//   low nibble and q[o][K + c] in its high nibble (4-bit two's complement);
//   s4 (O, I / 128) fp32, one scale per 128 columns: the low nibble of
//   column c belongs to group c / 128, the high one to group K / 128 + c / 128.
//   Each group's partial is an fp32 sum of exact products (bf16 times a small
//   integer), scaled by its group's scale and added in fp32; the result is
//   rounded once to the output type (bf16 or fp32). It is NOT a product
//   against a bf16-dequantized weight: rounding q * s to bf16 would change it.
//
// Replaces the Pallas TPU kernels
//   sparse_matrix_tuning_tpu/ops/pallas/q4_matmul.py _q4_matmul_t_2d (K6) and
//   _q4_stacked_2d (K6s: the same kernel on layer l of an (L, O, K) stack,
//   picked by scalar prefetch). Here K6s is this kernel on the contiguous
//   view w4[l], s4[l]; nothing is copied.
//
// What bounds it on the H100: bytes at the decode shapes. The packed weight
// is read once (O * K bytes, 5.8 MB at TinyLlama's gate/up), x and the
// output are small, and 2*T*O*I operations at T <= 64 stay under the bf16
// tensor cores' rate for those bytes. Design:
//   * One CTA owns 128 output columns (8 warps, each two 8-wide n-tiles)
//     and a range of scale groups. (256 columns, which halve the re-reads
//     of x, were slower at every decode shape on the card: half the CTAs,
//     and two accumulator sets of twice the size spill; PERF.md.) Few output
//     tiles (k/v: O = 256) would leave most SMs idle, so the groups are
//     split over CTAs (split-K); the splits are summed in the same launch:
//     each writes its fp32 partial to a workspace (small enough to stay in
//     L2; thread-major, so written and read in coalesced 16-byte vectors),
//     and the last CTA of a tile to arrive (a per-tile counter, which it
//     resets for the next call) adds the partials in split order 0, 1, ...
//     and rounds once: deterministic, no atomics on the data, one launch.
//   * Thread 0 keeps TMA loads in flight: the packed weight through a ring
//     of 4 stages of 16 KB (a group's 128 packed columns x 128 rows: 48 KB
//     in flight while one stage is computed), x through a ring of 2 stages
//     (the group's 2 x 128 columns of both planes, T rows, from L2), each
//     stage with a "full" mbarrier (transaction bytes); after a group, one
//     __syncthreads frees its stages and thread 0 refills them. Both are
//     written with the 128-byte swizzle, so the fragment loads below see few
//     or no bank conflicts. Rows past T or O arrive as zeros. The group's
//     scales are loaded while its tiles land.
//   * Products through mma.sync m16n8k16 bf16 with fp32 accumulators, in the
//     explicit fragment layout, so each thread knows the output columns of
//     its accumulators and applies their scales from registers: one
//     accumulator set for the current group's partial, one for the sum.
//     The 16 k-positions of an mma may map to any 16 columns as long as A
//     and B agree; here thread (gid, tig) takes 4 consecutive columns per
//     mma, so one 32-bit word of packed bytes becomes its B fragment for the
//     low plane and, from the high nibbles, for the high plane.
//   * Nibbles become bf16 without a conversion instruction: (n ^ 8) sits in
//     the mantissa of 128.0 (0x4300 | (n ^ 8)), and subtracting 136 leaves
//     (n ^ 8) - 8, the signed value, exactly.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int GROUP = 128;             // columns of one scale group (and packed columns)
constexpr int NW = 8;                  // warps
constexpr int NTH = NW * 32;
constexpr int MAX_MT = 4;              // 16-row m-tiles: T <= 64
constexpr int W_STAGES = 4;
constexpr int X_STAGES = 2;
constexpr int NT = 2;                  // 8-wide n-tiles per warp
constexpr int BO = NW * NT * 8;        // 128 output columns per CTA
constexpr int W_BYTES = BO * GROUP;    // one group of the packed weight tile

template <int MT>
struct Cfg {
  static constexpr int X_TILE = MT * 16 * 128;  // one plane's half group: 64 bf16 x MT*16 rows
  static constexpr int X_BYTES = 4 * X_TILE;    // 2 planes x 2 halves
  static constexpr int SMEM = W_STAGES * W_BYTES + X_STAGES * X_BYTES + 1024 + 256;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two packed bytes (the low halves of `pair`'s 16-bit lanes, sign bit of
// each nibble already flipped) -> bf16x2 of one plane's signed values
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t pair, int shift) {
  const uint32_t biased = ((pair >> shift) & 0x000F000Fu) | 0x43004300u;  // 128 + (n ^ 8)
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const uint32_t k136 = 0x43084308u;                                      // bf16x2 136.0
  const __nv_bfloat162 r = __hsub2(v, *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// grid tiles * splits: CTA b takes split b % splits of output tile b / splits
template <int MT, typename OutT>
__global__ void __launch_bounds__(NTH, 1)
q4mm_kernel(const __grid_constant__ CUtensorMap tmW, const __grid_constant__ CUtensorMap tmX,
            const float* __restrict__ s4, float* __restrict__ ws,
            unsigned* __restrict__ counters, OutT* __restrict__ out, int T, int O, int K,
            int splits) {
  using C = Cfg<MT>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_last;
  uint8_t* smem = align_smem_1024(smem_raw);
  uint8_t* sW = smem;
  uint8_t* sX = sW + W_STAGES * W_BYTES;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(sX + X_STAGES * C::X_BYTES);
  uint64_t* x_full = w_full + W_STAGES;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kg = K / GROUP;            // groups per plane
  const int n_groups = 2 * kg;         // scale columns
  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int g0 = (int)((long long)split * kg / splits);
  const int g1 = (int)((long long)(split + 1) * kg / splits);

  // group gi's weight goes to stage (gi - g0) % W_STAGES, its x to stage
  // (gi - g0) % X_STAGES
  auto load_w = [&](int gi) {
    const int st = (gi - g0) % W_STAGES;
    mbar_expect_tx(&w_full[st], W_BYTES);
    tma_load_2d(sW + st * W_BYTES, &tmW, &w_full[st], gi * GROUP, tile * BO);
  };
  auto load_x = [&](int gi) {
    const int st = (gi - g0) % X_STAGES;
    mbar_expect_tx(&x_full[st], C::X_BYTES);
#pragma unroll
    for (int h = 0; h < 4; ++h)  // (plane, half) = (h / 2, h % 2)
      tma_load_2d(sX + st * C::X_BYTES + h * C::X_TILE, &tmX, &x_full[st],
                  (h / 2) * K + gi * GROUP + (h % 2) * 64, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) mbar_init(&w_full[s], 1);
    for (int s = 0; s < X_STAGES; ++s) mbar_init(&x_full[s], 1);
    mbar_init_fence();
    for (int gi = g0; gi < g1 && gi < g0 + W_STAGES; ++gi) load_w(gi);
    for (int gi = g0; gi < g1 && gi < g0 + X_STAGES; ++gi) load_x(gi);
  }
  __syncthreads();

  const int gid = lane / 4, tig = lane % 4;
  const int o_warp = tile * BO + warp * NT * 8;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  int wst = 0, xst = 0;
  uint32_t wph = 0, xph = 0;
  for (int gi = g0; gi < g1; ++gi) {
    // the group's scales of this thread's columns, both planes, loaded while
    // the tiles land
    float sc[2][NT][2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o_warp + nt * 8 + tig * 2 + e;
          sc[p][nt][e] = o < O ? __ldg(s4 + (size_t)o * n_groups + p * kg + gi) : 0.f;
        }
    mbar_wait(&w_full[wst], wph);
    mbar_wait(&x_full[xst], xph);
    const uint8_t* wt = sW + wst * W_BYTES;
    const uint8_t* xt = sX + xst * C::X_BYTES;
#pragma unroll
    for (int p = 0; p < 2; ++p) {       // plane: low nibbles, then high nibbles
      float part[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
      for (int st = 0; st < 2; ++st) {  // 64 packed columns per step
        // B fragments: word j of the thread's 16 bytes holds columns
        // 16*tig + 4j .. +3 of row gid; hardware k 2*tig+{0,1} takes the
        // first two, k 2*tig+8+{0,1} the last two
        uint32_t b[NT][4][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4 wv = *reinterpret_cast<const uint4*>(
              wt + sw128(warp * NT * 8 + nt * 8 + gid, st * 64 + tig * 16));
          const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t v = words[j] ^ 0x88888888u;
            b[nt][j][0] = nibbles_to_bf16x2(__byte_perm(v, 0u, 0x4140), p * 4);
            b[nt][j][1] = nibbles_to_bf16x2(__byte_perm(v, 0u, 0x4342), p * 4);
          }
        }
        const uint8_t* xp = xt + (p * 2 + st) * C::X_TILE;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // A fragments: rows gid and gid + 8, the same 16 columns
          const int r0 = mt * 16 + gid;
          const uint4 a0 = *reinterpret_cast<const uint4*>(xp + sw128(r0, tig * 32));
          const uint4 a1 = *reinterpret_cast<const uint4*>(xp + sw128(r0, tig * 32 + 16));
          const uint4 c0 = *reinterpret_cast<const uint4*>(xp + sw128(r0 + 8, tig * 32));
          const uint4 c1 = *reinterpret_cast<const uint4*>(xp + sw128(r0 + 8, tig * 32 + 16));
          const uint32_t lo[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const uint32_t hi[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t a[4] = {lo[2 * j], hi[2 * j], lo[2 * j + 1], hi[2 * j + 1]};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(part[mt][nt], a, b[nt][j]);
          }
        }
      }
      // the group's scale times its partial, added to the sum
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][0] += part[mt][nt][0] * sc[p][nt][0];
          acc[mt][nt][1] += part[mt][nt][1] * sc[p][nt][1];
          acc[mt][nt][2] += part[mt][nt][2] * sc[p][nt][0];
          acc[mt][nt][3] += part[mt][nt][3] * sc[p][nt][1];
        }
      }
    }
    __syncthreads();  // every warp is done with the group's stages: refill them
    if (tid == 0) {
      if (gi + W_STAGES < g1) load_w(gi + W_STAGES);
      if (gi + X_STAGES < g1) load_x(gi + X_STAGES);
    }
    if (++wst == W_STAGES) {
      wst = 0;
      wph ^= 1;
    }
    if (++xst == X_STAGES) {
      xst = 0;
      xph ^= 1;
    }
  }

  // C fragments: thread (gid, tig) holds rows gid, gid + 8 of each m-tile
  // and columns 2 tig, 2 tig + 1 of each n-tile (O is a multiple of 128, so
  // a pair is inside or outside)
  if (splits > 1) {
    // each thread's accumulators as MT * NT float4, thread-major: the
    // partial of (split, tile) is written and read coalesced
    const int n_tiles = gridDim.x / splits;
    float4* mine = reinterpret_cast<float4*>(ws) + ((size_t)split * n_tiles + tile) * MT * NT * NTH;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mine[(size_t)(mt * NT + nt) * NTH + tid] =
            make_float4(acc[mt][nt][0], acc[mt][nt][1], acc[mt][nt][2], acc[mt][nt][3]);
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&counters[tile], 1u) == (unsigned)(splits - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // the last split to arrive sums every split's partial in split order
    // 0, 1, ..., one split's loads in flight together
#pragma unroll 2
    for (int s = 0; s < splits; ++s) {
      const float4* src =
          reinterpret_cast<const float4*>(ws) + ((size_t)s * n_tiles + tile) * MT * NT * NTH;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float4 w = __ldcg(src + (size_t)(mt * NT + nt) * NTH + tid);
          if (s == 0) {
            acc[mt][nt][0] = w.x;
            acc[mt][nt][1] = w.y;
            acc[mt][nt][2] = w.z;
            acc[mt][nt][3] = w.w;
          } else {
            acc[mt][nt][0] += w.x;
            acc[mt][nt][1] += w.y;
            acc[mt][nt][2] += w.z;
            acc[mt][nt][3] += w.w;
          }
        }
    }
    if (tid == 0) counters[tile] = 0;  // every split has arrived: ready for the next call
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = mt * 16 + gid + h * 8;
      if (t >= T) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o = o_warp + nt * 8 + tig * 2;
        if (o < O) store2(out + (size_t)t * O + o, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

template <int MT, typename OutT>
int launch_mt(const void* x, const void* w4, const void* s4, void* ws, void* counters, void* out,
              int T, int O, int K, int splits, cudaStream_t s) {
  CUtensorMap mw, mx;
  if (!make_map(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w4, K, O, GROUP, BO) ||
      !make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, 2 * K, T, 64, MT * 16))
    return (int)cudaErrorInvalidValue;
  auto kern = q4mm_kernel<MT, OutT>;
  static bool smem_set[64] = {};
  const cudaError_t e =
      allow_smem(reinterpret_cast<const void*>(kern), Cfg<MT>::SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (O + BO - 1) / BO;
  kern<<<tiles * splits, NTH, Cfg<MT>::SMEM, s>>>(
      mw, mx, static_cast<const float*>(s4), static_cast<float*>(ws),
      static_cast<unsigned*>(counters), static_cast<OutT*>(out), T, O, K, splits);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const void* x, const void* w4, const void* s4, void* ws, void* counters, void* out,
           int T, int O, int K, int splits, cudaStream_t s) {
  switch ((T + 15) / 16) {
    case 1: return launch_mt<1, OutT>(x, w4, s4, ws, counters, out, T, O, K, splits, s);
    case 2: return launch_mt<2, OutT>(x, w4, s4, ws, counters, out, T, O, K, splits, s);
    case 3: return launch_mt<3, OutT>(x, w4, s4, ws, counters, out, T, O, K, splits, s);
    default: return launch_mt<MAX_MT, OutT>(x, w4, s4, ws, counters, out, T, O, K, splits, s);
  }
}

}  // namespace

// out (T, O) = x (T, 2K) bf16 . dequant4(w4 (O, K), s4 (O, 2K / 128))^T, in
// out_dtype (0 = fp32, 1 = bf16). 1 <= T <= 64; O and K multiples of 128;
// 1 <= splits <= K / 128, and with splits > 1 a workspace ws of
// splits * (O / 128) * 16 ceil(T / 16) * 128 fp32 (16-byte aligned) and
// counters, one zeroed unsigned per 128-column output tile (left zeroed).
// One launch; returns cudaGetLastError() after it.
extern "C" int smt_q4mm(const void* x, const void* w4, const void* s4, void* ws, void* counters,
                        void* out, int T, int O, int K, int splits, int out_dtype,
                        void* stream) {
  if (T < 1 || T > MAX_MT * 16 || O <= 0 || O % GROUP || K <= 0 || K % GROUP || splits < 1 ||
      splits > K / GROUP || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(x, w4, s4, ws, counters, out, T, O, K, splits, s);
  if (out_dtype == 0) return launch<float>(x, w4, s4, ws, counters, out, T, O, K, splits, s);
  return (int)cudaErrorInvalidValue;
}

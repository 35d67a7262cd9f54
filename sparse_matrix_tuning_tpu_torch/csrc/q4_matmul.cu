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
//   * One CTA owns 128 output columns (8 warps, each two 8-wide n-tiles) and
//     a range of scale groups. Few output tiles (k/v projections: O = 256)
//     would leave most SMs idle, so the groups are split over CTAs (split-K)
//     and a second kernel sums the fp32 partials over the splits in a fixed
//     order: deterministic, no atomics. The Pallas grid's sequential K axis
//     becomes the group loop inside the CTA plus that reduction.
//   * The packed bytes stream once, in 16-byte loads (4 lanes cover 64
//     contiguous bytes of a row), with the next group's loads in flight
//     while the current group computes.
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
//   * x is staged per group (both planes, T x 256 bf16 = 32 KB at T = 64) in
//     shared memory with a padded pitch, so the A-fragment loads are free of
//     bank conflicts. Rows past T are zeros and never stored (ragged T).
// Simple first: no cp.async/TMA ring, no wgmma, one x buffer.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 128;             // columns of one scale group (and packed columns)
constexpr int NW = 8;                  // warps per CTA
constexpr int NTH = NW * 32;
constexpr int NT = 2;                  // 8-wide n-tiles per warp
constexpr int BO = NW * NT * 8;        // 128 output columns per CTA
constexpr int XPITCH = GROUP + 8;      // bf16 per staged x row: 272 bytes
constexpr int MAX_MT = 4;              // 16-row m-tiles: T <= 64

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

// grid (O / 128, splits). splits == 1: out (T, O) in OutT; else the split's
// fp32 partial sums to ws[split] (T, O).
template <int MT, typename OutT>
__global__ void __launch_bounds__(NTH)
q4mm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w4,
            const float* __restrict__ s4, float* __restrict__ ws, OutT* __restrict__ out,
            int T, int O, int K, int splits) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][MT * 16][XPITCH];  // [plane][row][col]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kg = K / GROUP;            // groups per plane
  const int n_groups = 2 * kg;         // scale columns
  const int split = blockIdx.y;
  const int g0 = (int)((long long)split * kg / splits);
  const int g1 = (int)((long long)(split + 1) * kg / splits);
  const int o_warp = blockIdx.x * BO + warp * NT * 8;

  // rows of w4 this thread loads (B fragments: n = gid) and the output
  // columns its accumulators hold (C fragments: 2 * tig, 2 * tig + 1)
  const int8_t* wrow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    wrow[nt] = w4 + (size_t)(o_warp + nt * 8 + gid) * K + tig * 16;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // one group's packed bytes: per n-tile, two 64-column steps of 16 bytes
  uint4 wcur[NT][2], wnext[NT][2];
  auto load_w = [&](int gi, uint4 (&w)[NT][2]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int st = 0; st < 2; ++st)
        w[nt][st] = __ldg(reinterpret_cast<const uint4*>(wrow[nt] + gi * GROUP + st * 64));
  };

  if (g0 < g1) load_w(g0, wcur);
  for (int gi = g0; gi < g1; ++gi) {
    if (gi + 1 < g1) load_w(gi + 1, wnext);
    __syncthreads();  // the previous group's reads of xs are done
    // stage x's columns of group gi, both planes: MT*16 rows x 2 x 16 vectors
    for (int idx = tid; idx < MT * 16 * 2 * 16; idx += NTH) {
      const int c = idx % 16;
      const int p = (idx / 16) % 2;
      const int r = idx / 32;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < T)
        v = *reinterpret_cast<const uint4*>(x + (size_t)r * (2 * K) + p * K + gi * GROUP + c * 8);
      *reinterpret_cast<uint4*>(&xs[p][r][c * 8]) = v;
    }
    __syncthreads();

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
          const uint32_t words[4] = {wcur[nt][st].x, wcur[nt][st].y, wcur[nt][st].z,
                                     wcur[nt][st].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t v = words[j] ^ 0x88888888u;
            b[nt][j][0] = nibbles_to_bf16x2(__byte_perm(v, 0u, 0x4140), p * 4);
            b[nt][j][1] = nibbles_to_bf16x2(__byte_perm(v, 0u, 0x4342), p * 4);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // A fragments: rows gid and gid + 8, the same 16 columns
          const __nv_bfloat16* r0 = &xs[p][mt * 16 + gid][st * 64 + tig * 16];
          const __nv_bfloat16* r8 = r0 + 8 * XPITCH;
          const uint4 a0 = *reinterpret_cast<const uint4*>(r0);
          const uint4 a1 = *reinterpret_cast<const uint4*>(r0 + 8);
          const uint4 c0 = *reinterpret_cast<const uint4*>(r8);
          const uint4 c1 = *reinterpret_cast<const uint4*>(r8 + 8);
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
        const int o = o_warp + nt * 8 + tig * 2;
        const float sc0 = __ldg(s4 + (size_t)o * n_groups + p * kg + gi);
        const float sc1 = __ldg(s4 + (size_t)(o + 1) * n_groups + p * kg + gi);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][0] += part[mt][nt][0] * sc0;
          acc[mt][nt][1] += part[mt][nt][1] * sc1;
          acc[mt][nt][2] += part[mt][nt][2] * sc0;
          acc[mt][nt][3] += part[mt][nt][3] * sc1;
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      wcur[nt][0] = wnext[nt][0];
      wcur[nt][1] = wnext[nt][1];
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = mt * 16 + gid + h * 8;
      if (t >= T) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o = o_warp + nt * 8 + tig * 2;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (splits == 1)
          store2(out + (size_t)t * O + o, v0, v1);
        else
          store2(ws + ((size_t)split * T + t) * O + o, v0, v1);
      }
    }
  }
}

// out[i] = sum over s of ws[s][i], in the order s = 0, 1, ..., rounded once;
// four elements a thread (T * O is a multiple of 128)
template <typename OutT>
__global__ void q4mm_reduce(const float* __restrict__ ws, OutT* __restrict__ out, int n,
                            int splits) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 acc = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(ws + (size_t)s * n + i);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  store2(out + i, acc.x, acc.y);
  store2(out + i + 2, acc.z, acc.w);
}

template <int MT, typename OutT>
void launch_main(const void* x, const void* w4, const void* s4, void* ws, void* out, int T,
                 int O, int K, int splits, cudaStream_t s) {
  const dim3 grid(O / BO, splits);
  q4mm_kernel<MT, OutT><<<grid, NTH, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w4),
      static_cast<const float*>(s4), static_cast<float*>(ws), static_cast<OutT*>(out), T, O, K,
      splits);
}

template <typename OutT>
int launch(const void* x, const void* w4, const void* s4, void* ws, void* out, int T, int O,
           int K, int splits, cudaStream_t s) {
  switch ((T + 15) / 16) {
    case 1: launch_main<1, OutT>(x, w4, s4, ws, out, T, O, K, splits, s); break;
    case 2: launch_main<2, OutT>(x, w4, s4, ws, out, T, O, K, splits, s); break;
    case 3: launch_main<3, OutT>(x, w4, s4, ws, out, T, O, K, splits, s); break;
    default: launch_main<MAX_MT, OutT>(x, w4, s4, ws, out, T, O, K, splits, s); break;
  }
  if (splits > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int n = T * O;
    const int threads = 256;
    q4mm_reduce<OutT><<<(n / 4 + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const float*>(ws), static_cast<OutT*>(out), n, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (T, O) = x (T, 2K) bf16 . dequant4(w4 (O, K), s4 (O, 2K / 128))^T, in
// out_dtype (0 = fp32, 1 = bf16). 1 <= T <= 64; O and K multiples of 128;
// 1 <= splits <= K / 128, and with splits > 1 a workspace ws of splits * T * O
// fp32. Returns cudaGetLastError() after the launches.
extern "C" int smt_q4mm(const void* x, const void* w4, const void* s4, void* ws, void* out,
                        int T, int O, int K, int splits, int out_dtype, void* stream) {
  if (T < 1 || T > MAX_MT * 16 || O <= 0 || O % BO || K <= 0 || K % GROUP || splits < 1 ||
      splits > K / GROUP || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) return launch<__nv_bfloat16>(x, w4, s4, ws, out, T, O, K, splits, s);
  if (out_dtype == 0) return launch<float>(x, w4, s4, ws, out, T, O, K, splits, s);
  return (int)cudaErrorInvalidValue;
}

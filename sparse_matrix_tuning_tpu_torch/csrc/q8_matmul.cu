// K4 q8_matmul: the int8 frozen-base matmul with the scales fused into its
// epilogue.
//
//   t form (forward):     out[t][o] = (sum_k xq[t][k] * wq[o][k]) * sx[t] * sw[o]
//   g form (grad_input):  out[t][i] = (sum_o gq[t][o] * wq[o][i]) * sg[t]
//   xq (T, K) / gq (T, O) int8 row-quantized activations, sx / sg (T,) fp32;
//   wq (O, K) int8 row-major (ONE copy serves both forms), sw (O,) fp32;
//   out bf16 or fp32. The int32 sum is exact; the scales are applied to it
//   in fp32 in the order (acc * sx) * sw, rounded once to the output type.
//
// Replaces the Pallas TPU kernels
//   sparse_matrix_tuning_tpu/ops/pallas/q8_matmul.py q8mm_t_core (_kernel_t)
//   and q8mm_g_core (_kernel_g), whose sequential grid comes back to one
//   VMEM accumulator block K step after K step.
//
// What bounds it on the H100: operations (2*T*O*K int8 operations against
// T*K + O*K + 2*T*O bytes: ~1000 operations per byte at the TinyLlama MLP
// shapes, far above the card's ~590 for int8). What the kernel exists for
// is the epilogue: the (T, O) int32 product never goes to device memory.
// Design:
//   * CTAs run in parallel and in no order, so the K reduction is a loop
//     inside one CTA: one CTA owns a 128 x 128 output tile, 8 warps each a
//     64 x 32 part of it, int32 accumulators in registers (no split-K, no
//     atomics), and writes the tile once, scaled.
//   * Tensor cores through mma.sync m16n8k32 s8 (legacy path; wgmma later).
//     Its operands must have the contraction index contiguous. The t form's
//     tiles are copied to shared memory as they lie (16-byte vectors). The
//     g form contracts over O, the SLOW axis of wq: its tile is read as
//     4 x 4 byte blocks and transposed in registers (__byte_perm) on the way
//     to shared memory, so both forms run the same inner loop and no
//     transposed copy of wq ever exists in device memory.
//   * The next K tile's global loads are started into registers before the
//     current tile's products, so they overlap; one shared-memory buffer.
//   * Ragged T and O (t) / T and I (g) are masked: zero rows on load, no
//     write outside. The contraction length must be a multiple of 16 (whole
//     16-byte vectors); the wrapper checks it.
// Simple first: no ldmatrix, no cp.async/TMA ring, no wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows per CTA
constexpr int BN = 128;          // output columns per CTA
constexpr int BK = 64;           // contraction bytes per shared-memory pass
constexpr int PITCH = BK + 16;   // shared row pitch, bytes: 20 words, so the
                                 // fragment loads below hit 32 distinct banks
constexpr int NT = 256;          // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// out (M, N) = A (M, Kc) . B, scaled. A: row-major, pitch Kc.
//   G == false (t form): W is (N, Kc) row-major, B(k, n) = W[n][k];
//                        out = (acc * srow[m]) * scol[n].
//   G == true  (g form): W is (Kc, N) row-major, B(k, n) = W[k][n];
//                        out = acc * srow[m].
template <bool G, typename OutT>
__global__ void __launch_bounds__(NT)
q8mm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
            const float* __restrict__ srow, const float* __restrict__ scol,
            OutT* __restrict__ out, int M, int N, int Kc) {
  __shared__ __align__(16) int8_t As[BM * PITCH];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * PITCH];  // [n][k]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // staging registers of one K tile: A and (t form) W as 16-byte vectors,
  // (g form) W as two transposed 4 x 4 byte blocks
  uint4 ra[2];
  uint4 rb[2];
  uint32_t rw[2][4];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * NT;       // 512 vectors: 128 rows x 4
      const int r = idx / 4, c = (idx % 4) * 16;
      const int m = m0 + r, k = k0 + c;
      ra[v] = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < Kc)
        ra[v] = *reinterpret_cast<const uint4*>(A + (size_t)m * Kc + k);
      if (!G) {
        const int n = n0 + r;
        rb[v] = make_uint4(0u, 0u, 0u, 0u);
        if (n < N && k < Kc)
          rb[v] = *reinterpret_cast<const uint4*>(W + (size_t)n * Kc + k);
      }
    }
    if (G) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        // 16 x 32 blocks of 4 (k) x 4 (n) bytes; a warp takes 4 x 8 of them,
        // so each of its loads covers whole 32-byte sectors of 4 rows
        const int task = warp + v * 8;
        const int kb = (task / 4) * 4 + lane / 8;
        const int nb = (task % 4) * 8 + lane % 8;
        const int n = n0 + nb * 4;
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + kb * 4 + i;
          r[i] = 0u;
          if (k < Kc && n < N)  // N % 4 == 0: a word is inside or outside
            r[i] = *reinterpret_cast<const uint32_t*>(W + (size_t)k * N + n);
        }
        // transpose the 4 x 4 bytes: word c holds column n + c over k..k+3
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
        rw[v][0] = __byte_perm(t0, t1, 0x5410);
        rw[v][1] = __byte_perm(t0, t1, 0x7632);
        rw[v][2] = __byte_perm(t2, t3, 0x5410);
        rw[v][3] = __byte_perm(t2, t3, 0x7632);
      }
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int idx = tid + v * NT;
      const int r = idx / 4, c = (idx % 4) * 16;
      *reinterpret_cast<uint4*>(&As[r * PITCH + c]) = ra[v];
      if (!G) *reinterpret_cast<uint4*>(&Bs[r * PITCH + c]) = rb[v];
    }
    if (G) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int task = warp + v * 8;
        const int kb = (task / 4) * 4 + lane / 8;
        const int nb = (task % 4) * 8 + lane % 8;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<uint32_t*>(&Bs[(nb * 4 + c) * PITCH + kb * 4]) = rw[v][c];
      }
    }
  };

  const int nk = (Kc + BK - 1) / BK;
  load_tile(0);
  for (int kt = 0; kt < nk; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < nk) load_tile((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = &As[(wm + mi * 16 + gid) * PITCH + kk + tig * 4];
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = &Bs[(wn + ni * 8 + gid) * PITCH + kk + tig * 4];
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // epilogue from the accumulator registers: thread (gid, tig) of a
  // 16 x 8 fragment holds rows gid, gid + 8 and columns 2*tig, 2*tig + 1
  const bool even = (N % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + gid + h * 8;
      if (m >= M) continue;
      const float sr = srow[m];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + tig * 2;
        if (n >= N) continue;
        const bool second = n + 1 < N;
        float v0 = (float)acc[mi][ni][h * 2] * sr;
        float v1 = (float)acc[mi][ni][h * 2 + 1] * sr;
        if (!G) {
          v0 *= scol[n];
          if (second) v1 *= scol[n + 1];
        }
        store2(out + (size_t)m * N + n, v0, v1, even && second, second);
      }
    }
  }
}

template <bool G>
int launch(const void* a, const void* w, const void* srow, const void* scol, void* out,
           int M, int N, int Kc, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* W = static_cast<const int8_t*>(w);
  const float* sr = static_cast<const float*>(srow);
  const float* sc = static_cast<const float*>(scol);
  if (out_dtype == 1) {
    q8mm_kernel<G, __nv_bfloat16><<<grid, NT, 0, s>>>(
        A, W, sr, sc, static_cast<__nv_bfloat16*>(out), M, N, Kc);
  } else if (out_dtype == 0) {
    q8mm_kernel<G, float><<<grid, NT, 0, s>>>(A, W, sr, sc, static_cast<float*>(out), M, N, Kc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = fp32, 1 = bf16. Both return cudaGetLastError() after the launch.

// out (T, O) = ((xq (T, K) . wq (O, K)^T) * sx (T,)) * sw (O,); K % 16 == 0.
extern "C" int smt_q8mm_t(const void* xq, const void* sx, const void* wq, const void* sw,
                          void* out, int T, int O, int K, int out_dtype, void* stream) {
  return launch<false>(xq, wq, sx, sw, out, T, O, K, out_dtype, stream);
}

// out (T, K) = (gq (T, O) . wq (O, K)) * sg (T,); O % 16 == 0 and K % 16 == 0.
extern "C" int smt_q8mm_g(const void* gq, const void* sg, const void* wq, void* out, int T,
                          int O, int K, int out_dtype, void* stream) {
  return launch<true>(gq, wq, sg, nullptr, out, T, K, O, out_dtype, stream);
}

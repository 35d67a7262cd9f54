// Tile constants and helpers shared by the attention kernels
// (attention.cu, K3; cached_attention.cu, K7): bf16 and fp16 tensor-core
// fragments for mma.sync m16n8k16 with fp32 accumulation (T = bf16 or f16:
// ldmatrix moves 16-bit elements of either), loaded with ldmatrix from
// shared tiles whose rows are padded by 16 bytes (conflict-free), cp.async
// copies, fp32 dot products, and the dynamic shared-memory opt-in.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int T64 = 64;          // rows per tile (queries or keys)
constexpr int NT_BF16 = 128;     // 4 warps
constexpr int NT_F32 = 256;      // 4 threads per row
constexpr int F32_BK = 32;       // keys per tile (fp32 paths)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `in` false writes 16 zero bytes
// and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col). Lane l
// holds rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1 of c.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with fp16 operands (fp32 accumulation)
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mma_bf16 or mma_f16 by the operands' type T
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same_v<T, f16>)
    mma_f16(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}

// A fragment: rows r0..r0+15, columns c0..c0+15 of a row-major tile (pitch ld).
template <typename T>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const T* base, int ld, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, base + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (n0, n0 + 8) and contraction k0..k0+15 from a
// tile stored [n][k] (a K or Q tile when the product contracts over hd):
// b[0], b[1] for n0; b[2], b[3] for n0 + 8.
template <typename T>
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const T* base, int ld, int n0,
                                        int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// ... from a tile stored [k][n] (V, dO, Q or K when the product contracts
// over the tile's rows), transposed by ldmatrix.
template <typename T>
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const T* base, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(b, base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// two fp32 values as bf16x2 (round to nearest even), the lower in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ... as fp16x2: round to nearest even, an overflow to inf, NaN kept (what
// torch's .half() and XLA's convert give; no saturation)
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, f16>) return pack_f16(lo, hi);
  return pack_bf16(lo, hi);
}

// The A fragment of a product over 16 columns kc*16.. of an accumulator
// held as 8-wide n-tiles c[2kc], c[2kc+1] (the accumulator's layout is the
// A operand's): P or dS goes from one mma to the next without shared memory,
// rounded to T.
template <typename T = bf16>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// Rows pos0 .. pos0+rows-1 of a 16-bit (bf16 or fp16) slice (consecutive
// positions row_stride elements apart) into a shared tile of pitch HD + 8
// by cp.async; rows at or past S are zero.
template <int HD, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, size_t row_stride,
                                                int pos0, int rows, int S) {
  constexpr int VPR = HD / 8, LD = HD + 8;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = pos0 + r < S;
    cp_async16(dst + r * LD + c, in ? src + (size_t)(pos0 + r) * row_stride + c : src, in);
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

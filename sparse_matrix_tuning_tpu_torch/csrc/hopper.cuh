// Hopper building blocks shared by the kernels that load through the Tensor
// Memory Accelerator (q8_matmul.cu, q4_matmul.cu): mbarriers, 2D TMA loads
// into shared memory with completion reported to an mbarrier, and the host
// side that encodes a TMA map (cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point, so the library does not link libcuda).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// p (in shared memory) advanced to the next multiple of 1024 bytes, by
// pointer arithmetic on p itself: the compiler still knows that the result
// points to shared memory and reads and writes through it with LDS / STS.
// (Rounding through an integer loses that, and every access becomes a
// generic LD / ST.)
__device__ __forceinline__ uint8_t* align_smem_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init of the CTA, before any thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of the given parity has completed (parity 1 passes on
// a fresh barrier: the producer's first wait on an empty slot)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// box at coordinates (c0 inner, c1 outer) of `map` into dst (1024-byte
// aligned for a swizzled map); its bytes complete a transaction on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// bar.sync on named barrier `id` (1-15) among n_threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int n_threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n_threads) : "memory");
}

// byte offset of (row, byte col) in a tile of 128-byte rows that a TMA load
// with the 128-byte swizzle wrote (16-byte chunk index XOR row % 8)
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a TMA map over a row-major matrix of `outer` rows of `inner` elements,
// boxes of box_inner x box_outer elements (box_inner * element size = 128
// bytes), 128-byte swizzle, zeros past the edges. False if it cannot be made.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem_bytes, const void* ptr,
                     int inner, int outer, int box_inner, int box_outer) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// set the dynamic shared memory limit of `kern` once per device; `done` is
// the caller's own flags (one array per kernel)
inline cudaError_t allow_smem(const void* kern, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace hopper

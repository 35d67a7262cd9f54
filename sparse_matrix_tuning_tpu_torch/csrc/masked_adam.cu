// K2 masked_adam: in-place Adam over the gathered (n, 256, 256) SMT blocks.
//
//   m = b1*m + (1-b1)*g;  v = b2*v + ((1-b2)*g)*g
//   p = p - lr * ((m/bc1) / (sqrt(v/bc2) + eps) + wd*p)
//   scalars (device fp32, 7) = [lr, b1, b2, eps, wd, bc1, bc2]
//
// Replaces the Pallas TPU kernel
//   sparse_matrix_tuning_tpu/ops/pallas/masked_adam.py fused_block_adam_impl
//   (_kernel), which updates p/m/v in place through input_output_aliases.
//
// What bounds it on the H100: memory. Each element reads 4 fp32 (p, g, m,
// v) and writes 3 (p, m, v), 28 bytes for ~15 FLOP. Design:
//   * one grid-stride pass with 16-byte float4 loads and stores, in place,
//     so every state tensor moves through HBM exactly once per step;
//   * the scalars stay in device memory (bias corrections are computed on
//     the device from the step count), so a step never waits on the host;
//   * every operation is an explicit round-to-nearest intrinsic, so the
//     compiler contracts nothing into FMA and the result equals the plain
//     PyTorch version (ops/cuda/masked_adam.py) operation for operation.

#include <cuda_runtime.h>

namespace {

struct AdamScalars {
  float lr, b1, b2, eps, wd, bc1, bc2, omb1, omb2;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v,
                                         const AdamScalars& s) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps);
  const float update = __fadd_rn(__fdiv_rn(__fdiv_rn(m, s.bc1), denom),
                                 __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, update));
}

__global__ void __launch_bounds__(256)
masked_adam_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                   float4* __restrict__ m, float4* __restrict__ v,
                   const float* __restrict__ scalars, int n4) {
  AdamScalars s;
  s.lr = scalars[0];
  s.b1 = scalars[1];
  s.b2 = scalars[2];
  s.eps = scalars[3];
  s.wd = scalars[4];
  s.bc1 = scalars[5];
  s.bc2 = scalars[6];
  s.omb1 = __fsub_rn(1.0f, s.b1);
  s.omb2 = __fsub_rn(1.0f, s.b2);
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n4;
       idx += gridDim.x * blockDim.x) {
    float4 P = p[idx];
    const float4 G = g[idx];
    float4 M = m[idx];
    float4 V = v[idx];
    adam_one(P.x, G.x, M.x, V.x, s);
    adam_one(P.y, G.y, M.y, V.y, s);
    adam_one(P.z, G.z, M.z, V.z, s);
    adam_one(P.w, G.w, M.w, V.w, s);
    p[idx] = P;
    m[idx] = M;
    v[idx] = V;
  }
}

}  // namespace

// numel must be a multiple of 4 and every pointer 16-byte aligned (the
// wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int smt_masked_adam(void* p, const void* g, void* m, void* v,
                               const void* scalars, int numel, void* stream) {
  const int n4 = numel / 4;
  if (n4 <= 0) return (int)cudaGetLastError();
  int blocks = (n4 + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  masked_adam_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(p), static_cast<const float4*>(g),
      static_cast<float4*>(m), static_cast<float4*>(v),
      static_cast<const float*>(scalars), n4);
  return (int)cudaGetLastError();
}

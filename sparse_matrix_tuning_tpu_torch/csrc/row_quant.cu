// K4's prologue: per-row symmetric int8 quantization in one launch.
//
//   v[t][k]  = float(x[t][k])              (or float(x[t][k]) * sw[k]: the
//                                             g form's fold of the weight scales)
//   sx[t]    = max(max_k |v[t][k]|, 1e-8) * fp32(1/127)
//   xq[t][k] = clamp(rint(v[t][k] / sx[t]), -127, 127)   (IEEE division,
//                                                          round half to even)
//   x (T, K) bf16, fp16 or fp32, sw (K,) fp32, xq (T, K) int8, sx (T,) fp32.
//
// Replaces what XLA fuses in front of the Pallas kernels q8mm_t_core /
// q8mm_g_core: sparse_matrix_tuning_tpu/ops/quant.py row_quant, run by
// ops/pallas/q8_matmul.py q8_matmul_t_fused / q8_matmul_fused under jit,
// which compiles it into one amax + quantize pass. The values equal the
// plain PyTorch row_quant bit for bit (and so jax.jit of the JAX twin):
// the scale is a product with the fp32 reciprocal, as XLA compiles the
// division by the constant 127; the quantization stays a division; every
// operation is a single IEEE-rounded fp32 operation (no fast math, no FMA
// contraction: __fmul_rn / __fdiv_rn). A NaN in a row makes its scale NaN
// (an inf makes it inf) and its int8 values 0, as in the plain version.
//
// What bounds it on the H100: bytes (x read once, xq and sx written once;
// a few operations per element). Design: one CTA per row; 16-byte loads
// where the row length allows; a first pass takes the row's amax (warp
// shuffles, then one value per warp through shared memory) and keeps the
// row in registers (1, 2 or 4 vectors a thread, as few as hold it: rows of
// up to 8192 bf16 or fp16 / 4096 fp32; longer rows are read again, from L1/L2);
// the second pass
// writes the int8 values, 8 or 4 bytes a thread a step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);  // as the plain version rounds it

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }  // exact

template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<__half> { static constexpr int N = 8; };
template <> struct Vec<float> { static constexpr int N = 4; };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[Vec<T>::N]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) f[i] = to_f32(v[i]);
}

// max that carries a NaN through, as torch.amax / clamp and XLA's max do
// (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// a NaN quotient (a NaN in the row, or inf / inf) converts to 0, as the
// plain version's clamp then cast to int8 gives it
__device__ __forceinline__ int8_t quant(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return q != q ? int8_t(0) : static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

template <typename T, bool FOLD, int HELD>
__global__ void __launch_bounds__(NT)
row_quant_kernel(const T* __restrict__ x, const float* __restrict__ sw, int8_t* __restrict__ xq,
                 float* __restrict__ sx, int K) {
  constexpr int V = Vec<T>::N;
  __shared__ float warp_max[NT / 32];
  __shared__ float s_scale;
  const int tid = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = xq + (size_t)blockIdx.x * K;
  const bool vec = (K % V) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  // the vector path keeps up to HELD vectors a thread in registers between
  // the passes (rows up to NT * V * HELD elements)
  const bool held = vec && K <= NT * V * HELD;
  float f[HELD][V];
  float amax = 0.f;
  if (vec) {
#pragma unroll
    for (int h = 0; h < HELD; ++h) {
      const int c = (h * NT + tid) * V;
      if (c < K) {
        load_vec(xr + c, f[h]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if (FOLD) f[h][i] = __fmul_rn(f[h][i], __ldg(sw + c + i));
          amax = nan_max(amax, fabsf(f[h][i]));
        }
      }
    }
    for (int c = (HELD * NT + tid) * V; c < K; c += NT * V) {  // rows past the held part
      float g[V];
      load_vec(xr + c, g);
#pragma unroll
      for (int i = 0; i < V; ++i)
        amax = nan_max(amax, fabsf(FOLD ? __fmul_rn(g[i], __ldg(sw + c + i)) : g[i]));
    }
  } else {
    for (int c = tid; c < K; c += NT) {
      const float v = FOLD ? __fmul_rn(to_f32(xr[c]), __ldg(sw + c)) : to_f32(xr[c]);
      amax = nan_max(amax, fabsf(v));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (tid % 32 == 0) warp_max[tid / 32] = amax;
  __syncthreads();
  if (tid == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) m = nan_max(m, warp_max[w]);
    const float s = __fmul_rn(nan_max(m, 1e-8f), kInv127);
    s_scale = s;
    sx[blockIdx.x] = s;
  }
  __syncthreads();
  const float s = s_scale;

  auto store_vec = [&](int c, const float (&v)[V]) {
    int8_t q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) q[i] = quant(v[i], s);
    if (V == 8)
      *reinterpret_cast<uint2*>(qr + c) = *reinterpret_cast<const uint2*>(q);
    else
      *reinterpret_cast<uint32_t*>(qr + c) = *reinterpret_cast<const uint32_t*>(q);
  };
  if (held) {
#pragma unroll
    for (int h = 0; h < HELD; ++h) {
      const int c = (h * NT + tid) * V;
      if (c < K) store_vec(c, f[h]);
    }
  } else if (vec) {
    for (int c = tid * V; c < K; c += NT * V) {
      float g[V];
      load_vec(xr + c, g);
      if (FOLD) {
#pragma unroll
        for (int i = 0; i < V; ++i) g[i] = __fmul_rn(g[i], __ldg(sw + c + i));
      }
      store_vec(c, g);
    }
  } else {
    for (int c = tid; c < K; c += NT) {
      const float v = FOLD ? __fmul_rn(to_f32(xr[c]), __ldg(sw + c)) : to_f32(xr[c]);
      qr[c] = quant(v, s);
    }
  }
}

template <typename T, int HELD>
void launch_held(const T* xp, const float* swp, int8_t* qp, float* sp, int rows, int K,
                 cudaStream_t s) {
  if (swp)
    row_quant_kernel<T, true, HELD><<<rows, NT, 0, s>>>(xp, swp, qp, sp, K);
  else
    row_quant_kernel<T, false, HELD><<<rows, NT, 0, s>>>(xp, nullptr, qp, sp, K);
}

// the fewest registers that hold the row (fewer registers, more rows in
// flight): 1, 2 or 4 vectors a thread
template <typename T>
void launch(const void* x, const void* sw, void* xq, void* sx, int rows, int K, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const float* swp = static_cast<const float*>(sw);
  int8_t* qp = static_cast<int8_t*>(xq);
  float* sp = static_cast<float*>(sx);
  constexpr int ROW = NT * Vec<T>::N;  // elements one vector a thread covers
  if (K <= ROW)
    launch_held<T, 1>(xp, swp, qp, sp, rows, K, s);
  else if (K <= 2 * ROW)
    launch_held<T, 2>(xp, swp, qp, sp, rows, K, s);
  else
    launch_held<T, 4>(xp, swp, qp, sp, rows, K, s);
}

}  // namespace

// xq (T, K) int8, sx (T,) fp32 = row_quant(x (T, K)) or, with sw (K,) fp32
// not null, row_quant(x * sw). dtype: 0 = fp32 x, 1 = bf16 x, 2 = fp16 x (its
// values widen to fp32 exactly, as bf16's do); xq 8-byte
// aligned (16-byte vectors are used where x's alignment and K allow).
// Returns cudaGetLastError() after the launch.
extern "C" int smt_row_quant(const void* x, const void* sw, void* xq, void* sx, int T, int K,
                             int dtype, void* stream) {
  if (T < 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(x, sw, xq, sx, T, K, s);
  else if (dtype == 2)
    launch<__half>(x, sw, xq, sx, T, K, s);
  else if (dtype == 0)
    launch<float>(x, sw, xq, sx, T, K, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

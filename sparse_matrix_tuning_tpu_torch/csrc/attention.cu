// K3 fullk attention: causal grouped-query softmax attention for training,
// forward and backward.
//
//   o[b,i,h,:] = sum_{j<=i} softmax_j(q[b,i,h,:] . k[b,j,h/g,:] * sm) v[b,j,h/g,:]
//   q, o: (B, S, Hq, hd); k, v: (B, S, Hkv, hd); g = Hq / Hkv, so q-head h
//   reads kv-head h / g (the JAX grouping head = kv_head * g + group).
//   lse, delta: (B, Hq, S) fp32. bf16 or fp32 inputs, hd in {64, 128}.
//
// Replaces the Pallas TPU kernels
//   sparse_matrix_tuning_tpu/ops/pallas/attention.py _fullk_fwd_impl
//   (_fwd_kernel) and _fullk_bwd_impl (_bwd_kernel), and serves the stock
//   Pallas flash attention behind models/llama.py _flash_attention, which
//   computes the same causal attention.
//
// The Pallas kernels keep the whole K/V row of one (batch, kv-head) in
// VMEM and revisit the dK/dV output block along a grid that runs in order.
// Neither carries over: at S = 2048, hd = 64, K and V of one row are 512 KiB
// against 227 KB of shared memory, and CTAs run in parallel in no order.
//
// What bounds it on the H100: the score matrix. The einsum path writes and
// re-reads b*hq*S*S fp32 scores and probabilities in device memory; here
// they live only in shared memory, 64x64 tiles at a time, so device traffic
// is O(S*hd) per (batch, head) and the kernels are bound by tensor-core
// instruction throughput, the exp of the softmax and the shared-memory
// round trips of WMMA.
// Design (FlashAttention-2 style, simple first):
//   * attn_fwd: one CTA per (64-query tile, q-head, batch), 4 warps of 16
//     query rows. It loops over 64-key tiles up to the causal diagonal
//     (tiles wholly above it are skipped), keeps an online softmax (running
//     max m and sum l per row, fp32) and an fp32 O tile in shared memory,
//     casts P to the input dtype before P.V (as attention.py:83), and
//     writes O and lse = m + log l.
//   * attn_bwd_delta: delta = rowsum(dO * O) in fp32, one warp per row.
//   * attn_bwd_dkdv: one CTA per (64-key tile, kv-head, batch). It loops
//     over the g q-heads of its group and the q tiles from the diagonal to
//     the end, recomputes P = exp(S*sm - lse), and accumulates dV += P^T dO
//     and dK += dS^T Q in fp32, dS = P (dP - delta) sm cast to the input
//     dtype (attention.py:112). It writes dK and dV once.
//   * attn_bwd_dq: one CTA per (64-query tile, q-head, batch), dQ += dS K
//     over the key tiles up to the diagonal.
//   Every CTA owns its outputs: no atomics, and the result is the same bit
//   for bit from run to run. Ragged S is masked in the loads (zero rows)
//   and in the scores; nothing is padded or transposed in device memory.
//   The attention mask is ignored, as in the JAX kernel: pad keys of a
//   right-padded batch are masked by causality alone.
//   bf16: tensor cores through WMMA 16x16x16 fragments with fp32
//   accumulation, scores staged in shared memory for the row-wise softmax.
//   fp32: CUDA-core FMAs, 256 threads, four threads per row.
// Not yet: wgmma/TMA, cp.async pipelining, splitting dK/dV over q-heads.

#include <math.h>
#include <stdint.h>

#include "tiles.cuh"

namespace {

constexpr int F32_BQ = 32;       // queries per tile (fp32 dkdv)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows pos0 .. pos0+rows-1 of one (batch, head) slice into shared memory
// with pitch ld; rows at or past S are zero. src points at position 0 of the
// slice; consecutive positions are row_stride elements apart.
template <int HD>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, int ld, const bf16* src,
                                               size_t row_stride, int pos0, int rows,
                                               int S) {
  constexpr int VPR = HD / 8;  // uint4 = 8 bf16
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pos0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(pos0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src,
                                              size_t row_stride, int pos0, int rows,
                                              int S) {
  constexpr int VPR = HD / 4;  // float4
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (size_t)(pos0 + r) * row_stride + c);
    float* d = dst + r * ld + c;  // ld = HD + 1: no vector store
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// (per-(b,h) vector) lse / delta of positions pos0.. into shared memory;
// positions at or past S read 0.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int pos0, int n,
                                         int S) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = (pos0 + i < S) ? src[pos0 + i] : 0.f;
}

__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// One warp's 16 rows of an fp32 staging tile (pitch HD + 4), times
// row_scale[row] when given, cast to the output dtype and written to
// positions pos0 + row0 .. of one slice.
template <int HD, typename T>
__device__ __forceinline__ void store_warp_rows(T* dst, size_t row_stride, const float* st,
                                                int row0, int pos0, int S,
                                                const float* row_scale) {
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < 16 * HD; i += 32) {
    const int r = row0 + i / HD;
    const int c = i % HD;
    if (pos0 + r < S) {
      const float x = st[r * (HD + 4) + c];
      put(dst + (size_t)(pos0 + r) * row_stride + c, row_scale ? x * row_scale[r] : x);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: WMMA
// ---------------------------------------------------------------------------

template <int HD>
struct Bf16Smem {
  static constexpr int LD = HD + 8;                            // bf16 row pitch
  static constexpr size_t kTile = (size_t)T64 * LD * 2;        // 64 x hd bf16
  static constexpr size_t kF32 = (size_t)T64 * SLD * 4;        // 64 x 64 fp32
  static constexpr size_t kBf = (size_t)T64 * PLD * 2;         // 64 x 64 bf16
  static constexpr size_t kOut = (size_t)T64 * (HD + 4) * 4;   // 64 x hd fp32
  // fwd: Q K V | S | P | O | 1/l
  static constexpr size_t fwd = 3 * kTile + kF32 + kBf + kOut + T64 * 4;
  // dq: Q dO K V | S dP (also the dQ staging) | dS
  static constexpr size_t dq = 4 * kTile + 2 * kF32 + kBf;
  // dkdv: K V Q dO | S^T dP^T (also the dK/dV staging) | P^T dS^T | lse delta
  static constexpr size_t dkdv = 4 * kTile + 2 * kF32 + 2 * kBf + 2 * T64 * 4;
  static_assert(2 * kF32 >= kOut, "staging must fit in the two fp32 score tiles");
};

template <int HD>
__global__ void __launch_bounds__(NT_BF16)
attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
              int S, int Hq, int Hkv, float sm) {
  using L = Bf16Smem<HD>;
  constexpr int LD = L::LD, OLD = HD + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + T64 * LD;
  bf16* Vs = Ks + T64 * LD;
  float* Ss = reinterpret_cast<float*>(Vs + T64 * LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + T64 * SLD);
  float* Os = reinterpret_cast<float*>(Ps + T64 * PLD);
  float* inv_l = Os + T64 * OLD;

  const int nq = (S + T64 - 1) / T64;
  const int qt = nq - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const bf16* qb = q + ((size_t)b * S * Hq + h) * HD;
  const bf16* kb = k + ((size_t)b * S * Hkv + hk) * HD;
  const bf16* vb = v + ((size_t)b * S * Hkv + hk) * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int qpos = q0 + row;

  load_rows_bf16<HD>(Qs, LD, qb, qrs, q0, T64, S);
  for (int i = threadIdx.x; i < T64 * OLD; i += NT_BF16) Os[i] = 0.f;
  __syncthreads();
  FragA qf[HD / 16];
#pragma unroll
  for (int d = 0; d < HD / 16; ++d)
    wmma::load_matrix_sync(qf[d], Qs + warp * 16 * LD + d * 16, LD);

  float m = -INFINITY, l = 0.f;
  float* srow = Ss + row * SLD;
  bf16* prow = Ps + row * PLD;
  float* orow = Os + row * OLD;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * T64;
    load_rows_bf16<HD>(Ks, LD, kb, krs, k0, T64, S);
    load_rows_bf16<HD>(Vs, LD, vb, krs, k0, T64, S);
    __syncthreads();
    scores_16x64<HD>(Ss + warp * 16 * SLD, qf, Ks);
    __syncwarp();

    // online softmax over this tile; lanes 2r, 2r+1 share row r, columns
    // interleaved. A masked score is -inf, so a tile wholly masked for a
    // row contributes exactly 0 and leaves m and l as they were.
    float sv[T64 / 2];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < T64 / 2; ++j) {
      const int kpos = k0 + 2 * j + half;
      float x = srow[2 * j + half] * sm;
      if (kpos > qpos || kpos >= S) x = -INFINITY;
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float mnew = fmaxf(m, tmax);
    const float muse = (mnew == -INFINITY) ? 0.f : mnew;
    const float alpha = expf(m - muse);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < T64 / 2; ++j) {
      const float p = expf(sv[j] - muse);
      psum += p;
      prow[2 * j + half] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = mnew;
#pragma unroll 8
    for (int j = 0; j < HD / 2; ++j) orow[2 * j + half] *= alpha;
    __syncwarp();

    // O_w += P_w V
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      FragC c;
      float* optr = Os + warp * 16 * OLD + n * 16;
      wmma::load_matrix_sync(c, optr, OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < T64 / 16; ++kk) {
        FragA a;
        FragBr bv;
        wmma::load_matrix_sync(a, Ps + warp * 16 * PLD + kk * 16, PLD);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(c, a, bv, c);
      }
      wmma::store_matrix_sync(optr, c, OLD, wmma::mem_row_major);
    }
    __syncthreads();  // Ks / Vs are reloaded
  }

  // key 0 is causal for every row, so l > 0
  if (half == 0) {
    inv_l[row] = 1.f / l;
    if (qpos < S) lse[((size_t)b * Hq + h) * S + qpos] = m + logf(l);
  }
  __syncwarp();
  store_warp_rows<HD>(o + ((size_t)b * S * Hq + h) * HD, qrs, Os, warp * 16, q0, S, inv_l);
}

template <int HD>
__global__ void __launch_bounds__(NT_BF16)
attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int S, int Hq, int Hkv, float sm) {
  using L = Bf16Smem<HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + T64 * LD;
  bf16* Ks = dOs + T64 * LD;
  bf16* Vs = Ks + T64 * LD;
  float* Ss = reinterpret_cast<float*>(Vs + T64 * LD);
  float* dPs = Ss + T64 * SLD;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + T64 * SLD);

  const int nq = (S + T64 - 1) / T64;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const size_t qoff = ((size_t)b * S * Hq + h) * HD;
  const bf16* kb = k + ((size_t)b * S * Hkv + hk) * HD;
  const bf16* vb = v + ((size_t)b * S * Hkv + hk) * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int qpos = q0 + row;
  const size_t vec = ((size_t)b * Hq + h) * S;
  const float lse_r = qpos < S ? lse[vec + qpos] : 0.f;
  const float d_r = qpos < S ? delta[vec + qpos] : 0.f;

  load_rows_bf16<HD>(Qs, LD, q + qoff, qrs, q0, T64, S);
  load_rows_bf16<HD>(dOs, LD, dout + qoff, qrs, q0, T64, S);
  __syncthreads();
  FragA qf[HD / 16], df[HD / 16];
  FragC acc[HD / 16];
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) {
    wmma::load_matrix_sync(qf[d], Qs + warp * 16 * LD + d * 16, LD);
    wmma::load_matrix_sync(df[d], dOs + warp * 16 * LD + d * 16, LD);
    wmma::fill_fragment(acc[d], 0.0f);
  }

  const float* srow = Ss + row * SLD;
  const float* dprow = dPs + row * SLD;
  bf16* dsrow = dSs + row * PLD;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * T64;
    load_rows_bf16<HD>(Ks, LD, kb, krs, k0, T64, S);
    load_rows_bf16<HD>(Vs, LD, vb, krs, k0, T64, S);
    __syncthreads();
    scores_16x64<HD>(Ss + warp * 16 * SLD, qf, Ks);   // S = Q K^T
    scores_16x64<HD>(dPs + warp * 16 * SLD, df, Vs);  // dP = dO V^T
    __syncwarp();
#pragma unroll
    for (int j = 0; j < T64 / 2; ++j) {
      const int c = 2 * j + half;
      const int kpos = k0 + c;
      const bool ok = kpos <= qpos && kpos < S && qpos < S;
      const float p = ok ? expf(srow[c] * sm - lse_r) : 0.f;
      dsrow[c] = __float2bfloat16(p * (dprow[c] - d_r) * sm);
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < T64 / 16; ++kk) {
        FragA a;
        FragBr bk;
        wmma::load_matrix_sync(a, dSs + warp * 16 * PLD + kk * 16, PLD);
        wmma::load_matrix_sync(bk, Ks + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(acc[n], a, bk, acc[n]);
      }
    }
    __syncthreads();
  }

  float* st = Ss;  // staging, pitch HD + 4, over the two fp32 tiles
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(st + warp * 16 * (HD + 4) + n * 16, acc[n], HD + 4,
                            wmma::mem_row_major);
  __syncwarp();
  store_warp_rows<HD>(dq + qoff, qrs, st, warp * 16, q0, S, nullptr);
}

template <int HD>
__global__ void __launch_bounds__(NT_BF16)
attn_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Hq, int Hkv,
                   float sm) {
  using L = Bf16Smem<HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + T64 * LD;
  bf16* Qs = Vs + T64 * LD;
  bf16* dOs = Qs + T64 * LD;
  float* STs = reinterpret_cast<float*>(dOs + T64 * LD);
  float* dPTs = STs + T64 * SLD;
  bf16* PTs = reinterpret_cast<bf16*>(dPTs + T64 * SLD);
  bf16* dSTs = PTs + T64 * PLD;
  float* lse_s = reinterpret_cast<float*>(dSTs + T64 * PLD);
  float* d_s = lse_s + T64;

  const int nq = (S + T64 - 1) / T64;
  const int kt = blockIdx.x;  // the longest columns first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv;
  const int k0 = kt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const size_t koff = ((size_t)b * S * Hkv + hk) * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int krow = warp * 16 + lane / 2, half = lane & 1;
  const int kpos = k0 + krow;

  load_rows_bf16<HD>(Ks, LD, k + koff, krs, k0, T64, S);
  load_rows_bf16<HD>(Vs, LD, v + koff, krs, k0, T64, S);
  FragC dkacc[HD / 16], dvacc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dkacc[n], 0.0f);
    wmma::fill_fragment(dvacc[n], 0.0f);
  }

  const float* strow = STs + krow * SLD;
  const float* dptrow = dPTs + krow * SLD;
  bf16* ptrow = PTs + krow * PLD;
  bf16* dstrow = dSTs + krow * PLD;
  for (int j = 0; j < g; ++j) {
    const int h = hk * g + j;
    const size_t qoff = ((size_t)b * S * Hq + h) * HD;
    const size_t vec = ((size_t)b * Hq + h) * S;
    for (int qt = kt; qt < nq; ++qt) {
      const int q0 = qt * T64;
      load_rows_bf16<HD>(Qs, LD, q + qoff, qrs, q0, T64, S);
      load_rows_bf16<HD>(dOs, LD, dout + qoff, qrs, q0, T64, S);
      load_vec(lse_s, lse + vec, q0, T64, S);
      load_vec(d_s, delta + vec, q0, T64, S);
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 64 queries
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        FragC c, e;
        wmma::fill_fragment(c, 0.0f);
        wmma::fill_fragment(e, 0.0f);
#pragma unroll
        for (int d = 0; d < HD / 16; ++d) {
          FragA a;
          FragBc bq;
          wmma::load_matrix_sync(a, Ks + warp * 16 * LD + d * 16, LD);
          wmma::load_matrix_sync(bq, Qs + n * 16 * LD + d * 16, LD);
          wmma::mma_sync(c, a, bq, c);
          wmma::load_matrix_sync(a, Vs + warp * 16 * LD + d * 16, LD);
          wmma::load_matrix_sync(bq, dOs + n * 16 * LD + d * 16, LD);
          wmma::mma_sync(e, a, bq, e);
        }
        wmma::store_matrix_sync(STs + warp * 16 * SLD + n * 16, c, SLD, wmma::mem_row_major);
        wmma::store_matrix_sync(dPTs + warp * 16 * SLD + n * 16, e, SLD, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < T64 / 2; ++jj) {
        const int c = 2 * jj + half;
        const int qpos = q0 + c;
        const bool ok = kpos <= qpos && qpos < S && kpos < S;
        const float p = ok ? expf(strow[c] * sm - lse_s[c]) : 0.f;
        ptrow[c] = __float2bfloat16(p);
        dstrow[c] = __float2bfloat16(p * (dptrow[c] - d_s[c]) * sm);
      }
      __syncwarp();
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < T64 / 16; ++kk) {
          FragA a;
          FragBr bm;
          wmma::load_matrix_sync(a, PTs + warp * 16 * PLD + kk * 16, PLD);
          wmma::load_matrix_sync(bm, dOs + kk * 16 * LD + n * 16, LD);
          wmma::mma_sync(dvacc[n], a, bm, dvacc[n]);
          wmma::load_matrix_sync(a, dSTs + warp * 16 * PLD + kk * 16, PLD);
          wmma::load_matrix_sync(bm, Qs + kk * 16 * LD + n * 16, LD);
          wmma::mma_sync(dkacc[n], a, bm, dkacc[n]);
        }
      }
      __syncthreads();
    }
  }

  float* st = STs;  // staging, pitch HD + 4, over the two fp32 tiles
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(st + warp * 16 * (HD + 4) + n * 16, dkacc[n], HD + 4,
                            wmma::mem_row_major);
  __syncwarp();
  store_warp_rows<HD>(dk + koff, krs, st, warp * 16, k0, S, nullptr);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(st + warp * 16 * (HD + 4) + n * 16, dvacc[n], HD + 4,
                            wmma::mem_row_major);
  __syncwarp();
  store_warp_rows<HD>(dv + koff, krs, st, warp * 16, k0, S, nullptr);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs. Thread t owns tile row t / 4; the four threads of a
// row (neighbouring lanes) split its columns, interleaved, and meet through
// shuffles and a shared-memory row. Shared rows have pitch hd + 1.
// ---------------------------------------------------------------------------

template <int HD>
struct F32Smem {
  static constexpr int LD = HD + 1;
  static constexpr int PL = F32_BK + 1;
  // fwd: Q (64) | K V (32) | P (64 x 32)
  static constexpr size_t fwd = ((size_t)T64 * LD + 2 * F32_BK * LD + T64 * PL) * 4;
  // dq: Q dO (64) | K V (32) | dS (64 x 32)
  static constexpr size_t dq = ((size_t)2 * T64 * LD + 2 * F32_BK * LD + T64 * PL) * 4;
  // dkdv: K V (64) | Q dO (32) | P^T dS^T (64 x 32) | lse delta (32)
  static constexpr size_t dkdv =
      ((size_t)2 * T64 * LD + 2 * F32_BQ * LD + 2 * T64 * PL + 2 * F32_BQ) * 4;
};

template <int HD>
__global__ void __launch_bounds__(NT_F32)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
             int S, int Hq, int Hkv, float sm) {
  using L = F32Smem<HD>;
  constexpr int LD = L::LD, PL = L::PL, NJ = F32_BK / 4, NO = HD / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + T64 * LD;
  float* Vs = Ks + F32_BK * LD;
  float* Ps = Vs + F32_BK * LD;

  const int nq = (S + T64 - 1) / T64;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const size_t qoff = ((size_t)b * S * Hq + h) * HD;
  const float* kb = k + ((size_t)b * S * Hkv + hk) * HD;
  const float* vb = v + ((size_t)b * S * Hkv + hk) * HD;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const int qpos = q0 + r;

  load_rows_f32<HD>(Qs, LD, q + qoff, qrs, q0, T64, S);
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int n_kt = min((S + F32_BK - 1) / F32_BK, (q0 + T64 - 1) / F32_BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * F32_BK;
    __syncthreads();  // the previous tile's readers are done
    load_rows_f32<HD>(Ks, LD, kb, krs, k0, F32_BK, S);
    load_rows_f32<HD>(Vs, LD, vb, krs, k0, F32_BK, S);
    __syncthreads();
    float s[NJ];
    dots<NJ, HD>(s, Qs + r * LD, Ks + part * LD, 4 * LD);  // keys part + 4j
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kpos = k0 + part + 4 * j;
      s[j] = (kpos > qpos || kpos >= S) ? -INFINITY : s[j] * sm;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float mnew = fmaxf(m, tmax);
    const float muse = (mnew == -INFINITY) ? 0.f : mnew;
    const float alpha = expf(m - muse);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = expf(s[j] - muse);
      psum += p;
      Ps[r * PL + part + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = mnew;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= alpha;
    for (int c = 0; c < F32_BK; ++c) {
      const float p = Ps[r * PL + c];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = fmaf(p, Vs[c * LD + part + 4 * i], acc[i]);
    }
  }
  if (qpos < S) {
    const float inv = 1.f / l;
    float* orow = o + qoff + (size_t)qpos * qrs;
#pragma unroll
    for (int i = 0; i < NO; ++i) orow[part + 4 * i] = acc[i] * inv;
    if (part == 0) lse[((size_t)b * Hq + h) * S + qpos] = m + logf(l);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT_F32)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int S, int Hq, int Hkv, float sm) {
  using L = F32Smem<HD>;
  constexpr int LD = L::LD, PL = L::PL, NJ = F32_BK / 4, NO = HD / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + T64 * LD;
  float* Ks = dOs + T64 * LD;
  float* Vs = Ks + F32_BK * LD;
  float* dSs = Vs + F32_BK * LD;

  const int nq = (S + T64 - 1) / T64;
  const int qt = nq - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const size_t qoff = ((size_t)b * S * Hq + h) * HD;
  const float* kb = k + ((size_t)b * S * Hkv + hk) * HD;
  const float* vb = v + ((size_t)b * S * Hkv + hk) * HD;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const int qpos = q0 + r;
  const size_t vec = ((size_t)b * Hq + h) * S;
  const float lse_r = qpos < S ? lse[vec + qpos] : 0.f;
  const float d_r = qpos < S ? delta[vec + qpos] : 0.f;

  load_rows_f32<HD>(Qs, LD, q + qoff, qrs, q0, T64, S);
  load_rows_f32<HD>(dOs, LD, dout + qoff, qrs, q0, T64, S);
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  const int n_kt = min((S + F32_BK - 1) / F32_BK, (q0 + T64 - 1) / F32_BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * F32_BK;
    __syncthreads();
    load_rows_f32<HD>(Ks, LD, kb, krs, k0, F32_BK, S);
    load_rows_f32<HD>(Vs, LD, vb, krs, k0, F32_BK, S);
    __syncthreads();
    float s[NJ], dp[NJ];
    dots<NJ, HD>(s, Qs + r * LD, Ks + part * LD, 4 * LD);
    dots<NJ, HD>(dp, dOs + r * LD, Vs + part * LD, 4 * LD);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int kpos = k0 + part + 4 * j;
      const bool ok = kpos <= qpos && kpos < S && qpos < S;
      const float p = ok ? expf(s[j] * sm - lse_r) : 0.f;
      dSs[r * PL + part + 4 * j] = p * (dp[j] - d_r) * sm;
    }
    __syncwarp();
    for (int c = 0; c < F32_BK; ++c) {
      const float ds = dSs[r * PL + c];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = fmaf(ds, Ks[c * LD + part + 4 * i], acc[i]);
    }
  }
  if (qpos < S) {
    float* row = dq + qoff + (size_t)qpos * qrs;
#pragma unroll
    for (int i = 0; i < NO; ++i) row[part + 4 * i] = acc[i];
  }
}

template <int HD>
__global__ void __launch_bounds__(NT_F32)
attn_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int S, int Hq, int Hkv,
                  float sm) {
  using L = F32Smem<HD>;
  constexpr int LD = L::LD, PL = L::PL, NJ = F32_BQ / 4, NO = HD / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + T64 * LD;
  float* Qs = Vs + T64 * LD;
  float* dOs = Qs + F32_BQ * LD;
  float* PTs = dOs + F32_BQ * LD;
  float* dSTs = PTs + T64 * PL;
  float* lse_s = dSTs + T64 * PL;
  float* d_s = lse_s + F32_BQ;

  const int kt = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = Hq / Hkv;
  const int k0 = kt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const size_t koff = ((size_t)b * S * Hkv + hk) * HD;
  const int c = threadIdx.x / 4, part = threadIdx.x % 4;  // key row c
  const int kpos = k0 + c;
  const int nqt = (S + F32_BQ - 1) / F32_BQ;

  load_rows_f32<HD>(Ks, LD, k + koff, krs, k0, T64, S);
  load_rows_f32<HD>(Vs, LD, v + koff, krs, k0, T64, S);
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
  for (int j = 0; j < g; ++j) {
    const int h = hk * g + j;
    const size_t qoff = ((size_t)b * S * Hq + h) * HD;
    const size_t vec = ((size_t)b * Hq + h) * S;
    for (int qt = k0 / F32_BQ; qt < nqt; ++qt) {
      const int q0 = qt * F32_BQ;
      __syncthreads();
      load_rows_f32<HD>(Qs, LD, q + qoff, qrs, q0, F32_BQ, S);
      load_rows_f32<HD>(dOs, LD, dout + qoff, qrs, q0, F32_BQ, S);
      load_vec(lse_s, lse + vec, q0, F32_BQ, S);
      load_vec(d_s, delta + vec, q0, F32_BQ, S);
      __syncthreads();
      float s[NJ], dp[NJ];
      dots<NJ, HD>(s, Ks + c * LD, Qs + part * LD, 4 * LD);   // queries part + 4j
      dots<NJ, HD>(dp, Vs + c * LD, dOs + part * LD, 4 * LD);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int qi = part + 4 * jj;
        const int qpos = q0 + qi;
        const bool ok = kpos <= qpos && qpos < S && kpos < S;
        const float p = ok ? expf(s[jj] * sm - lse_s[qi]) : 0.f;
        PTs[c * PL + qi] = p;
        dSTs[c * PL + qi] = p * (dp[jj] - d_s[qi]) * sm;
      }
      __syncwarp();
      for (int qi = 0; qi < F32_BQ; ++qi) {
        const float p = PTs[c * PL + qi];
        const float ds = dSTs[c * PL + qi];
#pragma unroll
        for (int i = 0; i < NO; ++i) {
          dva[i] = fmaf(p, dOs[qi * LD + part + 4 * i], dva[i]);
          dka[i] = fmaf(ds, Qs[qi * LD + part + 4 * i], dka[i]);
        }
      }
    }
  }
  if (kpos < S) {
    float* krow = dk + koff + (size_t)kpos * krs;
    float* vrow = dv + koff + (size_t)kpos * krs;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      krow[part + 4 * i] = dka[i];
      vrow[part + 4 * i] = dva[i];
    }
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O), fp32, one warp per (b, s, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int S, int Hq, int HD, int n_rows) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const T* orow = o + (size_t)row * HD;
  const T* drow = dout + (size_t)row * HD;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int bs = row / Hq, h = row % Hq;
    const int b = bs / S, s = bs % S;
    delta[((size_t)b * Hq + h) * S + s] = acc;
  }
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int S, int Hq, int Hkv, float sm, int dtype, cudaStream_t s) {
  const dim3 grid((S + T64 - 1) / T64, Hq, B);
  cudaError_t err;
  if (dtype == 1) {
    const size_t bytes = Bf16Smem<HD>::fwd;
    if ((err = allow_smem(attn_fwd_bf16<HD>, bytes)) != cudaSuccess) return err;
    attn_fwd_bf16<HD><<<grid, NT_BF16, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), S, Hq, Hkv, sm);
  } else {
    const size_t bytes = F32Smem<HD>::fwd;
    if ((err = allow_smem(attn_fwd_f32<HD>, bytes)) != cudaSuccess) return err;
    attn_fwd_f32<HD><<<grid, NT_F32, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), S,
        Hq, Hkv, sm);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int B, int S, int Hq,
                      int Hkv, float sm, int dtype, cudaStream_t s) {
  const dim3 grid((S + T64 - 1) / T64, Hq, B);
  cudaError_t err;
  if (dtype == 1) {
    const size_t bytes = Bf16Smem<HD>::dq;
    if ((err = allow_smem(attn_bwd_dq_bf16<HD>, bytes)) != cudaSuccess) return err;
    attn_bwd_dq_bf16<HD><<<grid, NT_BF16, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), S, Hq, Hkv, sm);
  } else {
    const size_t bytes = F32Smem<HD>::dq;
    if ((err = allow_smem(attn_bwd_dq_f32<HD>, bytes)) != cudaSuccess) return err;
    attn_bwd_dq_f32<HD><<<grid, NT_F32, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), S, Hq, Hkv, sm);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int B, int S,
                        int Hq, int Hkv, float sm, int dtype, cudaStream_t s) {
  const dim3 grid((S + T64 - 1) / T64, Hkv, B);
  cudaError_t err;
  if (dtype == 1) {
    const size_t bytes = Bf16Smem<HD>::dkdv;
    if ((err = allow_smem(attn_bwd_dkdv_bf16<HD>, bytes)) != cudaSuccess) return err;
    attn_bwd_dkdv_bf16<HD><<<grid, NT_BF16, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S,
        Hq, Hkv, sm);
  } else {
    const size_t bytes = F32Smem<HD>::dkdv;
    if ((err = allow_smem(attn_bwd_dkdv_f32<HD>, bytes)) != cudaSuccess) return err;
    attn_bwd_dkdv_f32<HD><<<grid, NT_F32, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv, sm);
  }
  return cudaGetLastError();
}

bool bad_args(int B, int S, int Hq, int Hkv, int hd, int dtype) {
  return B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (hd != 64 && hd != 128) ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; hd in {64, 128}. Each returns
// cudaGetLastError() after its launch (or the error that refused it).
extern "C" int smt_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int S, int Hq, int Hkv, int hd, float sm, int dtype,
                            void* stream) {
  if (bad_args(B, S, Hq, Hkv, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 64 ? launch_fwd<64>(q, k, v, o, lse, B, S, Hq, Hkv, sm, dtype, s)
                        : launch_fwd<128>(q, k, v, o, lse, B, S, Hq, Hkv, sm, dtype, s));
}

extern "C" int smt_attn_bwd_delta(const void* o, const void* dout, void* delta, int B, int S,
                                  int Hq, int hd, int dtype, void* stream) {
  if (bad_args(B, S, Hq, 1, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rows = B * S * Hq;
  const dim3 grid((n_rows + 3) / 4);
  if (dtype == 1)
    attn_bwd_delta_kernel<bf16><<<grid, 128, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
        static_cast<float*>(delta), S, Hq, hd, n_rows);
  else
    attn_bwd_delta_kernel<float><<<grid, 128, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), S, Hq, hd, n_rows);
  return (int)cudaGetLastError();
}

extern "C" int smt_attn_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int B, int S, int Hq, int Hkv, int hd,
                                 float sm, int dtype, void* stream) {
  if (bad_args(B, S, Hq, Hkv, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 64
                   ? launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, Hq, Hkv, sm,
                                     dtype, s)
                   : launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, Hq, Hkv, sm,
                                      dtype, s));
}

extern "C" int smt_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int B, int S,
                               int Hq, int Hkv, int hd, float sm, int dtype, void* stream) {
  if (bad_args(B, S, Hq, Hkv, hd, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 64 ? launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv, sm,
                                        dtype, s)
                        : launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, Hq, Hkv, sm,
                                         dtype, s));
}

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
// What bounds it on the H100: the causal score matrix's products on the
// tensor cores (4 hd flops per (query, key) pair forward, 8 for dK/dV, 6
// for dQ) and the softmax's exp; device traffic is O(S * hd) per (batch,
// head), since scores never leave the SM. At the training shapes the
// bound is bytes (each input read once), but the time goes to issuing
// mma/exp instructions and to keeping enough of them in flight.
// Design (FlashAttention-2 style, bf16):
//   * Everything between two products stays in registers: mma.sync
//     m16n8k16 bf16 with fp32 accumulation, operands loaded by ldmatrix
//     from shared tiles padded by 16 bytes a row (conflict-free); the score
//     accumulator of one product is repacked in registers as the A operand
//     of the next (P for P.V, P^T and dS^T for dV and dK, dS for dQ), so
//     no score, probability or output tile goes through shared memory.
//   * The tiles a CTA walks (K/V in the forward and dQ, Q/dO/lse/delta in
//     dK/dV) are double-buffered with cp.async: tile i+1 loads while tile i
//     computes, one barrier per tile.
//   * attn_fwd: one CTA per (64-query tile, q-head, batch), 4 warps of 16
//     query rows; each thread holds its rows' running max m and partial sum
//     l (log2 units, exp2) beside its O fragment; P is cast to the input
//     dtype before P.V (as attention.py:83); it writes O / l and lse.
//   * attn_bwd_delta: delta = rowsum(dO * O) in fp32, one warp per row.
//   * attn_bwd_dkdv: one CTA per (64-key tile, q-head partition, batch);
//     its 4 warps own 16 keys each and walk the partition's g / P heads
//     and, for each, the query tiles from the diagonal to the end,
//     recomputing P = exp(S*sm - lse) and dS = P (dP - delta) sm (cast to
//     the input dtype, attention.py:112), with dK and dV accumulated in
//     registers. P = 1 writes dK and dV; P > 1 writes fp32 partials to a
//     workspace (2, P, B, S, Hkv, hd) and attn_bwd_dkdv_reduce sums them
//     in partition order. The wrapper's planner picks P; the grid launches
//     the longest columns (key tile 0) first.
//   * attn_bwd_dq: one CTA per (64-query tile, q-head, batch), dQ += dS K
//     over the key tiles up to the diagonal, dQ in registers.
//   No atomics: every output element is written by one CTA (or summed in a
//   fixed order), so the result is the same bit for bit from run to run.
//   Ragged S is masked in the loads (zero rows) and in the scores; nothing
//   is padded or transposed in device memory. The attention mask is
//   ignored, as in the JAX kernel: pad keys of a right-padded batch are
//   masked by causality alone.
//   fp32: CUDA-core FMAs, 256 threads, four threads per row (unchanged).
// Not yet: wgmma/TMA, warp specialisation.

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// lse / delta of positions pos0 .. pos0+n-1 (n a multiple of 4) into shared
// memory by cp.async; positions at or past S read 0.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int pos0, int n,
                                               int S) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool in = pos0 + i < S;
    cp_async4(dst + i, in ? src + pos0 + i : src, in);
  }
}

// One 16 x HD accumulator (the warp's rows) times row_scale, cast and
// written to positions pos + 0..7 (c[.][0..1]) and pos + 8..15 (c[.][2..3])
// of a slice whose positions are row_stride elements apart.
template <int HD>
__device__ __forceinline__ void store_acc(bf16* dst, size_t row_stride, const float (&c)[HD / 8][4],
                                          int pos, int S, float scale0, float scale1) {
  const int lane = threadIdx.x % 32;
  const int r = pos + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    if (r < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * row_stride + nd * 8 + col) =
          pack_bf16(c[nd][0] * scale0, c[nd][1] * scale0);
    if (r + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r + 8) * row_stride + nd * 8 + col) =
          pack_bf16(c[nd][2] * scale1, c[nd][3] * scale1);
  }
}

template <int HD>
__device__ __forceinline__ void store_acc(float* dst, size_t row_stride, const float (&c)[HD / 8][4],
                                          int pos, int S) {
  const int lane = threadIdx.x % 32;
  const int r = pos + lane / 4, col = 2 * (lane % 4);
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    if (r < S)
      *reinterpret_cast<float2*>(dst + (size_t)r * row_stride + nd * 8 + col) =
          make_float2(c[nd][0], c[nd][1]);
    if (r + 8 < S)
      *reinterpret_cast<float2*>(dst + (size_t)(r + 8) * row_stride + nd * 8 + col) =
          make_float2(c[nd][2], c[nd][3]);
  }
}

// c[n] (16 x 8 each, n < 2 * NP) = A (16 rows x HD, rows a_r0.. of tile
// a, pitch LD) . B^T for the 16 * NP rows of tile bt (stored [n][hd]).
template <int HD, int NP>
__device__ __forceinline__ void product_nk(float (&c)[2 * NP][4], const bf16* a, int a_r0,
                                           const bf16* bt) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int d = 0; d < HD / 16; ++d) {
    uint32_t af[4];
    ld_a(af, a, LD, a_r0, d * 16);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bf[4];
      ld_b_nk(bf, bt, LD, np * 16, d * 16);
      mma_bf16(c[2 * np], af, bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x HD) += P (16 x 16 * KC, the accumulator tiles p) . the KC * 16
// rows of tile bt (stored [k][hd]).
template <int HD, int KC>
__device__ __forceinline__ void product_kn(float (&acc)[HD / 8][4], const float (&p)[2 * KC][4],
                                           const bf16* bt) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t af[4];
    acc_to_a(af, p[2 * kc], p[2 * kc + 1]);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t bf[4];
      ld_b_kn(bf, bt, LD, kc * 16, np * 16);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------

template <int HD>
struct Bf16Smem {
  static constexpr int LD = HD + 8;                        // bf16 row pitch
  static constexpr size_t kTile = (size_t)T64 * LD * 2;    // 64 x hd bf16
  static constexpr int BQ = HD == 64 ? 64 : 32;            // dkdv query tile
  static constexpr size_t kQTile = (size_t)BQ * LD * 2;
  // fwd: Q | K[2] V[2]
  static constexpr size_t fwd = 5 * kTile;
  // dq: Q dO | K[2] V[2]
  static constexpr size_t dq = 6 * kTile;
  // dkdv: K V | Q[2] dO[2] | lse[2] delta[2]
  static constexpr size_t dkdv = 2 * kTile + 4 * kQTile + 4 * (size_t)BQ * 4;
};

template <int HD>
__global__ void __launch_bounds__(NT_BF16)
attn_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
              int S, int Hq, int Hkv, float sm) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + T64 * LD;       // [2][64][LD]
  bf16* Vs = Ks + 2 * T64 * LD;   // [2][64][LD]

  const int nq = (S + T64 - 1) / T64;
  const int qt = nq - 1 - blockIdx.z;  // the longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const bf16* kb = k + ((size_t)b * S * Hkv + hk) * HD;
  const bf16* vb = v + ((size_t)b * S * Hkv + hk) * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = q0 + warp * 16 + lane / 4;  // this thread's rows: row, row + 8
  const float sl2 = sm * LOG2E;

  load_rows_async<HD>(Qs, q + ((size_t)b * S * Hq + h) * HD, qrs, q0, T64, S);
  load_rows_async<HD>(Ks, kb, krs, 0, T64, S);
  load_rows_async<HD>(Vs, vb, krs, 0, T64, S);
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[HD / 16][4];

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt) {
      load_rows_async<HD>(Ks + (st ^ 1) * T64 * LD, kb, krs, (kt + 1) * T64, T64, S);
      load_rows_async<HD>(Vs + (st ^ 1) * T64 * LD, vb, krs, (kt + 1) * T64, T64, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) ld_a(qf[d], Qs, LD, warp * 16, d * 16);
    }
    const bf16* Kt = Ks + st * T64 * LD;
    const bf16* Vt = Vs + st * T64 * LD;

    // S = Q K^T, 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int d = 0; d < HD / 16; ++d) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ld_b_nk(bf, Kt, LD, np * 16, d * 16);
        mma_bf16(s[2 * np], qf[d], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[d], bf[2], bf[3]);
      }
    }
    // online softmax in log2 units; only the diagonal tile (the last, and
    // the only one that can reach past S) is masked. A masked score is
    // -inf and contributes exactly 0.
    const int k0 = kt * T64;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (kt == qt) {
          const int kpos = k0 + n * 8 + 2 * (lane % 4) + (e & 1);
          if (kpos > row + (e >> 1) * 8 || kpos >= S) x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float muse[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      muse[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - muse[r]);
      m[r] = mx[r];
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - muse[e >> 1]);
        ps[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];  // this thread's columns
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    product_kn<HD, 4>(acc, s, Vt);  // O += P V, P cast to bf16
    __syncthreads();                // the stage is reloaded next
  }

  // key 0 is causal for every row, so l > 0
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  store_acc<HD>(o + ((size_t)b * S * Hq + h) * HD, qrs, acc, q0 + warp * 16, S, 1.f / l0,
                1.f / l1);
  if (lane % 4 == 0) {
    float* lrow = lse + ((size_t)b * Hq + h) * S;
    if (row < S) lrow[row] = (m[0] + log2f(l0)) * LN2;
    if (row + 8 < S) lrow[row + 8] = (m[1] + log2f(l1)) * LN2;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT_BF16)
attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int S, int Hq, int Hkv, float sm) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + T64 * LD;
  bf16* Ks = dOs + T64 * LD;      // [2][64][LD]
  bf16* Vs = Ks + 2 * T64 * LD;   // [2][64][LD]

  const int nq = (S + T64 - 1) / T64;
  const int qt = nq - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const size_t qoff = ((size_t)b * S * Hq + h) * HD;
  const bf16* kb = k + ((size_t)b * S * Hkv + hk) * HD;
  const bf16* vb = v + ((size_t)b * S * Hkv + hk) * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = q0 + warp * 16 + lane / 4;
  const size_t vec = ((size_t)b * Hq + h) * S;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = row + 8 * r;
    lse2[r] = p < S ? lse[vec + p] * LOG2E : 0.f;
    dl[r] = p < S ? delta[vec + p] : 0.f;
  }
  const float sl2 = sm * LOG2E;

  load_rows_async<HD>(Qs, q + qoff, qrs, q0, T64, S);
  load_rows_async<HD>(dOs, dout + qoff, qrs, q0, T64, S);
  load_rows_async<HD>(Ks, kb, krs, 0, T64, S);
  load_rows_async<HD>(Vs, vb, krs, 0, T64, S);
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    if (kt < qt) {
      load_rows_async<HD>(Ks + (st ^ 1) * T64 * LD, kb, krs, (kt + 1) * T64, T64, S);
      load_rows_async<HD>(Vs + (st ^ 1) * T64 * LD, vb, krs, (kt + 1) * T64, T64, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * T64 * LD;
    const bf16* Vt = Vs + st * T64 * LD;
    float s[8][4], dp[8][4];
    product_nk<HD, 4>(s, Qs, warp * 16, Kt);    // S = Q K^T
    product_nk<HD, 4>(dp, dOs, warp * 16, Vt);  // dP = dO V^T
    const int k0 = kt * T64;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2f(s[n][e] * sl2 - lse2[r]);
        if (kt == qt) {
          const int kpos = k0 + n * 8 + 2 * (lane % 4) + (e & 1);
          const int qpos = row + 8 * r;
          if (kpos > qpos || kpos >= S || qpos >= S) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - dl[r]) * sm;  // dS
      }
    }
    product_kn<HD, 4>(acc, s, Kt);  // dQ += dS K, dS cast to bf16
    __syncthreads();
  }
  store_acc<HD>(dq + qoff, qrs, acc, q0 + warp * 16, S, 1.f, 1.f);
}

// grid (Hkv * P, B, key tiles): CTA (hk * P + part, b, kt) serves key tile kt
// of kv-head hk for the q-heads hk * g + part * g / P .. + g / P - 1.
template <int HD>
__global__ void __launch_bounds__(NT_BF16)
attn_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ ws,
                   int B, int S, int Hq, int Hkv, int P, float sm) {
  using L = Bf16Smem<HD>;
  constexpr int LD = HD + 8, BQ = L::BQ, NQ8 = BQ / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + T64 * LD;
  bf16* Qs = Vs + T64 * LD;        // [2][BQ][LD]
  bf16* dOs = Qs + 2 * BQ * LD;    // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* d_s = lse_s + 2 * BQ;                                 // [2][BQ]

  const int kt = blockIdx.z;  // key tile 0 has the most query tiles: launched first
  const int hk = blockIdx.x / P, part = blockIdx.x % P, b = blockIdx.y;
  const int g = Hq / Hkv, hp = g / P;
  const int k0 = kt * T64;
  const size_t qrs = (size_t)Hq * HD, krs = (size_t)Hkv * HD;
  const size_t koff = ((size_t)b * S * Hkv + hk) * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int krow = k0 + warp * 16 + lane / 4;  // this thread's keys: krow, krow + 8
  const int qt0 = k0 / BQ, per_head = (S + BQ - 1) / BQ - qt0, items = hp * per_head;
  const float sl2 = sm * LOG2E;

  // item i: q-head h0 + i / per_head, query tile qt0 + i % per_head
  auto issue = [&](int i, int st) {
    const int h = hk * g + part * hp + i / per_head;
    const int q0 = (qt0 + i % per_head) * BQ;
    const size_t qoff = ((size_t)b * S * Hq + h) * HD;
    const size_t vec = ((size_t)b * Hq + h) * S;
    load_rows_async<HD>(Qs + st * BQ * LD, q + qoff, qrs, q0, BQ, S);
    load_rows_async<HD>(dOs + st * BQ * LD, dout + qoff, qrs, q0, BQ, S);
    load_vec_async(lse_s + st * BQ, lse + vec, q0, BQ, S);
    load_vec_async(d_s + st * BQ, delta + vec, q0, BQ, S);
  };

  load_rows_async<HD>(Ks, k + koff, krs, k0, T64, S);
  load_rows_async<HD>(Vs, v + koff, krs, k0, T64, S);
  issue(0, 0);
  cp_async_commit();

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int i = 0; i < items; ++i) {
    const int st = i & 1;
    if (i + 1 < items) {
      issue(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * LD;
    const bf16* dOt = dOs + st * BQ * LD;
    const float* lt = lse_s + st * BQ;
    const float* dt = d_s + st * BQ;
    const int q0 = (qt0 + i % per_head) * BQ;
    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x BQ queries
    float s[NQ8][4], dp[NQ8][4];
    product_nk<HD, BQ / 16>(s, Ks, warp * 16, Qt);
    product_nk<HD, BQ / 16>(dp, Vs, warp * 16, dOt);
    const bool edge = q0 < k0 + T64 - 1 || q0 + BQ > S || k0 + T64 > S;
#pragma unroll
    for (int n = 0; n < NQ8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane % 4) + (e & 1);
        float p = exp2f(s[n][e] * sl2 - lt[c] * LOG2E);
        if (edge) {
          const int qpos = q0 + c, kpos = krow + (e >> 1) * 8;
          if (kpos > qpos || qpos >= S || kpos >= S) p = 0.f;
        }
        s[n][e] = p;                           // P^T
        dp[n][e] = p * (dp[n][e] - dt[c]) * sm;  // dS^T
      }
    }
    product_kn<HD, BQ / 16>(dva, s, dOt);  // dV += P^T dO
    product_kn<HD, BQ / 16>(dka, dp, Qt);  // dK += dS^T Q
    __syncthreads();
  }

  if (P == 1) {
    store_acc<HD>(dk + koff, krs, dka, k0 + warp * 16, S, 1.f, 1.f);
    store_acc<HD>(dv + koff, krs, dva, k0 + warp * 16, S, 1.f, 1.f);
  } else {
    // workspace (2, P, B, S, Hkv, hd): dK partials, then dV partials
    const size_t n = (size_t)B * S * Hkv * HD;
    float* wk = ws + (size_t)part * n + koff;
    store_acc<HD>(wk, krs, dka, k0 + warp * 16, S);
    store_acc<HD>(wk + (size_t)P * n, krs, dva, k0 + warp * 16, S);
  }
}

// dk, dv = the sums over p = 0, 1, .., P - 1, in that order, of the
// workspace's partials, cast to the output dtype; n = B * S * Hkv * hd
// elements each, four a thread.
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_dkdv_reduce_kernel(const float* __restrict__ ws, T* __restrict__ dk,
                            T* __restrict__ dv, size_t n, int P) {
  const size_t i4 = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i4 >= 2 * n) return;
  const int which = i4 >= n;  // 0 dK, 1 dV
  const size_t i = i4 - which * n;
  const float* src = ws + (size_t)which * P * n + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int p = 1; p < P; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(src + (size_t)p * n);
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  T* out = (which ? dv : dk) + i;
  if constexpr (sizeof(T) == 2) {
    uint2 u = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    *reinterpret_cast<uint2*>(out) = u;
  } else {
    *reinterpret_cast<float4*>(out) = acc;
  }
}

// ---------------------------------------------------------------------------
// fp32 helpers
// ---------------------------------------------------------------------------


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
  const int nq = (S + T64 - 1) / T64;
  cudaError_t err;
  if (dtype == 1) {
    const size_t bytes = Bf16Smem<HD>::fwd;
    if ((err = allow_smem(attn_fwd_bf16<HD>, bytes)) != cudaSuccess) return err;
    attn_fwd_bf16<HD><<<dim3(Hq, B, nq), NT_BF16, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), S, Hq, Hkv, sm);
  } else {
    const size_t bytes = F32Smem<HD>::fwd;
    if ((err = allow_smem(attn_fwd_f32<HD>, bytes)) != cudaSuccess) return err;
    attn_fwd_f32<HD><<<dim3(nq, Hq, B), NT_F32, bytes, s>>>(
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
  const int nq = (S + T64 - 1) / T64;
  cudaError_t err;
  if (dtype == 1) {
    const size_t bytes = Bf16Smem<HD>::dq;
    if ((err = allow_smem(attn_bwd_dq_bf16<HD>, bytes)) != cudaSuccess) return err;
    attn_bwd_dq_bf16<HD><<<dim3(Hq, B, nq), NT_BF16, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), S, Hq, Hkv, sm);
  } else {
    const size_t bytes = F32Smem<HD>::dq;
    if ((err = allow_smem(attn_bwd_dq_f32<HD>, bytes)) != cudaSuccess) return err;
    attn_bwd_dq_f32<HD><<<dim3(nq, Hq, B), NT_F32, bytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), S, Hq, Hkv, sm);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, void* ws,
                        int B, int S, int Hq, int Hkv, int P, float sm, int dtype,
                        cudaStream_t s) {
  const int nk = (S + T64 - 1) / T64;
  cudaError_t err;
  if (dtype == 1) {
    const size_t bytes = Bf16Smem<HD>::dkdv;
    if ((err = allow_smem(attn_bwd_dkdv_bf16<HD>, bytes)) != cudaSuccess) return err;
    attn_bwd_dkdv_bf16<HD><<<dim3(Hkv * P, B, nk), NT_BF16, bytes, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        static_cast<float*>(ws), B, S, Hq, Hkv, P, sm);
  } else {
    const size_t bytes = F32Smem<HD>::dkdv;
    if ((err = allow_smem(attn_bwd_dkdv_f32<HD>, bytes)) != cudaSuccess) return err;
    attn_bwd_dkdv_f32<HD><<<dim3(nk, Hkv, B), NT_F32, bytes, s>>>(
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

// P q-head partitions (bf16: 1 <= P <= Hq / Hkv, P dividing it; fp32: 1).
// P == 1 writes dk, dv; P > 1 writes the fp32 workspace ws (2, P, B, S,
// Hkv, hd) for smt_attn_bwd_dkdv_reduce.
extern "C" int smt_attn_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, void* ws, int B, int S, int Hq, int Hkv,
                                 int hd, int P, float sm, int dtype, void* stream) {
  if (bad_args(B, S, Hq, Hkv, hd, dtype) || P < 1 || (Hq / Hkv) % P != 0 ||
      (dtype == 0 && P != 1) || (P > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 64
                   ? launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, ws, B, S, Hq, Hkv, P,
                                     sm, dtype, s)
                   : launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, ws, B, S, Hq, Hkv, P,
                                      sm, dtype, s));
}

// dk, dv (n elements each, n a multiple of 4) = the P partials of ws summed
// in partition order, in dtype (0 fp32, 1 bf16).
extern "C" int smt_attn_bwd_dkdv_reduce(const void* ws, void* dk, void* dv, int n, int P,
                                        int dtype, void* stream) {
  if (n <= 0 || n % 4 != 0 || P < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t threads = (2 * (size_t)n) / 4;
  const dim3 grid((unsigned)((threads + 255) / 256));
  if (dtype == 1)
    attn_bwd_dkdv_reduce_kernel<bf16><<<grid, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        (size_t)n, P);
  else
    attn_bwd_dkdv_reduce_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(dk), static_cast<float*>(dv),
        (size_t)n, P);
  return (int)cudaGetLastError();
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

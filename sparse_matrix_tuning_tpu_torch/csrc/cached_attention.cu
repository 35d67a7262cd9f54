// K7 cached attention: grouped-query attention of T new tokens over the
// decode KV cache, for prefill chunks (T = prompt length) and decode steps
// (T = 1).
//
//   o[b,t,h,:] = sum_{j visible} softmax_j(q[b,t,h,:] . k[b,h/g,j,:] * sm) v[b,h/g,j,:]
//   slot j is visible to token t iff j <= cache_index + t and slot_mask[b,j] != 0
//   q, o: (B, T, Hq, hd) bf16 or fp32; k, v: (B, Hkv, S, hd) cache of q's
//   dtype, the other float dtype (cast to q's on load, as the Pallas body's
//   astype) or int8; slot_mask: (B, S) int32; g = Hq / Hkv.
//   int8 cache: ks, vs (B, Hkv, 1, S) fp32 per-(slot, head) scales, folded
//   into the columns: s_j = (q . k_j) * ks_j * sm, p'_j = p_j * vs_j, with
//   p' cast to q's dtype before P.V.
//
// Replaces the Pallas TPU kernel
//   sparse_matrix_tuning_tpu/ops/pallas/cached_attention.py _cached_attn_call
//   (bodies _kernel and _kernel_q8).
//
// The Pallas kernel keeps a (batch, kv-head)'s whole K/V in VMEM (2.1 MB
// at S = 8192, hd 128) and runs its row blocks in order. Neither carries
// over: a CTA has 227 KB of shared memory. Here one CTA serves one (64-row
// tile, kv-head, batch); rows are token-major (r = t * g + gi, q-head
// h = kv_head * g + gi), so a decode step's g rows share one pass over the
// cache, and q and o are addressed in place in (B, T, Hq, hd), with no
// transpose. The CTA walks 64-slot key tiles (32 on the fp32 path) with an
// online softmax (running max and sum in fp32, as K3's forward) and stops
// at the last slot any of its rows can see, min(S, cache_index + last
// token + 1): a decode step reads the written part of the cache only.
// Visibility comes from (slot_mask, cache_index) in the kernel; no mask
// tensor and no score tensor exist in device memory.
//
// Rows that see no slot (the pad positions of a left-padded prefill) are
// written as zeros. The JAX code masks with the finite fp32 minimum, which
// gives such rows the mean of V; with -inf masking they would be 0/0 = NaN,
// which enters the pad slots' K/V and, through 0 * NaN in P.V, every real
// row of later layers. Real rows are unaffected by the choice: a masked
// slot's probability is exactly 0 either way.
//
// What bounds it on the H100: a decode step reads the visible cache once
// per (batch, kv-head) and does 4 * g * hd flops per slot, far below the
// card's ~295 flops per byte, so it is bound by device-memory bytes; a
// long prefill is bound by the tensor cores and the softmax's exp. The
// design reads each K/V tile once per 64 rows and keeps scores in shared
// memory.
//   bf16 q: WMMA 16x16x16 with fp32 accumulation, 4 warps of 16 rows;
//   warps whose rows are all past T * g skip the math (decode has g rows).
//   fp32 q: CUDA-core FMAs, 256 threads, four threads per row.
//   int8 cache: 8-byte loads, converted in registers to q's dtype (exact
//   for |x| <= 127), scales staged per key tile.
// Not yet: splitting S over CTAs for decode (flash-decoding), cp.async or
// TMA pipelining, wgmma.

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "tiles.cuh"

namespace {

// 8 consecutive cache or query elements as fp32 (exact for every type).
__device__ __forceinline__ void load8(const bf16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = (float)c[i];
}

// ... stored in the compute dtype (bf16: round to nearest even, the
// astype of the Pallas body)
__device__ __forceinline__ void store8(bf16* d, const float (&x)[8]) {
  uint4 u;
  bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(x[i]);
  *reinterpret_cast<uint4*>(d) = u;
}

__device__ __forceinline__ void store8(float* d, const float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = x[i];  // pitch hd + 1: no vector store
}

__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// Element offset of token-major row r of kv-head hk in q / o (B, T, Hq, hd).
__device__ __forceinline__ size_t q_row(int b, int hk, int r, int T, int Hq, int g, int hd) {
  return (((size_t)b * T + r / g) * Hq + (size_t)hk * g + r % g) * hd;
}

// Rows r0 .. r0+63 of a (b, kv-head)'s token-major queries into shared
// memory (pitch ld); rows at or past R are zero.
template <int HD, typename QT>
__device__ __forceinline__ void load_q_tile(QT* dst, int ld, const QT* q, int b, int hk,
                                            int r0, int R, int T, int Hq, int g) {
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x; i < T64 * VPR; i += blockDim.x) {
    const int rr = i / VPR, c = (i % VPR) * 8;
    float x[8];
    if (r0 + rr < R) {
      load8(q + q_row(b, hk, r0 + rr, T, Hq, g, HD) + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    store8(dst + rr * ld + c, x);
  }
}

// Cache slots j0 .. j0+rows-1 of one (b, kv-head) slice (rows of HD
// contiguous elements) into shared memory in the compute dtype QT; slots
// at or past jend are zero.
template <int HD, typename QT, typename CT>
__device__ __forceinline__ void load_kv_tile(QT* dst, int ld, const CT* src, int j0, int rows,
                                             int jend) {
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * 8;
    float x[8];
    if (j0 + r < jend) {
      load8(src + (size_t)(j0 + r) * HD + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
    store8(dst + r * ld + c, x);
  }
}

// Per-slot data of a key tile: slot_mask (0 past jend) and, for an int8
// cache, the K and V column scales.
template <bool QUANT>
__device__ __forceinline__ void load_slots(int* msk, float* ksc, float* vsc, const int* smask,
                                           const float* ks, const float* vs, int j0, int n,
                                           int jend) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = j0 + i;
    const bool in = j < jend;
    msk[i] = in && smask[j] != 0;
    if (QUANT) {
      ksc[i] = in ? ks[j] : 0.f;
      vsc[i] = in ? vs[j] : 0.f;
    }
  }
}

template <int HD>
struct CachedBf16Smem {
  static constexpr int LD = HD + 8;
  // Q K V (64 x hd bf16) | S (64 x 64 fp32) | P (64 x 64 bf16) | O (64 x hd
  // fp32) | 1/l, K scales, V scales, slot mask (64 each)
  static constexpr size_t bytes = 3 * (size_t)T64 * LD * 2 + (size_t)T64 * SLD * 4 +
                                  (size_t)T64 * PLD * 2 + (size_t)T64 * (HD + 4) * 4 +
                                  4 * T64 * 4;
};

template <int HD, typename CT>
__global__ void __launch_bounds__(NT_BF16)
cached_attn_bf16(const bf16* __restrict__ q, const CT* __restrict__ kc,
                 const CT* __restrict__ vc, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ smask,
                 bf16* __restrict__ o, int T, int S, int Hq, int Hkv, int ci, float sm) {
  constexpr bool QUANT = std::is_same<CT, int8_t>::value;
  constexpr int LD = HD + 8, OLD = HD + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + T64 * LD;
  bf16* Vs = Ks + T64 * LD;
  float* Ss = reinterpret_cast<float*>(Vs + T64 * LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + T64 * SLD);
  float* Os = reinterpret_cast<float*>(Ps + T64 * PLD);
  float* inv_l = Os + T64 * OLD;
  float* ksc = inv_l + T64;
  float* vsc = ksc + T64;
  int* msk = reinterpret_cast<int*>(vsc + T64);

  const int g = Hq / Hkv, R = T * g;
  const int r0 = blockIdx.x * T64, hk = blockIdx.y, b = blockIdx.z;
  const int kend = min(S, ci + (min(R, r0 + T64) - 1) / g + 1);
  const size_t slice = ((size_t)b * Hkv + hk) * S;  // first slot of (b, hk)
  const CT* kb = kc + slice * HD;
  const CT* vb = vc + slice * HD;
  const int* mrow = smask + (size_t)b * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 2, half = lane & 1;
  const int r = r0 + row;
  const int jlim = r < R ? min(S, ci + r / g + 1) : 0;  // slots j < jlim are causal
  const bool active = r0 + warp * 16 < R;

  load_q_tile<HD>(Qs, LD, q, b, hk, r0, R, T, Hq, g);
  for (int i = threadIdx.x; i < T64 * OLD; i += NT_BF16) Os[i] = 0.f;
  __syncthreads();
  FragA qf[HD / 16];
  if (active) {
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wmma::load_matrix_sync(qf[d], Qs + warp * 16 * LD + d * 16, LD);
  }

  float m = -INFINITY, l = 0.f;
  const float* srow = Ss + row * SLD;
  bf16* prow = Ps + row * PLD;
  float* orow = Os + row * OLD;
  for (int k0 = 0; k0 < kend; k0 += T64) {
    load_kv_tile<HD>(Ks, LD, kb, k0, T64, kend);
    load_kv_tile<HD>(Vs, LD, vb, k0, T64, kend);
    load_slots<QUANT>(msk, ksc, vsc, mrow, ks + slice, vs + slice, k0, T64, kend);
    __syncthreads();
    if (active) {
      scores_16x64<HD>(Ss + warp * 16 * SLD, qf, Ks);
      __syncwarp();
      // online softmax over this tile; lanes 2r, 2r+1 share row r, columns
      // interleaved. A masked score is -inf, so a tile wholly masked for a
      // row contributes exactly 0 and leaves m and l as they were.
      float sv[T64 / 2];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < T64 / 2; ++j) {
        const int c = 2 * j + half;
        float x = srow[c];
        if (QUANT) x *= ksc[c];
        x *= sm;
        if (k0 + c >= jlim || !msk[c]) x = -INFINITY;
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
        const int c = 2 * j + half;
        const float p = expf(sv[j] - muse);
        psum += p;
        prow[c] = __float2bfloat16(QUANT ? p * vsc[c] : p);
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
    }
    __syncthreads();  // Ks / Vs and the slot data are reloaded
  }

  if (half == 0) inv_l[row] = l > 0.f ? 1.f / l : 0.f;  // no visible slot: zeros
  __syncwarp();
  if (active) {
    for (int i = lane; i < 16 * HD; i += 32) {
      const int rr = warp * 16 + i / HD, c = i % HD;
      if (r0 + rr < R)
        put(o + q_row(b, hk, r0 + rr, T, Hq, g, HD) + c, Os[rr * OLD + c] * inv_l[rr]);
    }
  }
}

template <int HD>
struct CachedF32Smem {
  static constexpr int LD = HD + 1;
  static constexpr int PL = F32_BK + 1;
  // Q (64) | K V (32) | P (64 x 32) | K scales, V scales, slot mask (32 each)
  static constexpr size_t bytes =
      ((size_t)T64 * LD + 2 * F32_BK * LD + T64 * PL + 3 * F32_BK) * 4;
};

template <int HD, typename CT>
__global__ void __launch_bounds__(NT_F32)
cached_attn_f32(const float* __restrict__ q, const CT* __restrict__ kc,
                const CT* __restrict__ vc, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ smask,
                float* __restrict__ o, int T, int S, int Hq, int Hkv, int ci, float sm) {
  constexpr bool QUANT = std::is_same<CT, int8_t>::value;
  using L = CachedF32Smem<HD>;
  constexpr int LD = L::LD, PL = L::PL, NJ = F32_BK / 4, NO = HD / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + T64 * LD;
  float* Vs = Ks + F32_BK * LD;
  float* Ps = Vs + F32_BK * LD;
  float* ksc = Ps + T64 * PL;
  float* vsc = ksc + F32_BK;
  int* msk = reinterpret_cast<int*>(vsc + F32_BK);

  const int g = Hq / Hkv, R = T * g;
  const int r0 = blockIdx.x * T64, hk = blockIdx.y, b = blockIdx.z;
  const int kend = min(S, ci + (min(R, r0 + T64) - 1) / g + 1);
  const size_t slice = ((size_t)b * Hkv + hk) * S;
  const CT* kb = kc + slice * HD;
  const CT* vb = vc + slice * HD;
  const int* mrow = smask + (size_t)b * S;
  const int rr = threadIdx.x / 4, part = threadIdx.x % 4;
  const int r = r0 + rr;
  const int jlim = r < R ? min(S, ci + r / g + 1) : 0;
  const bool active = r0 + (threadIdx.x / 32) * 8 < R;  // a warp holds 8 rows

  load_q_tile<HD>(Qs, LD, q, b, hk, r0, R, T, Hq, g);
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < kend; k0 += F32_BK) {
    __syncthreads();  // the previous tile's readers are done
    load_kv_tile<HD>(Ks, LD, kb, k0, F32_BK, kend);
    load_kv_tile<HD>(Vs, LD, vb, k0, F32_BK, kend);
    load_slots<QUANT>(msk, ksc, vsc, mrow, ks + slice, vs + slice, k0, F32_BK, kend);
    __syncthreads();
    if (!active) continue;
    float s[NJ];
    dots<NJ, HD>(s, Qs + rr * LD, Ks + part * LD, 4 * LD);  // slots part + 4j
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = part + 4 * j;
      float x = s[j];
      if (QUANT) x *= ksc[c];
      x *= sm;
      if (k0 + c >= jlim || !msk[c]) x = -INFINITY;
      s[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float mnew = fmaxf(m, tmax);
    const float muse = (mnew == -INFINITY) ? 0.f : mnew;
    const float alpha = expf(m - muse);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = part + 4 * j;
      const float p = expf(s[j] - muse);
      psum += p;
      Ps[rr * PL + c] = QUANT ? p * vsc[c] : p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = mnew;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= alpha;
    for (int c = 0; c < F32_BK; ++c) {
      const float p = Ps[rr * PL + c];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = fmaf(p, Vs[c * LD + part + 4 * i], acc[i]);
    }
  }
  if (r < R) {
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no visible slot: zeros
    float* orow = o + q_row(b, hk, r, T, Hq, g, HD);
#pragma unroll
    for (int i = 0; i < NO; ++i) orow[part + 4 * i] = acc[i] * inv;
  }
}

template <int HD, typename CT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* smask, void* o, int B, int T, int S, int Hq, int Hkv, int ci,
                   float sm, int qdtype, cudaStream_t s) {
  const int R = T * (Hq / Hkv);
  const dim3 grid((R + T64 - 1) / T64, Hkv, B);
  const CT* kc = static_cast<const CT*>(k);
  const CT* vc = static_cast<const CT*>(v);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* mp = static_cast<const int*>(smask);
  cudaError_t err;
  if (qdtype == 1) {
    const size_t bytes = CachedBf16Smem<HD>::bytes;
    if ((err = allow_smem(cached_attn_bf16<HD, CT>, bytes)) != cudaSuccess) return err;
    cached_attn_bf16<HD, CT><<<grid, NT_BF16, bytes, s>>>(
        static_cast<const bf16*>(q), kc, vc, ksp, vsp, mp, static_cast<bf16*>(o), T, S, Hq,
        Hkv, ci, sm);
  } else {
    const size_t bytes = CachedF32Smem<HD>::bytes;
    if ((err = allow_smem(cached_attn_f32<HD, CT>, bytes)) != cudaSuccess) return err;
    cached_attn_f32<HD, CT><<<grid, NT_F32, bytes, s>>>(
        static_cast<const float*>(q), kc, vc, ksp, vsp, mp, static_cast<float*>(o), T, S, Hq,
        Hkv, ci, sm);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_cache_type(const void* q, const void* k, const void* v, const void* ks,
                              const void* vs, const void* smask, void* o, int B, int T, int S,
                              int Hq, int Hkv, int ci, float sm, int qdtype, int cdtype,
                              cudaStream_t s) {
  if (cdtype == 2)
    return launch<HD, int8_t>(q, k, v, ks, vs, smask, o, B, T, S, Hq, Hkv, ci, sm, qdtype, s);
  if (cdtype == 1)
    return launch<HD, bf16>(q, k, v, ks, vs, smask, o, B, T, S, Hq, Hkv, ci, sm, qdtype, s);
  return launch<HD, float>(q, k, v, ks, vs, smask, o, B, T, S, Hq, Hkv, ci, sm, qdtype, s);
}

}  // namespace

// qdtype: 0 = fp32, 1 = bf16; cdtype: 0 = fp32, 1 = bf16, 2 = int8 (then ks
// and vs are the scales; otherwise they are not read). hd in {64, 128}.
// Returns cudaGetLastError() after the launch (or the error that refused it).
extern "C" int smt_cached_attn(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* slot_mask, void* o, int B, int T,
                               int S, int Hq, int Hkv, int hd, int cache_index, float sm,
                               int qdtype, int cdtype, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (hd != 64 && hd != 128) ||
      (qdtype != 0 && qdtype != 1) || cdtype < 0 || cdtype > 2 || cache_index < 0 ||
      cache_index + T > S || (cdtype == 2 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 64 ? launch_cache_type<64>(q, k, v, ks, vs, slot_mask, o, B, T, S, Hq, Hkv,
                                                cache_index, sm, qdtype, cdtype, s)
                        : launch_cache_type<128>(q, k, v, ks, vs, slot_mask, o, B, T, S, Hq,
                                                 Hkv, cache_index, sm, qdtype, cdtype, s));
}

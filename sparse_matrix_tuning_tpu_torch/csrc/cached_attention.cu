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
// over: a CTA has 227 KB of shared memory. Rows are token-major (r = t * g
// + gi, q-head h = kv_head * g + gi), so a decode step's g rows share one
// pass over the cache, and q and o are addressed in place in (B, T, Hq,
// hd), with no transpose. Each CTA stops at the last slot any of its rows
// can see, min(S, cache_index + last token + 1): a decode step reads the
// written part of the cache only. Visibility comes from (slot_mask,
// cache_index) in the kernel; no mask tensor and no score tensor exist in
// device memory.
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
// long prefill is bound by the tensor cores and the softmax's exp.
// Design, bf16 q (flash-decoding):
//   * A CTA serves (row tile, kv-head, batch, split). Decode (R = T * g <=
//     16 rows): its 4 warps share the 16 rows and split each CTA tile of
//     4 x 64 slots (4 x 32 at hd 128) among themselves, so no warp idles;
//     each keeps its own online softmax in registers, and the warps merge
//     through shared memory in warp order at the end. Otherwise 4 warps of
//     16 rows share each 64-slot tile (the prefill).
//   * Split: the CTA tiles up to the last visible slot are cut into
//     `splits` contiguous ranges (the wrapper's planner picks the count
//     from B * Hkv and the visible length); each CTA walks one range and,
//     with more than one split, writes its unnormalised fp32 o and its
//     row max m and sum l to a workspace; cached_attn_combine merges the
//     splits in split order and writes o in q's dtype (a row with l = 0 in
//     every split stays zero). Deterministic: no atomics.
//   * mma.sync m16n8k16 bf16 with fp32 accumulation: scores, P and O stay
//     in registers (P repacked as the next product's A operand); K and V
//     are loaded by ldmatrix from shared tiles padded by 16 bytes a row.
//   * Loads are double-buffered with cp.async: the next tile's K/V (and
//     its slot mask and scales) are in flight while a tile computes. An
//     int8 cache lands as int8 (half the shared bytes), and one pass
//     converts it to bf16 (exact for |x| <= 127) before the products. A
//     cache of the other float dtype (fp32 under bf16 q, off the main
//     path) is loaded and converted synchronously.
//   fp32 q: CUDA-core FMAs, 256 threads, four threads per row, one split.
// Not yet: wgmma/TMA.

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


// Tile geometry of the bf16 kernel. KW = 4 (decode): 16 rows, the 4 warps
// split each CTA tile's slots; KW = 1: 4 warps of 16 rows share the tile.
template <int HD, int KW, typename CT>
struct K7Tile {
  static constexpr int RW = 4 / KW;                              // warps along rows
  static constexpr int ROWS = 16 * RW;                           // rows per CTA
  static constexpr int BK = (KW == 4 && HD == 128) ? 32 : 64;    // slots per warp tile
  static constexpr int SLOTS = BK * KW;                          // slots per CTA tile
  static constexpr int LD = HD + 8;
  static constexpr bool DIRECT = std::is_same<CT, bf16>::value;  // cp.async into bf16 tiles
  static constexpr bool QUANT = std::is_same<CT, int8_t>::value;
  static constexpr int NBUF = DIRECT ? 2 : 1;                    // bf16 K/V stages
  static constexpr int NRAW = QUANT ? 2 : 0;                     // int8 K/V stages
  static constexpr size_t main_bytes = (size_t)ROWS * LD * 2 + 2 * NBUF * (size_t)SLOTS * LD * 2 +
                                       2 * NRAW * (size_t)SLOTS * HD + 2 * 3 * SLOTS * 4;
  // after the walk: each warp's o (16 x (HD + 4) fp32), m and l, over the above
  static constexpr size_t merge_bytes = 4 * 16 * (HD + 4) * 4 + 2 * 4 * 16 * 4;
  static constexpr size_t bytes = main_bytes > merge_bytes ? main_bytes : merge_bytes;
};

// Planner's view of the tile geometry: slots per CTA tile for R rows.
__host__ __device__ constexpr int k7_cta_slots(int hd, int rows) {
  return rows <= 16 ? (hd == 128 ? 128 : 256) : 64;
}

// grid (row tiles, Hkv, B * splits). splits == 1: o; else the split's
// unnormalised o to ws_o (splits, B, T, Hq, hd) and m (natural log units),
// l to ws_m, ws_l (splits, B, T, Hq).
template <int HD, int KW, typename CT>
__global__ void __launch_bounds__(NT_BF16)
cached_attn_mma(const bf16* __restrict__ q, const CT* __restrict__ kc, const CT* __restrict__ vc,
                const float* __restrict__ ks, const float* __restrict__ vs,
                const int* __restrict__ smask, bf16* __restrict__ o, float* __restrict__ ws_o,
                float* __restrict__ ws_m, float* __restrict__ ws_l, int B, int T, int S, int Hq,
                int Hkv, int ci, float sm, int splits) {
  using C = K7Tile<HD, KW, CT>;
  constexpr int LD = C::LD, BK = C::BK, SLOTS = C::SLOTS, ROWS = C::ROWS, RW = C::RW;
  constexpr bool QUANT = C::QUANT;
  static_assert(k7_cta_slots(HD, ROWS) == SLOTS, "planner and kernel disagree");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kb = Qs + ROWS * LD;                  // [NBUF][SLOTS][LD]
  bf16* Vb = Kb + C::NBUF * SLOTS * LD;
  int8_t* Kr = reinterpret_cast<int8_t*>(Vb + C::NBUF * SLOTS * LD);  // [NRAW][SLOTS][HD]
  int8_t* Vr = Kr + C::NRAW * SLOTS * HD;
  int* msk = reinterpret_cast<int*>(Vr + C::NRAW * SLOTS * HD);       // [2][SLOTS]
  float* ksc = reinterpret_cast<float*>(msk + 2 * SLOTS);
  float* vsc = ksc + 2 * SLOTS;

  const int g = Hq / Hkv, R = T * g;
  const int split = blockIdx.z % splits, b = blockIdx.z / splits;
  const int r0 = blockIdx.x * ROWS, hk = blockIdx.y;
  const int kend = min(S, ci + (min(R, r0 + ROWS) - 1) / g + 1);
  const int tiles = (kend + SLOTS - 1) / SLOTS;
  const int t_lo = (int)((long long)split * tiles / splits);
  const int t_hi = (int)((long long)(split + 1) * tiles / splits);
  const size_t slice = ((size_t)b * Hkv + hk) * S;  // first slot of (b, hk)
  const CT* kb = kc + slice * HD;
  const CT* vb = vc + slice * HD;
  const int* mrow = smask + (size_t)b * S;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % RW, wk = warp / RW;
  const int rrow = r0 + wr * 16 + lane / 4;  // this thread's rows: rrow, rrow + 8
  int jlim[2];                               // slots j < jlim are causal
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = rrow + 8 * r;
    jlim[r] = rr < R ? min(S, ci + rr / g + 1) : 0;
  }
  const float sl2 = sm * LOG2E;

  for (int i = threadIdx.x; i < ROWS * (HD / 8); i += NT_BF16) {
    const int rr = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const bool in = r0 + rr < R;
    cp_async16(Qs + rr * LD + c, in ? q + q_row(b, hk, r0 + rr, T, Hq, g, HD) + c : q, in);
  }
  // CTA tile it (slots it * SLOTS ..) into stage st; slots past kend are
  // zero, their mask 0
  auto issue = [&](int it, int st) {
    const int j0 = it * SLOTS;
    for (int i = threadIdx.x; i < SLOTS; i += NT_BF16) {
      const int j = j0 + i;
      const bool in = j < kend;
      cp_async4(msk + st * SLOTS + i, in ? mrow + j : mrow, in);
      if (QUANT) {
        cp_async4(ksc + st * SLOTS + i, in ? ks + slice + j : ks, in);
        cp_async4(vsc + st * SLOTS + i, in ? vs + slice + j : vs, in);
      }
    }
    if (C::DIRECT) {
      for (int i = threadIdx.x; i < SLOTS * (HD / 8); i += NT_BF16) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
        const bool in = j0 + r < kend;
        const size_t at = (size_t)(j0 + r) * HD + c;
        cp_async16(Kb + (st * SLOTS + r) * LD + c, in ? kb + at : kb, in);
        cp_async16(Vb + (st * SLOTS + r) * LD + c, in ? vb + at : vb, in);
      }
    } else if (QUANT) {
      for (int i = threadIdx.x; i < SLOTS * (HD / 16); i += NT_BF16) {
        const int r = i / (HD / 16), c = (i % (HD / 16)) * 16;
        const bool in = j0 + r < kend;
        const size_t at = (size_t)(j0 + r) * HD + c;
        cp_async16(Kr + (st * SLOTS + r) * HD + c, in ? kb + at : kb, in);
        cp_async16(Vr + (st * SLOTS + r) * HD + c, in ? vb + at : vb, in);
      }
    }
  };
  if (t_lo < t_hi) issue(t_lo, 0);
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[HD / 16][4];

  for (int it = t_lo; it < t_hi; ++it) {
    const int st = (it - t_lo) & 1;
    if (it + 1 < t_hi) {
      issue(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!C::DIRECT) {  // into the one bf16 stage
      if (QUANT) {
        for (int i = threadIdx.x; i < SLOTS * (HD / 8); i += NT_BF16) {
          const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
          float x[8];
          load8(Kr + (st * SLOTS + r) * HD + c, x);
          store8(Kb + r * LD + c, x);
          load8(Vr + (st * SLOTS + r) * HD + c, x);
          store8(Vb + r * LD + c, x);
        }
      } else {
        load_kv_tile<HD>(Kb, LD, kb, it * SLOTS, SLOTS, kend);
        load_kv_tile<HD>(Vb, LD, vb, it * SLOTS, SLOTS, kend);
      }
      __syncthreads();
    }
    if (it == t_lo) {
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) ld_a(qf[d], Qs, LD, wr * 16, d * 16);
    }
    const int j0 = it * SLOTS + wk * BK;  // this warp's first slot
    if (j0 < kend) {
      const int sb = C::DIRECT ? st : 0;
      const bf16* Kt = Kb + (sb * SLOTS + wk * BK) * LD;
      const bf16* Vt = Vb + (sb * SLOTS + wk * BK) * LD;
      const int* mk = msk + st * SLOTS + wk * BK;
      const float* kscale = ksc + st * SLOTS + wk * BK;
      const float* vscale = vsc + st * SLOTS + wk * BK;
      float s[BK / 8][4];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t bf[4];
          ld_b_nk(bf, Kt, LD, np * 16, d * 16);
          mma_bf16(s[2 * np], qf[d], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf[d], bf[2], bf[3]);
        }
      }
      // online softmax in log2 units; a masked score is -inf, so a tile
      // wholly masked for a row leaves its m and l as they were
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * (lane % 4) + (e & 1);
          float x = s[n][e];
          if (QUANT) x *= kscale[c];
          x *= sl2;
          if (j0 + c >= jlim[e >> 1] || !mk[c]) x = -INFINITY;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float muse[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        muse[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        alpha[r] = exp2f(m[r] - muse[r]);
        m[r] = mx[r];
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - muse[e >> 1]);
          ps[e >> 1] += p;
          s[n][e] = QUANT ? p * vscale[n * 8 + 2 * (lane % 4) + (e & 1)] : p;
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
      // O += P' V, P' cast to bf16
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        uint32_t af[4];
        acc_to_a(af, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          uint32_t bf[4];
          ld_b_kn(bf, Vt, LD, kc * 16, np * 16);
          mma_bf16(acc[2 * np], af, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the stage is reloaded next
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps (in warp order) and write
  constexpr int OLD = HD + 4;
  float* Mo = reinterpret_cast<float*>(smem);  // [4][16][OLD]
  float* Mm = Mo + 4 * 16 * OLD;               // [4][16]
  float* Ml = Mm + 4 * 16;
  {
    const float l0 = l[0] + __shfl_xor_sync(0xffffffffu, l[0], 1);
    const float l1 = l[1] + __shfl_xor_sync(0xffffffffu, l[1], 1);
    const float s0 = l0 + __shfl_xor_sync(0xffffffffu, l0, 2);
    const float s1 = l1 + __shfl_xor_sync(0xffffffffu, l1, 2);
    float* mo = Mo + (warp * 16 + lane / 4) * OLD + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      mo[n * 8] = acc[n][0];
      mo[n * 8 + 1] = acc[n][1];
      mo[8 * OLD + n * 8] = acc[n][2];
      mo[8 * OLD + n * 8 + 1] = acc[n][3];
    }
    if (lane % 4 == 0) {
      Mm[warp * 16 + lane / 4] = m[0];
      Mm[warp * 16 + lane / 4 + 8] = m[1];
      Ml[warp * 16 + lane / 4] = s0;
      Ml[warp * 16 + lane / 4 + 8] = s1;
    }
  }
  __syncthreads();
  const size_t ws_rows = (size_t)B * T * Hq;
  for (int i = threadIdx.x; i < ROWS * HD; i += NT_BF16) {
    const int rr = i / HD, c = i % HD;
    const int r = r0 + rr;
    if (r >= R) continue;
    const int ri = rr % 16, w0 = rr / 16;  // the row's warps: w0 + RW * kw
    float M = -INFINITY;
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) M = fmaxf(M, Mm[(w0 + RW * kw) * 16 + ri]);
    float L = 0.f, x = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        const int w = w0 + RW * kw;
        const float f = exp2f(Mm[w * 16 + ri] - M);
        L += Ml[w * 16 + ri] * f;
        x += Mo[(w * 16 + ri) * OLD + c] * f;
      }
    }
    const size_t at = q_row(b, hk, r, T, Hq, g, HD);
    if (splits == 1) {
      o[at + c] = __float2bfloat16(L > 0.f ? x / L : 0.f);  // no visible slot: zeros
    } else {
      ws_o[split * ws_rows * HD + at + c] = x;
      if (c == 0) {
        ws_m[split * ws_rows + at / HD] = M * LN2;
        ws_l[split * ws_rows + at / HD] = L;
      }
    }
  }
}

// o (rows x hd) = the splits' partials merged in split order: with M the
// largest m, o = sum_s o_s e^(m_s - M) / sum_s l_s e^(m_s - M); 0 when no
// split saw a slot. One warp per row.
template <int HD, typename OT>
__global__ void __launch_bounds__(128)
cached_attn_combine_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_m,
                           const float* __restrict__ ws_l, OT* __restrict__ o, int rows,
                           int splits) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ws_m[(size_t)s * rows + row]);
  float L = 0.f, x[HD / 32];
#pragma unroll
  for (int j = 0; j < HD / 32; ++j) x[j] = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const size_t at = (size_t)s * rows + row;
      const float f = expf(ws_m[at] - M);
      L += ws_l[at] * f;
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) x[j] += ws_o[at * HD + lane + 32 * j] * f;
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 32; ++j)
    put(o + (size_t)row * HD + lane + 32 * j, L > 0.f ? x[j] / L : 0.f);
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


template <int HD, int KW, typename CT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* smask, void* o, void* ws_o, void* ws_m,
                       void* ws_l, int B, int T, int S, int Hq, int Hkv, int ci, float sm,
                       int splits, cudaStream_t s) {
  using C = K7Tile<HD, KW, CT>;
  const int R = T * (Hq / Hkv);
  const dim3 grid((R + C::ROWS - 1) / C::ROWS, Hkv, B * splits);
  cudaError_t err;
  if ((err = allow_smem(cached_attn_mma<HD, KW, CT>, C::bytes)) != cudaSuccess) return err;
  cached_attn_mma<HD, KW, CT><<<grid, NT_BF16, C::bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(smask), static_cast<bf16*>(o), static_cast<float*>(ws_o),
      static_cast<float*>(ws_m), static_cast<float*>(ws_l), B, T, S, Hq, Hkv, ci, sm, splits);
  return cudaGetLastError();
}

template <int HD, typename CT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* smask, void* o, void* ws_o, void* ws_m, void* ws_l, int B,
                   int T, int S, int Hq, int Hkv, int ci, float sm, int qdtype, int splits,
                   cudaStream_t s) {
  const int R = T * (Hq / Hkv);
  if (qdtype == 1) {
    if (R <= 16)
      return launch_mma<HD, 4, CT>(q, k, v, ks, vs, smask, o, ws_o, ws_m, ws_l, B, T, S, Hq,
                                   Hkv, ci, sm, splits, s);
    return launch_mma<HD, 1, CT>(q, k, v, ks, vs, smask, o, ws_o, ws_m, ws_l, B, T, S, Hq, Hkv,
                                 ci, sm, splits, s);
  }
  const dim3 grid((R + T64 - 1) / T64, Hkv, B);
  const size_t bytes = CachedF32Smem<HD>::bytes;
  cudaError_t err;
  if ((err = allow_smem(cached_attn_f32<HD, CT>, bytes)) != cudaSuccess) return err;
  cached_attn_f32<HD, CT><<<grid, NT_F32, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(smask), static_cast<float*>(o), T, S, Hq, Hkv, ci, sm);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_cache_type(const void* q, const void* k, const void* v, const void* ks,
                              const void* vs, const void* smask, void* o, void* ws_o,
                              void* ws_m, void* ws_l, int B, int T, int S, int Hq, int Hkv,
                              int ci, float sm, int qdtype, int cdtype, int splits,
                              cudaStream_t s) {
  if (cdtype == 2)
    return launch<HD, int8_t>(q, k, v, ks, vs, smask, o, ws_o, ws_m, ws_l, B, T, S, Hq, Hkv,
                              ci, sm, qdtype, splits, s);
  if (cdtype == 1)
    return launch<HD, bf16>(q, k, v, ks, vs, smask, o, ws_o, ws_m, ws_l, B, T, S, Hq, Hkv, ci,
                            sm, qdtype, splits, s);
  return launch<HD, float>(q, k, v, ks, vs, smask, o, ws_o, ws_m, ws_l, B, T, S, Hq, Hkv, ci,
                           sm, qdtype, splits, s);
}

}  // namespace

// qdtype: 0 = fp32, 1 = bf16; cdtype: 0 = fp32, 1 = bf16, 2 = int8 (then ks
// and vs are the scales; otherwise they are not read). hd in {64, 128}.
// splits > 1 (bf16 q only) writes the workspace ws_o (splits, B, T, Hq,
// hd), ws_m, ws_l (splits, B, T, Hq) for smt_cached_attn_combine instead
// of o. Returns cudaGetLastError() after the launch (or the error that
// refused it).
extern "C" int smt_cached_attn(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* slot_mask, void* o, void* ws_o,
                               void* ws_m, void* ws_l, int B, int T, int S, int Hq, int Hkv,
                               int hd, int cache_index, float sm, int qdtype, int cdtype,
                               int splits, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (hd != 64 && hd != 128) ||
      (qdtype != 0 && qdtype != 1) || cdtype < 0 || cdtype > 2 || cache_index < 0 ||
      cache_index + T > S || (cdtype == 2 && (ks == nullptr || vs == nullptr)) || splits < 1 ||
      (splits > 1 && (qdtype != 1 || ws_o == nullptr || ws_m == nullptr || ws_l == nullptr)) ||
      (long long)B * splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 64
                   ? launch_cache_type<64>(q, k, v, ks, vs, slot_mask, o, ws_o, ws_m, ws_l, B, T,
                                           S, Hq, Hkv, cache_index, sm, qdtype, cdtype, splits, s)
                   : launch_cache_type<128>(q, k, v, ks, vs, slot_mask, o, ws_o, ws_m, ws_l, B,
                                            T, S, Hq, Hkv, cache_index, sm, qdtype, cdtype,
                                            splits, s));
}

// o (rows, hd) in dtype (0 fp32, 1 bf16) from the splits' workspace.
extern "C" int smt_cached_attn_combine(const void* ws_o, const void* ws_m, const void* ws_l,
                                       void* o, int rows, int hd, int splits, int dtype,
                                       void* stream) {
  if (rows <= 0 || splits < 1 || (hd != 64 && hd != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + 3) / 4);
  const float* wo = static_cast<const float*>(ws_o);
  const float* wm = static_cast<const float*>(ws_m);
  const float* wl = static_cast<const float*>(ws_l);
  if (hd == 64) {
    if (dtype == 1)
      cached_attn_combine_kernel<64, bf16><<<grid, 128, 0, s>>>(wo, wm, wl,
                                                                static_cast<bf16*>(o), rows, splits);
    else
      cached_attn_combine_kernel<64, float><<<grid, 128, 0, s>>>(wo, wm, wl,
                                                                 static_cast<float*>(o), rows,
                                                                 splits);
  } else {
    if (dtype == 1)
      cached_attn_combine_kernel<128, bf16><<<grid, 128, 0, s>>>(wo, wm, wl,
                                                                 static_cast<bf16*>(o), rows,
                                                                 splits);
    else
      cached_attn_combine_kernel<128, float><<<grid, 128, 0, s>>>(wo, wm, wl,
                                                                  static_cast<float*>(o), rows,
                                                                  splits);
  }
  return (int)cudaGetLastError();
}

// Shared device code of the two flash-decode reads (paged_decode.cu,
// dense_decode.cu), Hopper (sm_90a).
//
// `attend` is one block's work: the G query heads that share kv head `hk`
// of row `b` attend the row's first `n_keys` cache slots with an online
// softmax in f32. The two reads differ only in where a key's row lies (a
// block-table lookup, or contiguous slots) and in whether a slot may be
// masked, which the `Keys` argument supplies:
//   long long row(int key)  index of the key's row in one K/V plane (its
//                           elements start at row * hd, its scale at row)
//   bool valid(int key)     false for a masked slot: it adds exactly 0
//   static constexpr bool kMasked  whether valid() can be false; without a
//                           mask lane 0's key is always live, the running
//                           max always finite, and the guards below compile
//                           away
//
// Design: four warps split the keys in chunks of 32 (chunk i goes to warp
// i % 4); each warp keeps its own online softmax (m, l, acc) per query head
// and the four are merged through shared memory at the end. Within a chunk
// lane j owns key j: it reads the key row once, with 16-byte vector loads,
// for all G scores; then lane j owns output columns j, j + 32, ... and reads
// each V row coalesced, with p and the row offset broadcast by warp
// shuffles. A masked key reads no K row and weights its V row by exactly
// 0, as the reference's -1e30 fill does (a per-step branch around its V
// row measured 2.8x slower on an H100). A chunk whose keys are all masked,
// before any valid key, leaves the running max at -inf and adds nothing
// (no exp(-inf - -inf) = NaN). A head with no valid key writes zeros.
//
// The int8 cache (C = int8_t; the JAX package reads it in XLA,
// ops/attention.py::cached_attention_q8): K and V rows are int8 with one f32
// scale per row in a plane of its own. A lane reads its key's int8 K row
// with 16-byte loads (8-byte where hd % 16 != 0) and multiplies the score
// by the key's K scale, as the reference does after its product; the V
// row is weighted by p * v_scale, kept in f32 (the reference casts that
// product to the query's dtype before its value product). The bytes
// streamed per key fall from 2 * hd * sizeof(T) to 2 * (hd + 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace decode {

constexpr int NWARPS = 4;
constexpr int DMAX = 128;
constexpr int GMAX = 8;  // query heads per kv head a block takes

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// s[g] += q_g . row over hd elements for the first ng of GT query heads
// (hd % 8 == 0, row 16-byte aligned): the row is read once for all heads
template <int GT>
__device__ __forceinline__ void row_dots(const float (*qs)[DMAX], const float* row,
                                         int hd, int ng, float* s) {
  for (int c = 0; c < hd; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < ng) {
        s[g] = fmaf(qs[g][c], x.x, s[g]);
        s[g] = fmaf(qs[g][c + 1], x.y, s[g]);
        s[g] = fmaf(qs[g][c + 2], x.z, s[g]);
        s[g] = fmaf(qs[g][c + 3], x.w, s[g]);
      }
    }
  }
}

template <int GT>
__device__ __forceinline__ void row_dots(const float (*qs)[DMAX], const __nv_bfloat16* row,
                                         int hd, int ng, float* s) {
  for (int c = 0; c < hd; c += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c);
    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&u);
    float2 f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(pr[i]);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < ng) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[g] = fmaf(qs[g][c + 2 * i], f[i].x, s[g]);
          s[g] = fmaf(qs[g][c + 2 * i + 1], f[i].y, s[g]);
        }
      }
    }
  }
}

// s[g] += q_g . w over the four int8 values packed in the 32-bit word w
template <int GT>
__device__ __forceinline__ void word_dots(const float (*qs)[DMAX], unsigned w, int c,
                                          int ng, float* s) {
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[g] = fmaf(qs[g][c + i], f[i], s[g]);
    }
  }
}

// the int8 row (hd % 8 == 0): 16-byte loads where hd % 16 == 0 (every row
// then starts 16-byte aligned), else 8-byte loads
template <int GT>
__device__ __forceinline__ void row_dots(const float (*qs)[DMAX], const int8_t* row,
                                         int hd, int ng, float* s) {
  if (hd % 16 == 0) {
    for (int c = 0; c < hd; c += 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + c);
      word_dots<GT>(qs, u.x, c, ng, s);
      word_dots<GT>(qs, u.y, c + 4, ng, s);
      word_dots<GT>(qs, u.z, c + 8, ng, s);
      word_dots<GT>(qs, u.w, c + 12, ng, s);
    }
  } else {
    for (int c = 0; c < hd; c += 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(row + c);
      word_dots<GT>(qs, u.x, c, ng, s);
      word_dots<GT>(qs, u.y, c + 4, ng, s);
    }
  }
}

// T: query and output type. C: cache element type, T or int8_t; for int8
// kscale and vscale are the planes of per-row f32 scales (else null).
// DV: ceil(hd / 32) output columns per lane. GT: 1 for
// plain multi-head attention, else GMAX (the first ng of GT heads are
// live). Call from every thread of an NWARPS * 32 block.
template <typename T, typename C, int DV, int GT, typename Keys>
__device__ __forceinline__ void attend(const T* __restrict__ q, const C* __restrict__ kplane,
                                       const C* __restrict__ vplane,
                                       const float* __restrict__ kscale,
                                       const float* __restrict__ vscale, T* __restrict__ out,
                                       const Keys& keys, int n_keys, int b, int hk, int ng,
                                       int hd, long long q_sb, long long q_sh,
                                       long long o_sb, long long o_sh, float scale) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  __shared__ float qs[GT][DMAX];
  __shared__ float red_m[NWARPS][GT], red_l[NWARPS][GT];
  __shared__ float red_acc[NWARPS][GT][DMAX];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < ng * hd; i += blockDim.x) {
    const int g = i / hd, c = i % hd;
    qs[g][c] = to_f(q[b * q_sb + (hk * ng + g) * q_sh + c]);
  }
  __syncthreads();

  float m[GT], l[GT], acc[GT][DV];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int x = 0; x < DV; ++x) acc[g][x] = 0.f;
  }

  for (int k0 = warp * 32; k0 < n_keys; k0 += NWARPS * 32) {
    const int key = k0 + lane;
    const bool live = key < n_keys && keys.valid(key);
    // this key's row in one plane, and its elements' offset (a masked
    // key's V row is read below)
    const long long row = key < n_keys ? keys.row(key) : 0;
    const long long off = row * hd;
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
    if (live) row_dots<GT>(qs, kplane + off, hd, ng, s);
    // int8: the key's K and V scales (0 past the row's last key)
    float ks = 1.f, vs = 1.f;
    if constexpr (kQ8) {
      ks = key < n_keys ? kscale[row] : 0.f;
      vs = key < n_keys ? vscale[row] : 0.f;
    }
    float pr[GT], pw[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < ng) {  // uniform across the block: the shuffles see every lane
        const float sg = !live ? -INFINITY : kQ8 ? s[g] * scale * ks : s[g] * scale;
        const float m_new = fmaxf(m[g], warp_max(sg));
        // m_new is -inf only while every key so far was masked; then
        // l and acc are still 0 and stay so
        const float alpha = Keys::kMasked && m_new == -INFINITY
                                ? 1.f : expf(m[g] - m_new);
        pr[g] = !Keys::kMasked || live ? expf(sg - m_new) : 0.f;
        l[g] = l[g] * alpha + warp_sum(pr[g]);
        pw[g] = kQ8 ? pr[g] * vs : pr[g];  // the V row's weight
#pragma unroll
        for (int x = 0; x < DV; ++x) acc[g][x] *= alpha;
        m[g] = m_new;
      }
    }
    // a masked key's V row is read and weighted by p = 0: skipping it in
    // this warp-wide loop costs more than it saves (a branch around the
    // shuffles of each step)
    const int cnt = min(32, n_keys - k0);
    for (int j = 0; j < cnt; ++j) {
      const long long rj = __shfl_sync(0xffffffffu, off, j);
      const C* vr = vplane + rj;
      float vv[DV];
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        vv[x] = c < hd ? to_f(vr[c]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < ng) {
          const float pj = __shfl_sync(0xffffffffu, pw[g], j);
#pragma unroll
          for (int x = 0; x < DV; ++x) acc[g][x] = fmaf(pj, vv[x], acc[g][x]);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng) {
      if (lane == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        if (c < hd) red_acc[warp][g][c] = acc[g][x];
      }
    }
  }
  __syncthreads();
  for (int g = warp; g < ng; g += NWARPS) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, red_m[w][g]);
    float L = 0.f, o[DV];
#pragma unroll
    for (int x = 0; x < DV; ++x) o[x] = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = red_m[w][g] == -INFINITY ? 0.f : expf(red_m[w][g] - M);
      L += red_l[w][g] * f;
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        if (c < hd) o[x] = fmaf(red_acc[w][g][c], f, o[x]);
      }
    }
    L = fmaxf(L, 1e-30f);
    T* orow = out + b * o_sb + (hk * ng + g) * o_sh;
#pragma unroll
    for (int x = 0; x < DV; ++x) {
      const int c = lane + 32 * x;
      if (c < hd) store(&orow[c], o[x] / L);
    }
  }
}

}  // namespace decode

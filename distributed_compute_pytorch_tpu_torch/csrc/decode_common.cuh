// Shared device code of the two flash-decode reads (paged_decode.cu,
// dense_decode.cu), Hopper (sm_90a).
//
// `attend` is one block's share of a read: the G query heads that share kv
// head `hk` of row `b` attend one split of the row's first `n_keys` cache
// slots with an online softmax in f32, and the last of the (row, kv head)'s
// splits to finish merges them, inside the same launch. The two reads differ
// only in where a key's row lies (a block-table lookup, or contiguous slots)
// and in whether a slot may be masked, which the `Keys` argument supplies:
//   long long row(int key)  index of the key's row in one K/V plane (its
//                           elements start at row * hd, its scale at row)
//   bool valid(int key)     false for a masked slot: it adds exactly 0
//   long long dest(int key) the row the fused write puts the key in, or -1
//                           when the write is dropped (only with WR)
//
// What bounds it on this card: HBM bytes in principle, latency in practice.
//   A read streams each live key's K and V rows once (2 * hd elements, plus
//   two f32 scales in the int8 form) and does ~4 G FLOPs per element, far
//   below the card's ~295 FLOP/byte balance point. But a serving tick's read
//   is 5-25 MB spread over 192 (row, kv head) pairs: what sets its time is
//   how many bytes are in flight and how long a block's chain of dependent
//   round trips is (pos, the lookups, the copies, the merge).
//
// Design (flash-decoding):
// 1. Split keys. The grid is (split, kv head, row); the host fixes the split
//    count S from static shapes only: the row's capacity over the split
//    length SPLIT_KEYS = 256, at most SMAX = 16. Each block reads
//    `pos` itself and takes its even share of the row's live keys, rounded
//    up to `gran` keys (the paged read's block size, so a split reads whole
//    physical blocks): a short row leaves the last splits empty, and an
//    empty split loads nothing and merges as (m, l, acc) = (-inf, 0, 0). The
//    host never reads `pos` and never syncs.
// 2. Look up, then copy. A block looks its keys' rows up (through the table,
//    or base + key) and reads their mask bytes in one round trip, into
//    shared memory, for a window of up to 1024 keys. It then stages the K and
//    V rows in shared memory with cp.async: 16-byte copies where a row is a
//    multiple of 16 bytes, else 8-byte (int8 rows with hd % 16 == 8), 4-byte
//    for the f32 scales; K (and its scales) as one commit group, V as a
//    second, so the scores are computed while V is still arriving. Where the
//    share fits (up to 256 keys in the 64 KB budget) it is one tile, all in
//    flight at once; a longer one walks a ring of 2-4 tiles, the next
//    tiles' copies in flight while one is computed. A tile whose slots are
//    all masked (a left-pad run) copies nothing and computes nothing.
// 3. Compute from shared memory. A group of KL lanes (KL = hd / 8 rounded up
//    to a power of two) owns one key at a time and lane i of the group its
//    columns 8i..8i+7. A group reads KL consecutive 8-element chunks of one
//    row and the warp 32 / KL consecutive rows, so the rows need no padding
//    or swizzle: each 16-byte (bf16) or 8-byte (int8) load of a warp touches
//    distinct banks (f32 rows, two 16-byte loads a lane, take a 2-way
//    conflict). The group's scores stay in registers (q in registers, a
//    butterfly over the group); one shared-memory exchange a tile gives the
//    block's max, the same in every thread, so every warp turns its own
//    scores into p (kept in f32) and the warps' sums add without rescaling.
// 4. Merge in the same launch. Each block writes its (m, l, unnormalised
//    acc) to an f32 workspace and takes a ticket (an atomic add on the
//    (row, kv head)'s counter); the block that takes the last ticket merges
//    the S partials in split order, writes the output and resets the
//    counter to 0. The workspace and counters belong to one stream (the
//    wrapper keeps them per device and stream), so two reads in flight on
//    two streams never share them. With S = 1 the block writes its output
//    directly. One launch per read, a fixed summation order everywhere: two
//    launches give the same bits. A thread-block cluster merging through
//    distributed shared memory was the first design; on an H100 its many
//    8-block clusters cost more to launch than the merge saved (PERF.md).
//
// 5. The fused write (WR, the `*_write` C entries): one decode tick's cache
//    write and read in one launch. The tick's fresh K and V rows of a (row,
//    kv head) (`Write`: strided [B, Hk, hd] views, the fused QKV's output)
//    land in logical key `wkey` of that row, which the kernel derives from
//    `pos` as the standalone write does. The block whose split holds
//    `wkey` writes them, once for its G query heads: warp 0 the K row,
//    warp 1 the V row, an int8 cache each row quantized (q8::
//    quantize_values, bit for bit the standalone write's) with its scale.
//    Their loads, and the table lookup of their row (`dest`), go out in
//    the same round trip as the first window's lookups, and the stores
//    before the barrier that ends it, so the write adds no dependent round
//    trip. The barrier orders the stores before every later cp.async of
//    the block: a non-bulk cp.async reads through the generic proxy, as
//    an ordinary load does (a TMA, cp.async.bulk, reads through the async
//    proxy and would need `fence.proxy.async` after the stores). So the
//    read attends the row as the cache now holds it (the int8 bytes and
//    scale, never the float row in registers), as the standalone write
//    followed by the read-only read does, with the same bits: the plan,
//    the splits and the summation order are the read-only read's. No other
//    block of the launch reads that row: a live row's table maps no other
//    row's written block. Only the paged pool's shared trash block breaks
//    that: parked rows (all-trash tables) may write a trash slot while
//    another parked row's block reads it. That race is benign: the
//    scheduler discards parked rows' outputs, and the trash block is
//    never attended by a live row.
//
// No tensor cores: one query token per head gives an mma tile 1 live row in
// 16 (GPT-2 is MHA, G = 1; 8 in 16 at the largest GQA group), and the read
// needs ~4 FLOPs per cached element, some 25 M FMAs at the serving shape,
// about a microsecond of the CUDA cores. What it needs is bytes in flight
// and short chains: shared memory and asynchronous copies.
//
// Masks and empty heads: a masked slot's score is -inf and its p exactly 0
// (its V row, loaded with its tile, is weighted by 0, as the reference's
// -1e30 fill weights it). A head with no valid key writes zeros.
//
// The int8 cache (C = int8_t; the JAX package reads it in XLA,
// ops/attention.py::cached_attention_q8): K and V rows are int8 with one f32
// scale per row in a plane of its own. The score is multiplied by the key's
// K scale after its product, as the reference does; the V row is weighted
// by p * v_scale, kept in f32 (the reference casts that product to the
// query's dtype before its value product). The bytes streamed per key fall
// from 2 * hd * sizeof(T) to 2 * (hd + 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "quantize_common.cuh"

namespace decode {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int DMAX = 128;
constexpr int GMAX = 8;            // query heads per kv head a block takes
constexpr int SMAX = 16;           // splits of one (row, kv head) at most
constexpr int SPLIT_KEYS = 256;    // split length: S = capacity / this
constexpr int KV_BUDGET = 65536;   // shared bytes of the K/V (and scale) tiles
constexpr int WIN_MAX = 1024;      // keys one lookup window holds
constexpr int NST_MAX = 4;         // tiles in flight at most
constexpr int TILE_MAX = 256;      // keys of the one tile of a window taken at once
constexpr int SMEM_MAX = 227 * 1024;
constexpr int SMEM_DEFAULT = 48 * 1024;

// splits of a row of `capacity` keys
inline int split_count(long long capacity) {
  const long long s = (capacity + SPLIT_KEYS - 1) / SPLIT_KEYS;
  return static_cast<int>(s < 1 ? 1 : s > SMAX ? SMAX : s);
}

// lanes a key takes: hd / 8 chunks of 8 columns, rounded up to 4, 8 or 16
inline int lanes_per_key(int hd) { return hd <= 32 ? 4 : hd <= 64 ? 8 : 16; }

// The host's plan of one launch, the same in every block: the split count,
// the lookup window, the tiles and the byte offsets of the dynamic shared
// memory.
struct Plan {
  int S, gran, win, tile, nst, rb;
  int kv, scale, wmax, last, rows, valid, live, bytes;
};

// keys a lane group keeps the scores of in registers, per tile
template <int GT>
__host__ __device__ constexpr int keys_per_group() { return GT == 1 ? 16 : 2; }

// capacity: a row's slots; gran: a split's share is a multiple of it; esz:
// bytes of a cache element; gt: the kernel's GT
inline Plan make_plan(long long capacity, int gran, int hd, int esz, bool q8, int gt) {
  Plan P;
  P.S = split_count(capacity);
  P.gran = gran;
  const long long share = ((capacity + P.S - 1) / P.S + gran - 1) / gran * gran;
  P.win = static_cast<int>(share < WIN_MAX ? share : WIN_MAX);
  P.rb = hd * esz;
  // a tile's keys: each lane group keeps the scores of at most
  // keys_per_group of them
  int cap = (gt == 1 ? keys_per_group<1>() : keys_per_group<GMAX>()) * NWARPS * 32 /
            lanes_per_key(hd);
  if (cap > TILE_MAX) cap = TILE_MAX;
  const int key_bytes = 2 * P.rb + (q8 ? 8 : 0);   // a key's K and V rows (and scales)
  if (P.win <= cap && P.win * key_bytes <= KV_BUDGET) {  // the window at once
    P.tile = P.win;
    P.nst = 1;
  } else {                                         // a ring of tiles
    P.nst = 2;
    P.tile = cap < 128 ? cap : 128;
    while (P.tile > 16 && P.nst * P.tile * key_bytes > KV_BUDGET) P.tile >>= 1;
    while (P.nst < NST_MAX && (P.nst + 1) * P.tile * key_bytes <= KV_BUDGET) ++P.nst;
  }
  const int kv = 2 * P.nst * P.tile * P.rb;        // [stage][K, V][tile][rb]
  const int red = NWARPS * gt * (hd + 2) * 4;      // the warps' sums, after the last tile
  int o = 0;
  P.kv = o;    o += ((kv > red ? kv : red) + 15) & ~15;
  P.scale = o; o += q8 ? 2 * P.nst * P.tile * 4 : 0;  // [stage][K, V][tile] f32
  P.wmax = o;  o += NWARPS * gt * 4;                  // the warps' tile maxima
  P.last = o;  o += 16;                               // this block merges
  P.rows = o;  o += P.win * 4;                        // the window's row indices
  P.valid = o; o += P.win;                            // its mask bytes
  P.live = o;  o += (P.win + P.tile - 1) / P.tile;    // a tile has a valid key
  P.bytes = (o + 15) & ~15;
  return P;
}

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ---- asynchronous copies, global -> shared --------------------------------

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const size_t s = __cvta_generic_to_global(src);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(s) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(s), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (< 2 * NST_MAX) of this thread's groups are pending
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}

// cnt rows of rb bytes (row indices in rows[]) from a plane into dst, in
// N-byte copies spread over the block
template <int N>
__device__ __forceinline__ void copy_rows_n(unsigned char* dst, const unsigned char* plane,
                                            const uint32_t* rows, int cnt, int rb) {
  const int per_row = rb / N;
  for (int i = threadIdx.x; i < cnt * per_row; i += NTHREADS) {
    const int k = i / per_row, c = i - k * per_row;
    cp_async<N>(dst + k * rb + c * N, plane + (long long)rows[k] * rb + c * N);
  }
}

__device__ __forceinline__ void copy_rows(unsigned char* dst, const void* plane,
                                          const uint32_t* rows, int cnt, int rb) {
  const unsigned char* p = static_cast<const unsigned char*>(plane);
  if (rb % 16 == 0)
    copy_rows_n<16>(dst, p, rows, cnt, rb);
  else
    copy_rows_n<8>(dst, p, rows, cnt, rb);
}

__device__ __forceinline__ void copy_scales(float* dst, const float* plane,
                                            const uint32_t* rows, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += NTHREADS) cp_async<4>(dst + k, plane + rows[k]);
}

// ---- one lane's 8 columns of a row in shared memory, as f32 ---------------

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * i)));
    x[4 + i] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * i)));
  }
}

// The fused write's operands (WR): the tick's K and V rows, T elements of
// unit stride on hd at element strides (row, head) k_sb, k_sh, v_sb, v_sh,
// and the cache planes they go into (the scale planes of an int8 cache,
// else null).
template <typename T, typename C>
struct Write {
  const T* k;
  const T* v;
  C* kplane;
  C* vplane;
  float* kscale;
  float* vscale;
  long long k_sb, k_sh, v_sb, v_sh;
};

// T: query and output type. C: cache element type, T or int8_t; for int8
// kscale and vscale are the planes of per-row f32 scales (else null).
// GT: 1 for plain multi-head attention, else GMAX (the first ng of GT heads
// are live). KL: lanes a key takes (lanes_per_key(hd)). WR: the fused
// write (design 5) of `wr`'s rows of (b, hk) into logical key `wkey` (-1:
// no write; both ignored without WR). P: the host's plan (make_plan). Call
// from every thread of an NTHREADS block of a grid whose x is the (row, kv
// head)'s P.S splits, with P.bytes of dynamic shared memory.
template <typename T, typename C, int GT, int KL, bool WR, typename Keys>
__device__ __forceinline__ void attend(const T* __restrict__ q, const C* __restrict__ kplane,
                                       const C* __restrict__ vplane,
                                       const float* __restrict__ kscale,
                                       const float* __restrict__ vscale, T* __restrict__ out,
                                       float* __restrict__ ws, int* __restrict__ tickets,
                                       const Keys& keys, const Plan& P, int n_keys, int b,
                                       int hk, int Hk, int ng, int hd, long long q_sb,
                                       long long q_sh, long long o_sb, long long o_sh,
                                       float scale, const Write<T, C> wr, int wkey) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr int GPW = 32 / KL;                  // key groups a warp
  constexpr int NG = NWARPS * GPW;              // key groups a block
  constexpr int KPG = keys_per_group<GT>();     // a group's keys a tile (tile <= KPG * NG)
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int tile = P.tile, rb = P.rb, nst = P.nst, hd_c = rb / static_cast<int>(sizeof(C));

  float* wmax = reinterpret_cast<float*>(smem + P.wmax);
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(smem + P.rows);
  uint8_t* vm_s = smem + P.valid;
  uint8_t* live_s = smem + P.live;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp * GPW + lane / KL;   // the lane's key group
  const int li = lane % KL;                 // and its column chunk
  const bool has_col = li < hd / 8;

  // this split's keys: an even share of the live ones, whole granules
  const int per = ((n_keys + P.S - 1) / P.S + P.gran - 1) / P.gran * P.gran;
  const int lo = min(split * per, n_keys), hi = min(lo + per, n_keys);

  // the lane's query columns; its share of acc and l; the running max,
  // the same in every thread
  float qr[GT][8], acc[GT][8], l[GT], m[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      qr[g][j] = g < ng && has_col
                     ? to_f(q[b * q_sb + (hk * ng + g) * q_sh + li * 8 + j]) : 0.f;
      acc[g][j] = 0.f;
    }
    l[g] = 0.f;
    m[g] = -INFINITY;
  }

  for (int w0 = lo; w0 < hi; w0 += P.win) {   // one window unless a split is long
    const int wn = min(P.win, hi - w0), nt = (wn + tile - 1) / tile;
    // the window's rows and mask bytes, in one round trip
    for (int i = threadIdx.x; i < nt; i += NTHREADS) live_s[i] = 0;
    __syncthreads();
    // the fused write (design 5): this split holds the fresh key; warp 0
    // loads its K row, warp 1 its V row (lane j: elements j, j + 32, ...),
    // and the row they go to, beside the lookups below
    T fx[DMAX / 32];
    long long frow = -1;
    const bool wwarp = WR && w0 == lo && wkey >= lo && wkey < hi && warp < 2;
    if constexpr (WR) {
      if (wwarp) {
        const T* src = warp == 0 ? wr.k + b * wr.k_sb + hk * wr.k_sh
                                 : wr.v + b * wr.v_sb + hk * wr.v_sh;
#pragma unroll
        for (int i = 0; i < DMAX / 32; ++i) {
          const int c = lane + 32 * i;
          if (c < hd) fx[i] = src[c];
        }
        frow = keys.dest(wkey);
      }
    }
    for (int k = threadIdx.x; k < wn; k += NTHREADS) {
      rows_s[k] = static_cast<uint32_t>(keys.row(w0 + k));
      const bool v = keys.valid(w0 + k);
      vm_s[k] = v;
      if (v) live_s[k / tile] = 1;
    }
    if constexpr (WR) {
      if (wwarp && frow >= 0) {   // frow is the same in the whole warp
        C* dst = (warp == 0 ? wr.kplane : wr.vplane) + frow * hd;
        if constexpr (kQ8) {
          float x[DMAX / 32];
#pragma unroll
          for (int i = 0; i < DMAX / 32; ++i) x[i] = lane + 32 * i < hd ? to_f(fx[i]) : 0.f;
          q8::quantize_values(x, hd, lane, dst, (warp == 0 ? wr.kscale : wr.vscale) + frow);
        } else {
#pragma unroll
          for (int i = 0; i < DMAX / 32; ++i) {
            if (lane + 32 * i < hd) dst[lane + 32 * i] = fx[i];
          }
        }
      }
    }
    // the lookups, and the fresh rows' stores, before any copy is issued
    __syncthreads();

    // tile t's K and V copies into stage t % nst, as two commit groups
    // (empty for a tile with no valid key)
    auto issue = [&](int t) {
      const int st = t % nst, k0 = t * tile, cnt = min(tile, wn - k0);
      unsigned char* kt = smem + P.kv + 2 * st * tile * rb;
      float* sc = reinterpret_cast<float*>(smem + P.scale) + 2 * st * tile;
      const bool lv = live_s[t];
      if (lv) {
        copy_rows(kt, kplane, rows_s + k0, cnt, rb);
        if constexpr (kQ8) copy_scales(sc, kscale, rows_s + k0, cnt);
      }
      cp_commit();
      if (lv) {
        copy_rows(kt + tile * rb, vplane, rows_s + k0, cnt, rb);
        if constexpr (kQ8) copy_scales(sc + tile, vscale, rows_s + k0, cnt);
      }
      cp_commit();
    };
    for (int t = 0; t < nst && t < nt; ++t) issue(t);

    for (int t = 0; t < nt; ++t) {
      const int st = t % nst, k0 = t * tile, cnt = min(tile, wn - k0);
      const int after = min(nst, nt - t) - 1;   // tiles issued after this one
      if (live_s[t]) {
        const C* kt = reinterpret_cast<const C*>(smem + P.kv + 2 * st * tile * rb);
        const C* vt = reinterpret_cast<const C*>(smem + P.kv + (2 * st + 1) * tile * rb);
        const float* ksc = reinterpret_cast<const float*>(smem + P.scale) + 2 * st * tile;
        const float* vsc = ksc + tile;
        const uint8_t* vm = vm_s + k0;
        // K has arrived (V and the later tiles may still be in flight)
        cp_wait_n(2 * after + 1);
        __syncthreads();
        // scores of the group's keys grp + j * NG, kept in registers
        float sc[KPG][GT], tmax[GT];
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          tmax[g] = -INFINITY;
#pragma unroll
          for (int j = 0; j < KPG; ++j) sc[j][g] = -INFINITY;
        }
#pragma unroll
        for (int j = 0; j < KPG; ++j) {
          if (warp * GPW + j * NG >= cnt) break;   // uniform across the warp
          const int k = grp + j * NG;
          float s[GT];
#pragma unroll
          for (int g = 0; g < GT; ++g) s[g] = 0.f;
          if (has_col && k < cnt) {
            float x[8];
            load8(kt + k * hd_c + li * 8, x);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              if (g < ng) {
#pragma unroll
                for (int i = 0; i < 8; ++i) s[g] = fmaf(qr[g][i], x[i], s[g]);
              }
            }
          }
          const bool ok = k < cnt && vm[k];
          const float kscl = kQ8 && ok ? ksc[k] : 1.f;
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            if (g < ng) {
#pragma unroll
              for (int o = KL / 2; o > 0; o >>= 1)
                s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
              sc[j][g] = !ok ? -INFINITY : kQ8 ? s[g] * scale * kscl : s[g] * scale;
              tmax[g] = fmaxf(tmax[g], sc[j][g]);
            }
          }
        }
        // the tile's max over the block, the same in every thread
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          if (g < ng) {
            const float x = warp_max(tmax[g]);
            if (lane == 0) wmax[warp * GT + g] = x;
          }
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          if (g < ng) {
            float x = wmax[g];
#pragma unroll
            for (int w = 1; w < NWARPS; ++w) x = fmaxf(x, wmax[w * GT + g]);
            // finite: the tile has a valid key
            const float m_new = fmaxf(m[g], x);
            const float alpha = expf(m[g] - m_new);
            m[g] = m_new;
            l[g] *= alpha;
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
#pragma unroll
            for (int j = 0; j < KPG; ++j) {
              const float p = sc[j][g] == -INFINITY ? 0.f : expf(sc[j][g] - m_new);
              sc[j][g] = p;
              l[g] += p;
            }
          }
        }
        // V has arrived
        cp_wait_n(2 * after);
        __syncthreads();
        if (has_col) {
#pragma unroll
          for (int j = 0; j < KPG; ++j) {
            const int k = grp + j * NG;
            if (warp * GPW + j * NG >= cnt) break;
            if (k < cnt) {
              float x[8];
              load8(vt + k * hd_c + li * 8, x);
              const float vs = kQ8 ? vsc[k] : 1.f;
#pragma unroll
              for (int g = 0; g < GT; ++g) {
                if (g < ng) {
                  const float wv = kQ8 ? sc[j][g] * vs : sc[j][g];  // p * v_scale
#pragma unroll
                  for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(wv, x[i], acc[g][i]);
                }
              }
            }
          }
        }
      }
      // this stage's buffers are free for tile t + nst
      __syncthreads();
      if (t + nst < nt) issue(t + nst);
    }
  }

  // the block's partial: acc and l summed over each warp's key groups, then
  // over the warps, in a fixed order
  const int pw = hd + 2;                   // a head's partial: acc, l, m
  float* red = reinterpret_cast<float*>(smem + P.kv);   // the tiles are free
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng) {
#pragma unroll
      for (int o = KL; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], o);
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
      }
      float* r = red + (warp * GT + g) * pw;
      if (lane < KL && has_col) {
#pragma unroll
        for (int i = 0; i < 8; ++i) r[li * 8 + i] = acc[g][i];
      }
      if (lane == 0) r[hd] = l[g];
    }
  }
  __syncthreads();
  if (P.S == 1) {  // the one split's partial is the output (no valid key: zeros)
    for (int i = threadIdx.x; i < ng * hd; i += NTHREADS) {
      const int g = i / hd, c = i - g * hd;
      float a = 0.f, L = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        a += red[(w * GT + g) * pw + c];
        L += red[(w * GT + g) * pw + hd];
      }
      store(&out[b * o_sb + (hk * ng + g) * o_sh + c], a / fmaxf(L, 1e-30f));
    }
    return;
  }
  // write it to the workspace; the last of the (row, kv head)'s splits to
  // take a ticket merges them in split order (an empty split, or no valid
  // key at all, weighs 0), writes the output and resets the ticket
  const long long pair = (long long)b * Hk + hk;
  float* mine = ws + (pair * P.S + split) * ng * pw;
  for (int i = threadIdx.x; i < ng * (hd + 1); i += NTHREADS) {
    const int g = i / (hd + 1), c = i - g * (hd + 1);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) a += red[(w * GT + g) * pw + c];
    mine[g * pw + c] = a;
  }
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng && threadIdx.x == g) mine[g * pw + hd + 1] = m[g];
  }
  int* last = reinterpret_cast<int*>(smem + P.last);
  __threadfence();      // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(tickets + pair, 1) == P.S - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* pt = ws + pair * P.S * ng * pw;
  for (int i = threadIdx.x; i < ng * hd; i += NTHREADS) {
    const int g = i / hd, c = i - g * hd;
    float M = -INFINITY;
    for (int s = 0; s < P.S; ++s) M = fmaxf(M, __ldcg(pt + (s * ng + g) * pw + hd + 1));
    float L = 0.f, o = 0.f;
    for (int s = 0; s < P.S; ++s) {
      const float* x = pt + (s * ng + g) * pw;
      const float ms = __ldcg(x + hd + 1);
      const float f = ms == -INFINITY ? 0.f : expf(ms - M);
      L += __ldcg(x + hd) * f;
      o = fmaf(__ldcg(x + c), f, o);
    }
    store(&out[b * o_sb + (hk * ng + g) * o_sh + c], o / fmaxf(L, 1e-30f));
  }
  if (threadIdx.x == 0) tickets[pair] = 0;   // ready for the next read on this stream
}

// The merge's scratch, which the caller keeps for each stream (two reads in
// flight on two streams must not share it): `ws` holds B * Hk * SMAX * G *
// (hd + 2) floats; `tickets` B * Hk ints, zero before the first launch, and
// each launch leaves them zero.

// A launch's plan as the C entries report it (a function of the shapes
// only): out[0..4] = S, SPLIT_KEYS, tile keys, tiles in flight, shared bytes.
inline void report_plan(const Plan& P, int* out) {
  const int v[5] = {P.S, SPLIT_KEYS, P.tile, P.nst, P.bytes};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
}

// Allow `kernel` `bytes` of dynamic shared memory (above the 48 KB default
// its limit must be raised, once per kernel and size; the kernels of one
// source share a signature, so the record is kept by address).
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  static std::mutex mu;
  static const void* fns[64];
  static int allowed[64], n = 0;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n && fns[i] != kernel) ++i;
  if (i < n && allowed[i] >= bytes) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess || (i == n && n == 64)) return e;
  fns[i] = kernel;
  allowed[i] = bytes;
  if (i == n) ++n;
  return cudaSuccess;
}

// Plan and launch `kernel` on grid (S, Hk, B), S the capacity over the
// split length, at most SMAX, with the plan's dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), long long capacity, int gran, int hd,
                         int esz, bool q8, int gt, int Hk, int B, cudaStream_t stream,
                         Args... args) {
  const Plan plan = make_plan(capacity, gran, hd, esz, q8, gt);
  if (plan.bytes > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), plan.bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(plan.S, Hk, B), NTHREADS, plan.bytes, stream>>>(args..., plan);
  return cudaGetLastError();
}

}  // namespace decode

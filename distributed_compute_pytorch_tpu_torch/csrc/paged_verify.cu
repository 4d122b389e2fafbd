// Paged speculative-verify attention for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces: no Pallas call. The JAX package verifies a draft window in XLA,
//   distributed_compute_pytorch_tpu/ops/attention.py:356
//   `cache_verify_and_attend`: the window's K/V scattered through the block
//   table (positions at or past the table's horizon nb * bt dropped), then
//   `gather_kv_blocks` + `cached_attention` under the per-query staircase
//   mask. This kernel is the port's form of that op, as paged_decode.cu's
//   fused tick is of `cache_write_and_attend`: one launch a layer a verify
//   step.
//
// What it computes. Row b's window of W tokens sits at logical slots
//   pos0 + 1 .. pos0 + W, where pos0 = positions[b, 0] - 1 (positions [B, W]
//   are consecutive per row). For each (row, kv head):
//   1. the W fresh K and V rows are written into the pool at the (block,
//      offset) the row's table maps each slot to, dropped at or past the
//      horizon H = nb * bt or where the table entry lies outside [0, P); an
//      int8 pool takes each row quantized bit for bit as quantize_kv
//      (q8::quantize_value at q8::group_scale, quantize_common.cuh);
//   2. query (g, w) of each of the G query heads that share the kv head
//      attends slots 0 .. min(pos0 + 1 + w, H - 1): the prefix 0 .. pos0
//      from the pool through the table (entries clamped into [0, P), as the
//      reference's gather clamps), and the window's own keys w' <= w whose
//      slot lies under H. An int8 window key is attended as its quantized
//      row and scale, what the reference reads back from the gathered pool.
//
// What bounds it on this card: HBM bytes in principle, latency in practice,
//   as the decode reads (decode_common.cuh). A verify step reads each live
//   prefix K/V row once for all G x W queries, so its bytes are one decode
//   tick's plus the window's; it does ~4 G W FLOPs per cached element, still
//   far under the card's ~295 FLOP/byte balance point. A block holds a few
//   hundred live keys at the serve shape, so what sets its time is the chain
//   of dependent steps a block walks (the lookups, the copies, the products,
//   the merge) and how many of those chains run at once.
//
// Design:
// - Splits: the prefix's live keys split over S blocks, whole table blocks
//   each, looked up in one round trip a window of up to 1024 keys and staged
//   in shared memory by cp.async, a ring of `nst` tiles in flight; the last
//   split of a (row, kv head, query group) to take its ticket merges the
//   partial softmax sums in split order, in the same launch. S is capacity /
//   256 (at most 16); the tensor-core form then takes the most splits up to
//   that which keep the whole grid within one wave of the card (a function
//   of the shapes only: rows x kv heads x query groups against 132 SMs at
//   the blocks an SM its shared memory allows): its keys cost little, a
//   block's fixed chain sets its time, and a second wave would wait for the
//   first's whole chains. The CUDA-core form keeps every split.
// - Queries: a block takes up to QMAX = 16 of the G x W queries (query i is
//   head g = i / W, window position w = i % W: the reference's folded
//   order). A larger G x W adds query groups to the grid's x (x = group * S
//   + split), each re-reading the keys.
// - Each staged key is read once a block. A tile's keys are dealt to the 4
//   warps in chunks of KC = 16 (chunk j to warp j % 4); every warp holds all
//   of the block's queries against its own chunks, with its own running
//   max, sum and accumulator, and the 4 warps' partials are merged in
//   shared memory, in warp order, before the split's partial goes out.
// - bf16 queries (over a bf16 or an int8 pool): QK^T and P.V on the tensor
//   cores, mma.sync.m16n8k16 with the 16 queries as the A operand's rows
//   (wgmma needs 64 rows). The tiles sit in shared memory as [key][DP + 8]
//   bf16, mma_common.cuh's layout (DP 32, 64 or 128, the head dim rounded
//   up; columns hd..DP zero, so a k16 step over the padding adds exactly
//   0; the 16-byte row pad keeps ldmatrix free of bank conflicts), read
//   into fragments by its ldmatrix helpers (V transposed on the way). The queries' A fragments stay in registers. The
//   softmax runs in base 2 (scores times log2(e), ex2.approx). An int8
//   pool's rows are staged as int8 and each warp converts its own chunks to
//   bf16 in a buffer of its own, exactly (|x| <= 127), so the conversion
//   adds no barrier; the K scale still multiplies the score after the
//   product.
//   P.V rounding: p (unnormalised, f32) times the int8 form's v_scale is
//   rounded to bf16 for the product, as the reference rounds its
//   normalised probabilities (and p * v_scale) to the query's dtype before
//   its value product; the sums l and the accumulators stay in f32.
// - f32 queries (over an f32 or an int8 pool) keep full-f32 products and
//   expf on the CUDA cores (no TF32): the tiles as [key][hd + 4] f32, one at
//   a time (a second in flight would cost a block an SM), a chunk's 16 keys
//   a half-warp each (lane 16 h + j scores key j over the head dim's h-th
//   half of 16-byte pieces, one shuffle adds the halves), 8 or 16 query rows
//   read from shared memory, p handed over through a per-warp [16][16]
//   array, lane j owning output columns j, j + 32, ...
// - The window goes first on the last split: its rows are loaded from k and
//   v in the first round trip (beside the table lookups, and the lookups of
//   the pool rows they go to), quantized for an int8 pool (8 lanes a row),
//   and staged in shared memory as one more chunk, which the last warp
//   attends under the staircase while the prefix tiles are in flight; the
//   other warps meanwhile write the staged rows into the pool (query group
//   0 only, once a (row, kv head)). No block reads a slot another block of
//   the launch writes: the prefix slots lie below pos0 + 1 and the window
//   slots at or above it. Only the shared trash block breaks that
//   separation: parked rows (all-trash tables) and window slots past a
//   row's extent may write and read its slots in one launch, a benign race,
//   since the scheduler discards those outputs (as the fused decode tick's,
//   decode_common.cuh design 5).
// - The merge: each split writes its [16][hd] sums and (l, m) pairs to the
//   workspace, 16-byte stores; the merging block reads every split's pairs
//   and sums in one round trip, four columns a thread.
// - One launch, fixed summation orders, no atomics on sums: two launches
//   give the same bits.
//
// The int8 form (`paged_verify_write_q8`): the pool int8 [2, P, Hk, bt, hd]
//   beside f32 scales [2, P, Hk, bt, 1]; a prefix key's score is multiplied
//   by its K scale after its product and its V row weighted by p * v_scale,
//   as the int8 decode reads do.

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace {

using decode::DMAX;
using decode::NWARPS;
constexpr int NTHREADS = decode::NTHREADS;

constexpr int QMAX = 16;                   // queries a block: the mma's 16 rows
constexpr int KC = 16;                     // keys a warp takes at once (a chunk)
constexpr int WT = KC;                     // window rows staged at once: one chunk
constexpr int TILE_MIN = NWARPS * KC;      // a ring tile gives each warp a chunk
constexpr int TILE_MAX = 256;
constexpr int BUDGET = 64 * 1024;          // shared bytes of the prefix tiles
constexpr int SPLIT_KEYS = 256;            // split length: S = capacity / this at most
constexpr int SMS = 132;                   // an H100 SXM's multiprocessors
constexpr int BPS_MAX = 3;                 // blocks an SM (the registers' cap)

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// the kernels' head-dim class: 32, 64 or 128, the head dim rounded up
inline int dpt_of(int hd) { return hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

// The launch's plan, the same in every block: the split read's (S, gran,
// win, tile, nst as decode::make_plan's), the compute tiles' layout (dp
// data columns, rs elements a row, esz bytes an element) and the byte
// offsets of the dynamic shared memory.
struct VPlan {
  int S, gran, win, tile, nst;
  int dp, rs, esz;
  int qt, ct, raw, sc, wt, wsc, wd, qw, pw, mf, last, rows, wv, bytes;
};

// S splits of a row of `capacity` keys. tc: bf16 compute tiles (the
// tensor-core form), else f32; q8: an int8 pool (a ring of raw int8 tiles
// and one compute tile they are converted into)
inline VPlan plan_for(int S, long long capacity, int gran, int hd, bool tc, bool q8) {
  VPlan V;
  V.S = S;
  V.gran = gran;
  const long long share = ((capacity + S - 1) / S + gran - 1) / gran * gran;
  V.win = static_cast<int>(share < decode::WIN_MAX ? share : decode::WIN_MAX);
  V.esz = tc ? 2 : 4;
  V.dp = tc ? dpt_of(hd) : hd;                  // bf16: mma_common.cuh's [DP + 8] rows
  V.rs = tc ? V.dp + 8 : hd + 4;                // a row: an odd number of 16-byte units
  const int ckey = 2 * V.rs * V.esz;            // a key's K and V compute rows
  const int rkey = 2 * hd + 8;                  // its raw int8 rows and scales
  const int wbuf = NWARPS * KC * ckey;          // int8: each warp's converted chunk
  auto fits = [&](int tile, int nst) {
    return (q8 ? (long long)tile * nst * rkey + wbuf : (long long)tile * nst * ckey) <= BUDGET;
  };
  const int winp = round_up(V.win, KC);
  if (winp <= TILE_MAX && fits(winp, 1)) {      // the window at once
    V.tile = winp;
    V.nst = 1;
  } else {   // a ring of tiles; the CUDA-core form one at a time, for more blocks an SM
    V.nst = tc ? 2 : 1;
    V.tile = winp < 128 ? winp : 128;
    while (V.tile > TILE_MIN && !fits(V.tile, V.nst)) V.tile = round_up(V.tile / 2, KC);
    while (V.nst < decode::NST_MAX && fits(V.tile, V.nst + 1)) ++V.nst;
  }
  const int tiles = q8 ? wbuf : V.nst * V.tile * ckey;
  const int red = NWARPS * QMAX * (hd + 2) * 4;   // the warps' partials, after the tiles
  int o = 0;
  V.qt = o;   o += round_up(QMAX * V.rs * V.esz, 16);           // the queries
  V.ct = o;   o += round_up(tiles > red ? tiles : red, 16);     // compute tiles
  V.raw = o;  o += q8 ? round_up(V.nst * 2 * V.tile * hd, 16) : 0;   // [stage][K, V][tile][hd]
  V.sc = o;   o += q8 ? V.nst * 2 * V.tile * 4 + NWARPS * 2 * KC * 4 : 0;   // and [warp][K, V][KC]
  V.wt = o;   o += 2 * WT * V.rs * V.esz;                       // window [K, V][WT][rs]
  V.wsc = o;  o += 2 * WT * 4;                                  // its scales
  V.wd = o;   o += WT * 8;                                      // its pool rows
  V.qw = o;   o += QMAX * 4;                                    // a query's window position
  V.pw = o;   o += tc ? 0 : NWARPS * QMAX * KC * 4;             // f32 form: a warp's p
  V.mf = o;   o += (NWARPS + 2) * QMAX * 4;                     // the warps' merge factors
  V.last = o; o += 16;                                          // this block merges
  V.rows = o; o += V.win * 4;                                   // the lookup window's rows
  V.wv = o;   o += WT;                                          // a window key is under H
  V.bytes = round_up(o, 16);
  return V;
}

// The plan of a launch over `groups` (row, kv head, query group) triples:
// S = capacity / SPLIT_KEYS (at most SMAX) splits; the tensor-core form
// then takes the most splits up to that which keep the grid within one
// wave of the card at the blocks an SM that the shared memory allows (a
// function of the shapes only): its keys cost little, so a block's fixed
// chain (lookups, copies, merge) sets its time, and a second wave waits
// for the first's whole chains. The CUDA-core form's keys cost more than
// its chain: it keeps every split.
inline VPlan make_vplan(long long capacity, int gran, int hd, bool tc, bool q8, long long groups) {
  const long long s0 = (capacity + SPLIT_KEYS - 1) / SPLIT_KEYS;
  int S = static_cast<int>(s0 < 1 ? 1 : s0 > decode::SMAX ? decode::SMAX : s0);
  VPlan V = plan_for(S, capacity, gran, hd, tc, q8);
  for (;;) {
    if (!tc) return V;
    int bps = decode::SMEM_MAX / V.bytes;
    bps = bps < 1 ? 1 : bps > BPS_MAX ? BPS_MAX : bps;
    if (S == 1 || S * groups <= (long long)SMS * bps) return V;
    V = plan_for(--S, capacity, gran, hd, tc, q8);
  }
}

struct Strides {   // element strides (row, head, window position)
  long long q_b, q_h, q_w, o_b, o_h, o_w, k_b, k_h, k_w, v_b, v_h, v_w;
};

// 2^x on the special function unit (2 ulp; 2^-inf = 0): the tensor-core
// form's softmax runs in base 2 on scores pre-multiplied by log2(e)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// e^x for the CUDA-core form, whose scores are natural; 2^x for the
// tensor-core form, whose scores are in base 2
template <bool kBase2>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (kBase2)
    return exp2_approx(x);
  else
    return expf(x);
}

// ---- 8 int8 codes into a compute tile, exactly; zeros ---------------------

// int8 code i of the 4 in word w as f32, exactly and at full rate: the
// float 2^23 + 128 + x, built from the code's byte (x + 128 = byte ^ 0x80),
// less 2^23 + 128
__device__ __forceinline__ float code_f(uint32_t w, int i) {
  const uint32_t bits = __byte_perm(w ^ 0x80808080u, 0x4B00u, 0x5440u | i);
  return __uint_as_float(bits) - 8388736.f;
}

__device__ __forceinline__ void put8(__nv_bfloat16* d, uint2 u) {
  // |x| <= 127: the float's low 16 bits are zero, so its high half is the
  // bf16 value
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = i < 2 ? u.x : u.y;
    w[i] = __byte_perm(__float_as_uint(code_f(x, 2 * (i & 1))),
                       __float_as_uint(code_f(x, 2 * (i & 1) + 1)), 0x7632u);
  }
  *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void put8(float* d, uint2 u) {
  reinterpret_cast<float4*>(d)[0] =
      make_float4(code_f(u.x, 0), code_f(u.x, 1), code_f(u.x, 2), code_f(u.x, 3));
  reinterpret_cast<float4*>(d)[1] =
      make_float4(code_f(u.y, 0), code_f(u.y, 1), code_f(u.y, 2), code_f(u.y, 3));
}

__device__ __forceinline__ void zero8(__nv_bfloat16* d) {
  *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void zero8(float* d) {
  reinterpret_cast<float4*>(d)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(d)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// cnt rows of a float pool plane (row indices in rows[]) into a compute
// tile [key][rs], 16-byte cp.async copies over the block; rows cnt..rows16
// and columns hd..dp are zero-filled
template <typename E>
__device__ __forceinline__ void copy_tile(E* dst, const E* plane, const uint32_t* rows, int cnt,
                                          int rows16, int hd, int dp, int rs) {
  constexpr int PER = 16 / sizeof(E);
  const int chunks = dp / PER;
  for (int i = threadIdx.x; i < rows16 * chunks; i += NTHREADS) {
    const int kk = i / chunks, c = (i - kk * chunks) * PER;
    const bool in = kk < cnt && c < hd;
    mma::cp_async16(dst + kk * rs + c, in ? plane + (long long)rows[kk] * hd + c : plane,
                    in ? 16 : 0);
  }
}

// ---- a warp's share of the block's attention -------------------------------
// Both forms hold the block's (up to 16) queries against the keys the warp
// is dealt. `chunk` scores the KC keys k0..k0 + 15 of a compute tile (K rows
// kt, V rows vt, row stride rs; an int8 pool's scales ksc, vsc, zero past
// the tile's rows) and folds them into the warp's online softmax; ok(key,
// i) says whether key `key` is visible to the block's query i (false for
// every key at or past `lim`, the tile's rows). `to_red` writes the warp's
// [QMAX][hd + 2] partial (acc, l, m) for the block's merge.

// bf16: mma.sync.m16n8k16, lane l holding query rows l / 4 and l / 4 + 8
template <int DPT>
struct MmaWarp {
  static constexpr int NK = DPT / 16, NN = DPT / 8, RS = DPT + 8;   // the tiles' row stride
  uint32_t qa[NK][4];            // the queries' A fragments, a k16 step each
  float acc[NN][4], m[2], l[2];

  __device__ __forceinline__ void init(const __nv_bfloat16* qt, int, int hd, int, const float*) {
#pragma unroll
    for (int s = 0; s < NK; ++s) {
      if (s * 16 < hd) mma::ldsm_a<RS>(qa[s], qt, 0, s * 16);
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  template <bool kQ8, typename Ok>
  __device__ __forceinline__ void chunk(const __nv_bfloat16* kt, const __nv_bfloat16* vt, int,
                                        const float* ksc, const float* vsc, int k0, int, int hd,
                                        float scale, const Ok& ok) {
    const int lane = threadIdx.x % 32, r = lane / 4, c = lane % 4;
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int st = 0; st < NK; ++st) {
      if (st * 16 < hd) {
        uint32_t b[4];
        mma::ldsm_b_nk<RS>(b, kt, k0, st * 16);
        mma::mma_bf16(s[0], qa[st], b[0], b[1]);
        mma::mma_bf16(s[1], qa[st], b[2], b[3]);
      }
    }
    // s[j][2h + e]: query r + 8h, key k0 + 8j + 2c + e
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * j + 2 * c + (i & 1);
        s[j][i] = !ok(key, r + 8 * (i >> 1)) ? -INFINITY
                  : kQ8 ? s[j][i] * scale * ksc[key] : s[j][i] * scale;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cm = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
      const float mn = fmaxf(m[h], cm);
      const float alpha = mn == -INFINITY ? 1.f : exp2_approx(m[h] - mn);   // m = -inf: 0
      m[h] = mn;
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        acc[n][2 * h] *= alpha;
        acc[n][2 * h + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * h + e];
          const float p = x == -INFINITY ? 0.f : exp2_approx(x - mn);
          l[h] += p;
          s[j][2 * h + e] = p;
        }
      }
    }
    if constexpr (kQ8) {   // p * v_scale (zero past the tile's rows)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] *= vsc[k0 + 8 * j + 2 * c + (i & 1)];
      }
    }
    uint32_t a[4];   // p as the A fragment of the k16 step over the chunk's keys
    a[0] = mma::pack_bf16(s[0][0], s[0][1]);
    a[1] = mma::pack_bf16(s[0][2], s[0][3]);
    a[2] = mma::pack_bf16(s[1][0], s[1][1]);
    a[3] = mma::pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int n = 0; n < NN; n += 2) {
      if (n * 8 < hd) {
        uint32_t b[4];
        mma::ldsm_b_kn<RS>(b, vt, k0, n * 8);
        mma::mma_bf16(acc[n], a, b[0], b[1]);
        if ((n + 1) * 8 < hd) mma::mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void to_red(float* red, int hd, int) {
    const int lane = threadIdx.x % 32, r = lane / 4, c = lane % 4, pw = hd + 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      if (n * 8 < hd) {
#pragma unroll
        for (int i = 0; i < 4; ++i) red[(r + 8 * (i >> 1)) * pw + 8 * n + 2 * c + (i & 1)] = acc[n][i];
      }
    }
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        red[(r + 8 * h) * pw + hd] = l[h];
        red[(r + 8 * h) * pw + hd + 1] = m[h];
      }
    }
  }
};

// f32: CUDA cores, full-f32 products; lane 16 h + j scores key j of a chunk
// over the head dim's h-th half; lane j owns output columns j, j + 32, ...
// NQ (8 or 16) query rows are computed, those past the block's zero.
template <int DPT, int NQ>
struct SimtWarp {
  static constexpr int NC = DPT / 32;
  float acc[NQ][NC], m[NQ], l[NQ];
  const float* qt;   // the queries [QMAX][rs]
  float* pw;         // the warp's p [QMAX][KC]
  int qn;

  __device__ __forceinline__ void init(const float* qt_, int, int, int qn_, float* pw_) {
    qt = qt_;
    pw = pw_;
    qn = qn_;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[q][i] = 0.f;
      m[q] = -INFINITY;
      l[q] = 0.f;
    }
  }

  template <bool kQ8, typename Ok>
  __device__ __forceinline__ void chunk(const float* kt, const float* vt, int rs, const float* ksc,
                                        const float* vsc, int k0, int lim, int hd, float scale,
                                        const Ok& ok) {
    const int lane = threadIdx.x % 32, kk = lane % KC, hh = lane / KC;
    const int key = k0 + kk;
    float s[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) s[q] = 0.f;
    const float* kr = kt + key * rs;
#pragma unroll 2
    for (int jj = 0; jj < DPT / 8; ++jj) {   // 16-byte chunk 2 jj + hh of the head dim
      if (jj < hd / 8) {
        const int c = 4 * (2 * jj + hh);
        const float4 kx = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 qx = *reinterpret_cast<const float4*>(qt + q * rs + c);
          s[q] = fmaf(kx.x, qx.x, s[q]);
          s[q] = fmaf(kx.y, qx.y, s[q]);
          s[q] = fmaf(kx.z, qx.z, s[q]);
          s[q] = fmaf(kx.w, qx.w, s[q]);
        }
      }
    }
    const bool kin = key < lim;
    const float ks = kQ8 && kin ? ksc[key] : 1.f;
    const float vs = kQ8 && kin ? vsc[key] : 1.f;
    float cm[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      s[q] += __shfl_xor_sync(0xffffffffu, s[q], KC);
      s[q] = !(kin && ok(key, q)) ? -INFINITY : kQ8 ? s[q] * scale * ks : s[q] * scale;
      cm[q] = s[q];
    }
#pragma unroll
    for (int o = KC / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) cm[q] = fmaxf(cm[q], __shfl_xor_sync(0xffffffffu, cm[q], o));
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float mn = fmaxf(m[q], cm[q]);
      const float alpha = mn == -INFINITY ? 1.f : expf(m[q] - mn);
      m[q] = mn;
      l[q] *= alpha;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[q][i] *= alpha;
      const float p = s[q] == -INFINITY ? 0.f : expf(s[q] - mn);
      l[q] += hh == 0 ? p : 0.f;   // each key once
      if (hh == 0) pw[q * KC + kk] = kQ8 ? p * vs : p;   // p * v_scale
    }
    __syncwarp();
    // the chunk's 16 rows (zero past the tile's), four keys a step
#pragma unroll 1
    for (int j4 = 0; j4 < KC / 4; ++j4) {
      float vx[4][NC];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = vt + (k0 + 4 * j4 + e) * rs;
#pragma unroll
        for (int i = 0; i < NC; ++i) vx[e][i] = lane + 32 * i < hd ? vr[lane + 32 * i] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(pw + q * KC + 4 * j4);
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          acc[q][i] = fmaf(p.x, vx[0][i], acc[q][i]);
          acc[q][i] = fmaf(p.y, vx[1][i], acc[q][i]);
          acc[q][i] = fmaf(p.z, vx[2][i], acc[q][i]);
          acc[q][i] = fmaf(p.w, vx[3][i], acc[q][i]);
        }
      }
    }
    __syncwarp();   // pw is free for the next chunk
  }

  __device__ __forceinline__ void to_red(float* red, int hd, int) {
    const int lane = threadIdx.x % 32, pw_ = hd + 2;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float L = decode::warp_sum(l[q]);
      if (q < qn) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          if (lane + 32 * i < hd) red[q * pw_ + lane + 32 * i] = acc[q][i];
        }
        if (lane == 0) {
          red[q * pw_ + hd] = L;
          red[q * pw_ + hd + 1] = m[q];
        }
      }
    }
  }
};

// T: query, window, output and compute-tile type (bf16: the tensor-core
// form; f32: the CUDA-core form); C: pool element type (T, or int8_t with
// the f32 scale planes kscale/vscale). DPT: 32, 64 or 128, the head dim
// rounded up. NQ: the f32 form's query rows (8 or 16; 16 for bf16). Grid
// (query group * S + split, kv head, row), NTHREADS
// threads, V.bytes of dynamic shared memory. The pool pointers are not
// __restrict__: the window's rows are written through them.
template <typename T, typename C, int DPT, int NQ>
__global__ void __launch_bounds__(NTHREADS, 3)
paged_verify_write_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          C* kpool, C* vpool, float* kscale, float* vscale, T* __restrict__ out,
                          float* __restrict__ ws, int* __restrict__ tickets,
                          const int* __restrict__ tables, const int* __restrict__ positions,
                          int G, int W, int nqg, int Hk, int P, int bt, int hd, int nb,
                          const Strides st, float scale, const VPlan V) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  using Warp = typename std::conditional<kTC, MmaWarp<DPT>, SimtWarp<DPT, NQ>>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = V.S;
  const int split = blockIdx.x % S, qg = blockIdx.x / S;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rs = V.rs, tile = V.tile, nst = V.nst;
  const int H = nb * bt;
  const int* trow = tables + (long long)b * nb;
  const int pos0 = positions[(long long)b * W] - 1;
  const int n_prefix = pos0 < 0 ? 0 : min(pos0 + 1, H);
  const int nq = G * W, q0 = qg * QMAX, qn = min(QMAX, nq - q0);   // this block's queries
  const int per = ((n_prefix + S - 1) / S + V.gran - 1) / V.gran * V.gran;
  const int lo = min(split * per, n_prefix), hi = min(lo + per, n_prefix);
  const bool last_split = split == S - 1;
  const float sscale = kTC ? scale * 1.4426950408889634f : scale;   // base 2: times log2(e)

  T* qt = reinterpret_cast<T*>(smem + V.qt);
  T* ct = reinterpret_cast<T*>(smem + V.ct);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + V.raw);
  float* scl = reinterpret_cast<float*>(smem + V.sc);
  T* wt = reinterpret_cast<T*>(smem + V.wt);
  float* wsc = reinterpret_cast<float*>(smem + V.wsc);
  long long* wd_s = reinterpret_cast<long long*>(smem + V.wd);
  int* qw_s = reinterpret_cast<int*>(smem + V.qw);
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(smem + V.rows);
  uint8_t* wv_s = smem + V.wv;

  // ---- the first round trip: queries, lookups, the window's rows ----------
  {  // every load issued before the first store
    constexpr int QE = QMAX * DPT / NTHREADS;   // elements a thread at most
    float x[QE];
#pragma unroll
    for (int j = 0; j < QE; ++j) {
      const int i = threadIdx.x + j * NTHREADS, qi = i / V.dp, c = i - qi * V.dp;
      x[j] = 0.f;
      if (qi < qn && c < hd) {
        const int gi = q0 + qi, g = gi / W, w = gi - g * W;
        x[j] = decode::to_f(q[b * st.q_b + (hk * G + g) * st.q_h + w * st.q_w + c]);
      }
    }
#pragma unroll
    for (int j = 0; j < QE; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      if (i < QMAX * V.dp) decode::store(qt + i / V.dp * rs + i % V.dp, x[j]);
    }
  }
  if (const int t = threadIdx.x; t < QMAX) qw_s[t] = t < qn ? (q0 + t) % W : -1;

  auto lookup = [&](int w0, int wn) {
    for (int i = threadIdx.x; i < wn; i += NTHREADS) {
      const int key = w0 + i;
      const int blk = min(max(trow[key / bt], 0), P - 1);
      rows_s[i] = static_cast<uint32_t>(((long long)blk * Hk + hk) * bt + key % bt);
    }
  };

  // window rows w0 .. w0 + WT - 1 into the window tile (zero past W), a
  // group of 8 lanes a (row, plane), 16 at once; for query group 0, the
  // pool row each goes to (-1: dropped) beside them
  auto stage_window = [&](int w0) {
    const int wn = min(WT, W - w0);
    if (threadIdx.x < WT) {
      const int r = threadIdx.x, slot = pos0 + 1 + w0 + r;
      long long dest = -1;
      if (qg == 0 && r < wn && slot < H) {
        const int blk = trow[slot / bt];
        if (blk >= 0 && blk < P) dest = ((long long)blk * Hk + hk) * bt + slot % bt;
      }
      wd_s[r] = dest;
      wv_s[r] = r < wn && slot < H;
    }
    const int li = lane % 8;
#pragma unroll 1
    for (int t0 = 0; t0 < 2 * wn; t0 += NTHREADS / 8) {   // the rows under W
      const int task = t0 + threadIdx.x / 8, r = task / 2, plane = task % 2, w = w0 + r;
      const bool real = r < wn;   // the same in the lanes of a group
      const T* src = plane == 0 ? k + b * st.k_b + hk * st.k_h + w * st.k_w
                                : v + b * st.v_b + hk * st.v_h + w * st.v_w;
      float x[DMAX / 8];
#pragma unroll
      for (int i = 0; i < DMAX / 8; ++i) {
        const int c = li + 8 * i;
        x[i] = real && c < hd ? decode::to_f(src[c]) : 0.f;
      }
      T* row = wt + (plane * WT + r) * rs;
      if constexpr (kQ8) {   // quantize_values's scale and codes, over the group
        const float sc = q8::group_scale<DMAX / 8>(x, 8);
        if (real) {
#pragma unroll
          for (int i = 0; i < DMAX / 8; ++i) {
            const int c = li + 8 * i;
            if (c < hd) decode::store(row + c, static_cast<float>(q8::quantize_value(x[i], sc)));
          }
          if (li == 0) wsc[plane * WT + r] = sc;
        }
      } else if (real) {
#pragma unroll
        for (int i = 0; i < DMAX / 8; ++i) {
          if (li + 8 * i < hd) decode::store(row + li + 8 * i, x[i]);
        }
      }
      if (real) {
        for (int c = hd + li; c < V.dp; c += 8) decode::store(row + c, 0.f);
      }
    }
    for (int i = threadIdx.x; i < 2 * (WT - wn) * V.dp; i += NTHREADS) {   // zero rows past W
      const int rp = i / V.dp, c = i - rp * V.dp, r = wn + rp / 2, plane = rp % 2;
      decode::store(wt + (plane * WT + r) * rs + c, 0.f);
      if (c == 0) wsc[plane * WT + r] = 0.f;
    }
  };

  // the staged window rows w0.. into the pool (query group 0), from shared
  // memory, by threads t0 .. t0 + nt - 1: stores only
  auto write_window = [&](int w0, int t0, int nt) {
    const int wn = min(WT, W - w0), i0 = static_cast<int>(threadIdx.x) - t0;
    if (qg != 0 || i0 < 0 || i0 >= nt) return;
    for (int i = i0; i < 2 * wn * hd; i += nt) {
      const int rp = i / hd, c = i - rp * hd, r = rp / 2, plane = rp % 2;
      const long long dest = wd_s[r];
      if (dest < 0) continue;
      const T x = wt[(plane * WT + r) * rs + c];
      if constexpr (kQ8) {
        (plane == 0 ? kpool : vpool)[dest * hd + c] = static_cast<int8_t>(decode::to_f(x));
        if (c == 0) (plane == 0 ? kscale : vscale)[dest] = wsc[plane * WT + r];
      } else {
        (plane == 0 ? kpool : vpool)[dest * hd + c] = x;
      }
    }
  };

  if (lo < hi) lookup(lo, min(V.win, hi - lo));
  if (last_split) stage_window(0);
  __syncthreads();

  Warp wp;
  wp.init(qt, rs, hd, qn, reinterpret_cast<float*>(smem + V.pw) + warp * QMAX * KC);

  // the window's rows w0.. as one chunk, under the staircase
  auto window_chunk = [&](int w0) {
    const int wn = min(WT, W - w0);
    const auto ok = [&](int key, int i) {
      return key < wn && wv_s[key] != 0 && w0 + key <= qw_s[i];
    };
    wp.template chunk<kQ8>(wt, wt + WT * rs, rs, wsc, wsc + WT, 0, wn, hd, sscale, ok);
  };
  constexpr int WINDOW_WARP = NWARPS - 1;   // the warp dealt the fewest prefix chunks
  // the first window rows: attended by the window warp, written into the
  // pool by the others
  auto window_first = [&]() {
    if (warp == WINDOW_WARP)
      window_chunk(0);
    else
      write_window(0, 0, WINDOW_WARP * 32);
  };

  // ---- the prefix: this split's share of slots 0 .. n_prefix - 1 ----------
  bool window_done = !last_split;
  for (int w0 = lo; w0 < hi; w0 += V.win) {
    const int wn = min(V.win, hi - w0), nt = (wn + tile - 1) / tile;
    if (w0 != lo) {
      __syncthreads();   // the previous window's tiles and lookups are done
      lookup(w0, wn);
      __syncthreads();
    }
    // tile t's K and V rows (and scales) into stage t % nst: one commit group
    auto issue = [&](int t) {
      const int s_ = t % nst, k0 = t * tile, cnt = min(tile, wn - k0);
      if constexpr (kQ8) {
        int8_t* rk = raw + 2 * s_ * tile * hd;
        decode::copy_rows(reinterpret_cast<unsigned char*>(rk), kpool, rows_s + k0, cnt, hd);
        decode::copy_rows(reinterpret_cast<unsigned char*>(rk + tile * hd), vpool, rows_s + k0,
                          cnt, hd);
        decode::copy_scales(scl + 2 * s_ * tile, kscale, rows_s + k0, cnt);
        decode::copy_scales(scl + (2 * s_ + 1) * tile, vscale, rows_s + k0, cnt);
      } else {
        T* kt = ct + 2 * s_ * tile * rs;
        const int rows16 = round_up(cnt, KC);
        copy_tile(kt, reinterpret_cast<const T*>(kpool), rows_s + k0, cnt, rows16, hd, V.dp, rs);
        copy_tile(kt + tile * rs, reinterpret_cast<const T*>(vpool), rows_s + k0, cnt, rows16, hd,
                  V.dp, rs);
      }
      decode::cp_commit();
    };
    for (int t = 0; t < nst && t < nt; ++t) issue(t);
    if (!window_done) {   // while the first tiles are in flight
      window_first();
      window_done = true;
    }
    for (int t = 0; t < nt; ++t) {
      const int s_ = t % nst, cnt = min(tile, wn - t * tile);
      decode::cp_wait_n(min(nst, nt - t) - 1);   // tile t has arrived
      __syncthreads();
      if constexpr (kQ8) {
        // each warp converts its chunks' int8 rows (and scales, zero past
        // the tile's keys) into its own bf16 / f32 rows, exactly, and
        // attends them
        constexpr int CH = DPT / 8;   // 8-column pieces of a row at most
        const int8_t* rk = raw + 2 * s_ * tile * hd;
        const float* rsc = scl + 2 * s_ * tile;
        T* wk = ct + warp * 2 * KC * rs;
        float* wks = scl + nst * 2 * tile + warp * 2 * KC;
        for (int ch = warp; ch * KC < cnt; ch += NWARPS) {
          const int k0 = ch * KC, lim = min(KC, cnt - k0);
#pragma unroll
          for (int j = 0; j < 2 * KC * CH / 32; ++j) {
            const int i = lane + 32 * j, pl = i / (KC * CH), kk = i / CH % KC, c = i % CH * 8;
            T* d = wk + (pl * KC + kk) * rs + c;
            if (kk < lim && c < hd)
              put8(d, *reinterpret_cast<const uint2*>(rk + (pl * tile + k0 + kk) * hd + c));
            else if (c < V.dp)
              zero8(d);
          }
          {
            const int pl = lane / KC, kk = lane % KC;
            wks[lane] = kk < lim ? rsc[pl * tile + k0 + kk] : 0.f;
          }
          __syncwarp();
          const auto ok = [&](int key, int) { return key < lim; };
          wp.template chunk<kQ8>(wk, wk + KC * rs, rs, wks, wks + KC, 0, lim, hd, sscale, ok);
          __syncwarp();   // this warp's rows are free for its next chunk
        }
      } else {
        const T* kt = ct + 2 * s_ * tile * rs;
        const auto ok = [&](int key, int) { return key < cnt; };
        for (int ch = warp; ch * KC < cnt; ch += NWARPS)
          wp.template chunk<kQ8>(kt, kt + tile * rs, rs, nullptr, nullptr, ch * KC, cnt, hd,
                                 sscale, ok);
      }
      __syncthreads();   // this stage is free for tile t + nst
      if (t + nst < nt) issue(t + nst);
    }
  }
  if (!window_done) window_first();   // no prefix keys
  if (last_split) {   // windows longer than WT: the rest, a chunk at a time
    for (int w0 = WT; w0 < W; w0 += WT) {
      __syncthreads();   // the previous window rows are no longer read
      stage_window(w0);
      __syncthreads();
      write_window(w0, 0, NTHREADS);
      if (warp == (WINDOW_WARP + w0 / WT) % NWARPS) window_chunk(w0);
    }
  }

  // ---- the block's partial: the warps' partials merged in warp order -------
  // A split's partial in the workspace: [QMAX][hd] sums, then [QMAX] (l, m).
  const int pw = hd + 2, h4 = hd / 4;
  float* red = reinterpret_cast<float*>(smem + V.ct);   // [NWARPS][QMAX][pw]
  float* mf = reinterpret_cast<float*>(smem + V.mf);    // [NWARPS][QMAX] factors; L, M
  const long long pair = ((long long)b * Hk + hk) * nqg + qg;
  float* mine = ws + (pair * S + split) * QMAX * pw;
  __syncthreads();         // every warp is done with the tiles, which red overlays
  wp.to_red(red + warp * QMAX * pw, hd, qn);
  __syncthreads();
  if (const int ql = threadIdx.x; ql < qn) {   // a query's factors, once
    float M = -INFINITY, L = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, red[(w * QMAX + ql) * pw + hd + 1]);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* x = red + (w * QMAX + ql) * pw;
      const float f = x[hd + 1] == -INFINITY ? 0.f : softmax_exp<kTC>(x[hd + 1] - M);
      mf[w * QMAX + ql] = f;
      L += x[hd] * f;
    }
    mf[NWARPS * QMAX + ql] = L;
    if (S > 1) *reinterpret_cast<float2*>(mine + QMAX * hd + 2 * ql) = make_float2(L, M);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qn * h4; i += NTHREADS) {   // four columns a thread
    const int ql = i / h4, c = (i - ql * h4) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = mf[w * QMAX + ql];
      const float* x = red + (w * QMAX + ql) * pw + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = fmaf(x[e], f, o[e]);
    }
    if (S == 1) {   // the one split's partial is the output
      const int qi = q0 + ql, g = qi / W, w = qi % W;
      const float L = fmaxf(mf[NWARPS * QMAX + ql], 1e-30f);
      T* op = out + b * st.o_b + (hk * G + g) * st.o_h + w * st.o_w + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) decode::store(op + e, o[e] / L);
    } else {
      *reinterpret_cast<float4*>(mine + ql * hd + c) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  if (S == 1) return;
  // the last of the splits to take a ticket merges them in split order (an
  // empty split weighs 0), writes the output and resets the ticket
  int* last = reinterpret_cast<int*>(smem + V.last);
  __threadfence();   // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(tickets + pair, 1) == S - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // a thread's four columns of a query: every split's (l, m) and the first
  // XS splits' sums in one round trip, the factors from them
  constexpr int XS = 4;
  const float* pt = ws + pair * S * QMAX * pw;
  for (int i = threadIdx.x; i < qn * h4; i += NTHREADS) {
    const int ql = i / h4, c = (i - ql * h4) * 4;
    const auto sums = [&](int s) {
      return __ldcg(reinterpret_cast<const float4*>(pt + s * QMAX * pw + ql * hd + c));
    };
    float2 lm[decode::SMAX];
    float4 x[XS];
#pragma unroll
    for (int s = 0; s < decode::SMAX; ++s) {
      if (s < S) lm[s] = __ldcg(reinterpret_cast<const float2*>(pt + s * QMAX * pw + QMAX * hd) + ql);
      if (s < XS && s < S) x[s] = sums(s);
    }
    float M = -INFINITY, L = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < decode::SMAX; ++s) {
      if (s < S) M = fmaxf(M, lm[s].y);
    }
#pragma unroll
    for (int s = 0; s < decode::SMAX; ++s) {
      if (s < S) {
        const float f = lm[s].y == -INFINITY ? 0.f : softmax_exp<kTC>(lm[s].y - M);
        const float4 xs = s < XS ? x[s < XS ? s : 0] : sums(s);
        L += lm[s].x * f;
        o[0] = fmaf(xs.x, f, o[0]);
        o[1] = fmaf(xs.y, f, o[1]);
        o[2] = fmaf(xs.z, f, o[2]);
        o[3] = fmaf(xs.w, f, o[3]);
      }
    }
    const int qi = q0 + ql, g = qi / W, w = qi % W;
    T* op = out + b * st.o_b + (hk * G + g) * st.o_h + w * st.o_w + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) decode::store(op + e, o[e] / fmaxf(L, 1e-30f));
  }
  if (threadIdx.x == 0) tickets[pair] = 0;   // ready for the next launch on this stream
}

template <typename T, typename C, int DPT, int NQ>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* pool, float* pool_scale,
                     void* out, float* ws, int* tickets, const int* tables,
                     const int* positions, int B, int Hq, int G, int W, int P, int bt, int hd,
                     int nb, const Strides& st, float scale, cudaStream_t stream) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  const int Hk = Hq / G;
  const int nqg = (G * W + QMAX - 1) / QMAX;
  const VPlan V = make_vplan((long long)nb * bt, bt, hd, std::is_same<T, __nv_bfloat16>::value, kQ8,
                             (long long)B * Hk * nqg);
  if (V.bytes > decode::SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = paged_verify_write_kernel<T, C, DPT, NQ>;
  const cudaError_t e = decode::allow_smem(reinterpret_cast<const void*>(kernel), V.bytes);
  if (e != cudaSuccess) return e;
  const long long plane = (long long)P * Hk * bt;   // rows in one K/V plane
  C* kpool = static_cast<C*>(pool);
  float* vscale = pool_scale == nullptr ? nullptr : pool_scale + plane;
  kernel<<<dim3(V.S * nqg, Hk, B), NTHREADS, V.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kpool,
      kpool + plane * hd, pool_scale, vscale, static_cast<T*>(out), ws, tickets, tables,
      positions, G, W, nqg, Hk, P, bt, hd, nb, st, scale, V);
  return cudaGetLastError();
}

template <typename T, typename C, int NQ>
cudaError_t launch_q(const void* q, const void* k, const void* v, void* pool, float* ps, void* out,
                     float* ws, int* tickets, const int* tables, const int* positions, int B,
                     int Hq, int G, int W, int P, int bt, int hd, int nb, const Strides& st,
                     float scale, cudaStream_t s) {
  switch (dpt_of(hd)) {
    case 32: return launch_d<T, C, 32, NQ>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
    case 64: return launch_d<T, C, 64, NQ>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
    default: return launch_d<T, C, 128, NQ>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
  }
}

// the tensor-core form takes 16 query rows; the CUDA-core form 8 where a
// block's queries fit
template <typename T, typename C>
cudaError_t launch(const void* q, const void* k, const void* v, void* pool, float* ps, void* out,
                   float* ws, int* tickets, const int* tables, const int* positions, int B,
                   int Hq, int G, int W, int P, int bt, int hd, int nb, const Strides& st,
                   float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (G * W <= 8)
      return launch_q<T, C, 8>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
  }
  return launch_q<T, C, QMAX>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
}

bool bad_shape(int B, int Hq, int G, int W, int P, int bt, int hd, int nb) {
  // grid y and z hold the kv heads and rows; x the splits times the query
  // groups; pool row indices are 32-bit
  if (B < 1 || B > 65535 || Hq < 1 || G < 1 || Hq % G || Hq / G > 65535 || W < 1 || P < 1 ||
      bt < 1 || nb < 1 || hd < 8 || hd > DMAX || hd % 8 ||
      (long long)P * (Hq / G) * bt > 0xffffffffLL)
    return true;
  const long long nqg = ((long long)G * W + QMAX - 1) / QMAX;
  return nqg * decode::SMAX > 0x7fffffffLL;
}

int dispatch(const void* q, const void* k, const void* v, void* pool, float* pool_scale,
             void* out, float* ws, int* tickets, const int* tables, const int* positions,
             int dtype, int B, int Hq, int G, int W, int P, int bt, int hd, int nb,
             const long long* s, float scale, void* stream) {
  if (bad_shape(B, Hq, G, W, P, bt, hd, nb) || q == nullptr || k == nullptr || v == nullptr ||
      ws == nullptr || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const bool q8 = pool_scale != nullptr;
  cudaError_t e;
  if (dtype == 0 && !q8)
    e = launch<float, float>(q, k, v, pool, nullptr, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, cs);
  else if (dtype == 1 && !q8)
    e = launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pool, nullptr, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, cs);
  else if (dtype == 0)
    e = launch<float, int8_t>(q, k, v, pool, pool_scale, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, cs);
  else if (dtype == 1)
    e = launch<__nv_bfloat16, int8_t>(q, k, v, pool, pool_scale, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, cs);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// q: [B, Hq, W, hd], k, v: [B, Hq / G, W, hd], out: [B, Hq, W, hd], each of
// the query's dtype (0 f32, 1 bf16) with unit stride on hd and element
// strides = (q b, q h, q w, o b, o h, o w, k b, k h, k w, v b, v h, v w).
// pool: [2, P, Hq / G, bt, hd] of that dtype, contiguous, 16-byte aligned,
// written in place. tables: int32 [B, nb] contiguous. positions: int32 [B,
// W] contiguous, consecutive per row. hd % 8 == 0, hd <= 128; any G and W.
// ws, tickets: the merge's scratch, private to the stream, for B * (Hq / G)
// * ceil(G * W / 16) (row, kv head, query group) triples of 16 queries (see
// decode_common.cuh). Returns the cudaError_t of the launch.
int paged_verify_write(const void* q, const void* k, const void* v, void* pool, void* out,
                       float* ws, int* tickets, const int* tables, const int* positions,
                       int dtype, int B, int Hq, int G, int W, int P, int bt, int hd, int nb,
                       const long long* strides, float scale, void* stream) {
  return dispatch(q, k, v, pool, nullptr, out, ws, tickets, tables, positions, dtype, B, Hq, G,
                  W, P, bt, hd, nb, strides, scale, stream);
}

// The int8 pool: int8 [2, P, Hq / G, bt, hd] and its f32 scales [2, P,
// Hq / G, bt, 1], both contiguous and written in place; q, k, v and out as
// above.
int paged_verify_write_q8(const void* q, const void* k, const void* v, void* pool,
                          float* pool_scale, void* out, float* ws, int* tickets,
                          const int* tables, const int* positions, int dtype, int B, int Hq,
                          int G, int W, int P, int bt, int hd, int nb, const long long* strides,
                          float scale, void* stream) {
  if (pool_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, pool, pool_scale, out, ws, tickets, tables, positions, dtype, B, Hq,
                  G, W, P, bt, hd, nb, strides, scale, stream);
}

// The plan a launch over B rows of Hk kv heads takes at these shapes:
// out[0..8] = splits S a (row, kv
// head, query group), split length, prefix tile keys, tiles in flight,
// shared bytes, query groups, QMAX (the queries a group; the merge scratch
// holds QMAX partials a split of each group), the keys a warp takes at once,
// and 1 for the tensor-core form (bf16), 0 for the CUDA-core form (f32).
void paged_verify_plan(int nb, int bt, int hd, int dtype, int q8, int G, int W, int B, int Hk,
                       int* out) {
  const VPlan V = make_vplan((long long)nb * bt, bt, hd, dtype == 1, q8 != 0,
                             (long long)B * Hk * ((G * W + QMAX - 1) / QMAX));
  const int vals[9] = {V.S, SPLIT_KEYS, V.tile, V.nst, V.bytes,
                       (G * W + QMAX - 1) / QMAX, QMAX, KC, dtype == 1};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
}

const char* paged_verify_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

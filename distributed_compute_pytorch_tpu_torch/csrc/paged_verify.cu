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
//      (q8::quantize_values, quantize_common.cuh);
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
//   far under the card's ~295 FLOP/byte balance point.
//
// Design (right first, then simple; no tensor cores, no TMA):
// - The split plan of decode_common.cuh (`make_plan`): the prefix's live
//   keys split over S = capacity / 256 blocks (at most 16), whole table
//   blocks each, looked up in one round trip a window of up to 1024 keys and
//   staged in shared memory by cp.async, a ring of tiles in flight; the last
//   split of a (row, kv head, query group) to take its ticket merges the
//   partial softmax sums in split order, in the same launch.
// - Queries: a block takes up to QMAX = 16 of the G x W queries (query i is
//   head g = i / W, window position w = i % W: the reference's folded order).
//   A larger G x W adds query groups to the grid's x (x = group * S +
//   split), each re-reading the keys. Each warp owns QPW (1, 2 or 4) queries
//   and walks every staged key: a group of KL lanes scores one key (lane i
//   its columns 8i..8i+7), the warp KPC keys a group at a time, with an
//   online softmax in f32 kept per warp (no block-wide exchange).
// - The window is attended from the fresh k and v, not from the pool: the
//   last split of each (row, kv head, query group) stages the window's rows
//   in shared memory (quantized there for an int8 pool) and attends them
//   under the staircase after its prefix share. So no block reads a slot
//   another block of the launch writes: the prefix slots lie below pos0 + 1
//   and the window slots at or above it. The last split of query group 0
//   also writes the window's rows into the pool, once a (row, kv head).
//   Only the shared trash block breaks that separation: parked rows
//   (all-trash tables) and window slots past a row's extent may write and
//   read its slots in one launch, a benign race, since the scheduler
//   discards those outputs (as the fused decode tick's, decode_common.cuh
//   design 5).
// - One launch, fixed summation orders: two launches give the same bits.
//
// The int8 form (`paged_verify_write_q8`): the pool int8 [2, P, Hk, bt, hd]
//   beside f32 scales [2, P, Hk, bt, 1]; a prefix key's score is multiplied
//   by its K scale after its product and its V row weighted by p * v_scale,
//   as the int8 decode reads do.

#include "decode_common.cuh"

namespace {

using decode::DMAX;
using decode::NTHREADS;
using decode::NWARPS;

constexpr int QMAX = 16;   // queries a block
constexpr int WT = 16;     // window rows staged at once
constexpr int KPC = 4;     // keys a lane group scores in one chunk

// The launch's plan: the split read's (decode::make_plan, whose dynamic
// shared memory holds the prefix tiles and lookups) and, past it, the
// staged window rows (K and V, WT rows each), their scales and their
// validity bytes.
struct VPlan {
  decode::Plan p;
  int wkv, wsc, wv, bytes;
};

inline VPlan make_vplan(long long capacity, int bt, int hd, int esz, bool q8) {
  VPlan V;
  V.p = decode::make_plan(capacity, bt, hd, esz, q8, 1);
  int o = V.p.bytes;
  V.wkv = o; o += (2 * WT * V.p.rb + 15) & ~15;   // [K, V][WT][rb]
  V.wsc = o; o += 2 * WT * 4;                     // [K, V][WT] f32
  V.wv = o;  o += WT;                             // a window key's slot is under H
  V.bytes = (o + 15) & ~15;
  return V;
}

// queries a warp owns, from the most queries a block holds
inline int queries_per_warp(int nq) {
  const int q = nq < QMAX ? nq : QMAX;
  return q <= NWARPS ? 1 : q <= 2 * NWARPS ? 2 : 4;
}

struct Strides {   // element strides (row, head, window position)
  long long q_b, q_h, q_w, o_b, o_h, o_w, k_b, k_h, k_w, v_b, v_h, v_w;
};

// One staged tile of cnt keys (K rows kt, V rows vt in shared memory, the
// int8 form's scales ksc, vsc) visited by one warp for its QPW queries:
// ok(k, j) says whether key k is visible to the warp's query j. Updates
// the lane's share of each query's online softmax (m the same in every
// lane of the warp; acc and l the lane's keys' share).
template <typename C, int QPW, int KL, typename Ok>
__device__ __forceinline__ void visit(const C* kt, const C* vt, const float* ksc,
                                      const float* vsc, int cnt, int hd_c, float scale,
                                      const float (&qr)[QPW][8], float (&acc)[QPW][8],
                                      float (&l)[QPW], float (&m)[QPW], const Ok& ok, int grp,
                                      int li, bool has_col) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  constexpr int GPW = 32 / KL;
  for (int c0 = 0; c0 < cnt; c0 += GPW * KPC) {
    float s[KPC][QPW];
#pragma unroll
    for (int j = 0; j < KPC; ++j) {
      const int k = c0 + j * GPW + grp;
      float d[QPW];
#pragma unroll
      for (int q = 0; q < QPW; ++q) d[q] = 0.f;
      if (has_col && k < cnt) {
        float x[8];
        decode::load8(kt + k * hd_c + li * 8, x);
#pragma unroll
        for (int q = 0; q < QPW; ++q) {
#pragma unroll
          for (int i = 0; i < 8; ++i) d[q] = fmaf(qr[q][i], x[i], d[q]);
        }
      }
      const float ks = kQ8 && k < cnt ? ksc[k] : 1.f;
#pragma unroll
      for (int q = 0; q < QPW; ++q) {
#pragma unroll
        for (int o = KL / 2; o > 0; o >>= 1) d[q] += __shfl_xor_sync(0xffffffffu, d[q], o);
        s[j][q] = k < cnt && ok(k, q) ? (kQ8 ? d[q] * scale * ks : d[q] * scale) : -INFINITY;
      }
    }
#pragma unroll
    for (int q = 0; q < QPW; ++q) {
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPC; ++j) cm = fmaxf(cm, s[j][q]);
#pragma unroll
      for (int o = KL; o < 32; o <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
      if (cm == -INFINITY) {   // the same in every lane: nothing visible in this chunk
#pragma unroll
        for (int j = 0; j < KPC; ++j) s[j][q] = 0.f;
        continue;
      }
      const float m_new = fmaxf(m[q], cm);
      const float alpha = expf(m[q] - m_new);   // m[q] = -inf: 0, and acc, l are 0
      m[q] = m_new;
      l[q] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[q][i] *= alpha;
#pragma unroll
      for (int j = 0; j < KPC; ++j) {
        const float p = s[j][q] == -INFINITY ? 0.f : expf(s[j][q] - m_new);
        s[j][q] = p;
        l[q] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < KPC; ++j) {
      const int k = c0 + j * GPW + grp;
      if (has_col && k < cnt) {
        float x[8];
        decode::load8(vt + k * hd_c + li * 8, x);
        const float vs = kQ8 ? vsc[k] : 1.f;
#pragma unroll
        for (int q = 0; q < QPW; ++q) {
          const float wv = kQ8 ? s[j][q] * vs : s[j][q];   // p * v_scale
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[q][i] = fmaf(wv, x[i], acc[q][i]);
        }
      }
    }
  }
}

// T: query, window and output type; C: pool element type (T, or int8_t
// with the f32 scale planes kscale/vscale). QPW: queries a warp. KL: lanes
// a key takes. Grid (query group * S + split, kv head, row), NTHREADS
// threads, V.bytes of dynamic shared memory. The pool pointers are not
// __restrict__: the window's rows are written through them.
template <typename T, typename C, int QPW, int KL>
__global__ void __launch_bounds__(NTHREADS)
paged_verify_write_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    C* kpool, C* vpool, float* kscale, float* vscale, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ tickets,
                    const int* __restrict__ tables, const int* __restrict__ positions, int G,
                    int W, int nqg, int Hk, int P, int bt, int hd, int nb, const Strides st,
                    float scale, const VPlan V) {
  constexpr bool kQ8 = std::is_same<C, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const decode::Plan P_ = V.p;
  const int S = P_.S;
  const int split = blockIdx.x % S, qg = blockIdx.x / S;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / KL, li = lane % KL;
  const bool has_col = li < hd / 8;
  const int rb = P_.rb, hd_c = rb / static_cast<int>(sizeof(C));
  const int H = nb * bt;
  const int* trow = tables + (long long)b * nb;
  const int pos0 = positions[(long long)b * W] - 1;
  const int n_prefix = pos0 < 0 ? 0 : min(pos0 + 1, H);
  const int nq = G * W, q0 = qg * QMAX, qn = min(QMAX, nq - q0);   // this block's queries

  // the warp's queries: their columns in registers, their window positions
  float qr[QPW][8], acc[QPW][8], l[QPW], m[QPW];
  int qw[QPW];
  bool any = false;
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int ql = warp * QPW + j;
    const bool live = ql < qn;
    any |= live;
    const int i = q0 + ql, g = live ? i / W : 0, w = live ? i % W : 0;
    qw[j] = live ? w : -1;
    const T* qp = q + b * st.q_b + (hk * G + g) * st.q_h + w * st.q_w;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      qr[j][c] = live && has_col ? decode::to_f(qp[li * 8 + c]) : 0.f;
      acc[j][c] = 0.f;
    }
    l[j] = 0.f;
    m[j] = -INFINITY;
  }

  // ---- the prefix: this split's share of slots 0 .. n_prefix - 1 ----------
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(smem + P_.rows);
  const int tile = P_.tile, nst = P_.nst;
  const int per = ((n_prefix + S - 1) / S + P_.gran - 1) / P_.gran * P_.gran;
  const int lo = min(split * per, n_prefix), hi = min(lo + per, n_prefix);
  const auto prefix_ok = [](int, int) { return true; };
  for (int w0 = lo; w0 < hi; w0 += P_.win) {
    const int wn = min(P_.win, hi - w0), nt = (wn + tile - 1) / tile;
    __syncthreads();   // the previous window's tiles and lookups are done
    for (int i = threadIdx.x; i < wn; i += NTHREADS) {
      const int key = w0 + i;
      const int blk = min(max(trow[key / bt], 0), P - 1);
      rows_s[i] = static_cast<uint32_t>(((long long)blk * Hk + hk) * bt + key % bt);
    }
    __syncthreads();
    // tile t's K and V rows (and scales) into stage t % nst: one commit group
    auto issue = [&](int t) {
      const int st_ = t % nst, k0 = t * tile, cnt = min(tile, wn - k0);
      unsigned char* kt = smem + P_.kv + 2 * st_ * tile * rb;
      decode::copy_rows(kt, kpool, rows_s + k0, cnt, rb);
      decode::copy_rows(kt + tile * rb, vpool, rows_s + k0, cnt, rb);
      if constexpr (kQ8) {
        float* sc = reinterpret_cast<float*>(smem + P_.scale) + 2 * st_ * tile;
        decode::copy_scales(sc, kscale, rows_s + k0, cnt);
        decode::copy_scales(sc + tile, vscale, rows_s + k0, cnt);
      }
      decode::cp_commit();
    };
    for (int t = 0; t < nst && t < nt; ++t) issue(t);
    for (int t = 0; t < nt; ++t) {
      const int st_ = t % nst, cnt = min(tile, wn - t * tile);
      decode::cp_wait_n(min(nst, nt - t) - 1);   // tile t has arrived
      __syncthreads();
      if (any) {
        const C* kt = reinterpret_cast<const C*>(smem + P_.kv + 2 * st_ * tile * rb);
        const float* sc = reinterpret_cast<const float*>(smem + P_.scale) + 2 * st_ * tile;
        visit<C, QPW, KL>(kt, kt + tile * hd_c, sc, sc + tile, cnt, hd_c, scale, qr, acc, l, m,
                          prefix_ok, grp, li, has_col);
      }
      __syncthreads();   // this stage is free for tile t + nst
      if (t + nst < nt) issue(t + nst);
    }
  }

  // ---- the window: staged from k and v by the last split -------------------
  if (split == S - 1) {
    const bool writer = qg == 0;
    C* wk = reinterpret_cast<C*>(smem + V.wkv);
    float* wsc = reinterpret_cast<float*>(smem + V.wsc);
    uint8_t* wv_s = smem + V.wv;
    for (int w0 = 0; w0 < W; w0 += WT) {
      const int wn = min(WT, W - w0);
      __syncthreads();   // the previous window tile's rows are no longer read
      for (int r = warp; r < wn; r += NWARPS) {   // a warp a window row
        const int w = w0 + r, slot = pos0 + 1 + w;
        const bool under = slot < H;
        long long dest = -1;
        if (under) {
          const int blk = trow[slot / bt];
          if (blk >= 0 && blk < P) dest = ((long long)blk * Hk + hk) * bt + slot % bt;
        }
        if (!writer) dest = -1;
#pragma unroll
        for (int plane = 0; plane < 2; ++plane) {
          const T* src = plane == 0 ? k + b * st.k_b + hk * st.k_h + w * st.k_w
                                    : v + b * st.v_b + hk * st.v_h + w * st.v_w;
          C* row = wk + (plane * WT + r) * hd;
          C* dst = plane == 0 ? kpool : vpool;
          if constexpr (kQ8) {
            float x[DMAX / 32];
#pragma unroll
            for (int i = 0; i < DMAX / 32; ++i) {
              const int c = lane + 32 * i;
              x[i] = c < hd ? decode::to_f(src[c]) : 0.f;
            }
            q8::quantize_values(x, hd, lane, row, wsc + plane * WT + r);
            __syncwarp();
            if (dest >= 0) {
              for (int c = lane; c < hd; c += 32) dst[dest * hd + c] = row[c];
              if (lane == 0) (plane == 0 ? kscale : vscale)[dest] = wsc[plane * WT + r];
            }
          } else {
            for (int c = lane; c < hd; c += 32) {
              const T x = src[c];
              row[c] = x;
              if (dest >= 0) dst[dest * hd + c] = x;
            }
          }
        }
        if (lane == 0) wv_s[r] = under;
      }
      __syncthreads();
      if (any) {
        const auto window_ok = [&](int key, int j) {
          return wv_s[key] != 0 && w0 + key <= qw[j];
        };
        visit<C, QPW, KL>(wk, wk + WT * hd, wsc, wsc + WT, wn, hd_c, scale, qr, acc, l, m,
                          window_ok, grp, li, has_col);
      }
    }
  }

  // ---- each query's partial: the warp's key groups summed --------------------
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
#pragma unroll
    for (int o = KL; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], o);
      l[j] += __shfl_xor_sync(0xffffffffu, l[j], o);
    }
  }
  if (S == 1) {   // the one split's partial is the output
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int ql = warp * QPW + j;
      if (ql < qn && lane < KL && has_col) {
        const int i = q0 + ql, g = i / W, w = i % W;
        T* op = out + b * st.o_b + (hk * G + g) * st.o_h + w * st.o_w + li * 8;
#pragma unroll
        for (int c = 0; c < 8; ++c) decode::store(op + c, acc[j][c] / fmaxf(l[j], 1e-30f));
      }
    }
    return;
  }
  // to the workspace; the last of the splits to take a ticket merges them in
  // split order (an empty split weighs 0), writes the output and resets the
  // ticket
  const int pw = hd + 2;   // a query's partial: acc, l, m
  const long long pair = ((long long)b * Hk + hk) * nqg + qg;
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int ql = warp * QPW + j;
    if (ql < qn) {
      float* mine = ws + ((pair * S + split) * QMAX + ql) * pw;
      if (lane < KL && has_col) {
#pragma unroll
        for (int c = 0; c < 8; ++c) mine[li * 8 + c] = acc[j][c];
      }
      if (lane == 0) {
        mine[hd] = l[j];
        mine[hd + 1] = m[j];
      }
    }
  }
  int* last = reinterpret_cast<int*>(smem + P_.last);
  __threadfence();   // this block's partial is visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(tickets + pair, 1) == S - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* pt = ws + pair * S * QMAX * pw;
  for (int i = threadIdx.x; i < qn * hd; i += NTHREADS) {
    const int ql = i / hd, c = i - ql * hd;
    float M = -INFINITY;
    for (int s = 0; s < S; ++s) M = fmaxf(M, __ldcg(pt + (s * QMAX + ql) * pw + hd + 1));
    float L = 0.f, o = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* x = pt + (s * QMAX + ql) * pw;
      const float ms = __ldcg(x + hd + 1);
      const float f = ms == -INFINITY ? 0.f : expf(ms - M);
      L += __ldcg(x + hd) * f;
      o = fmaf(__ldcg(x + c), f, o);
    }
    const int qi = q0 + ql, g = qi / W, w = qi % W;
    decode::store(&out[b * st.o_b + (hk * G + g) * st.o_h + w * st.o_w + c], o / fmaxf(L, 1e-30f));
  }
  if (threadIdx.x == 0) tickets[pair] = 0;   // ready for the next launch on this stream
}

template <typename T, typename C, int QPW, int KL>
cudaError_t launch_k(const void* q, const void* k, const void* v, void* pool, float* pool_scale,
                     void* out, float* ws, int* tickets, const int* tables,
                     const int* positions, int B, int Hq, int G, int W, int P, int bt, int hd,
                     int nb, const Strides& st, float scale, cudaStream_t stream) {
  const int Hk = Hq / G;
  const VPlan V = make_vplan((long long)nb * bt, bt, hd, sizeof(C), std::is_same<C, int8_t>::value);
  if (V.bytes > decode::SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = paged_verify_write_kernel<T, C, QPW, KL>;
  const cudaError_t e = decode::allow_smem(reinterpret_cast<const void*>(kernel), V.bytes);
  if (e != cudaSuccess) return e;
  const long long plane = (long long)P * Hk * bt;   // rows in one K/V plane
  C* kpool = static_cast<C*>(pool);
  float* vscale = pool_scale == nullptr ? nullptr : pool_scale + plane;
  const int nqg = (G * W + QMAX - 1) / QMAX;
  kernel<<<dim3(V.p.S * nqg, Hk, B), NTHREADS, V.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kpool,
      kpool + plane * hd, pool_scale, vscale, static_cast<T*>(out), ws, tickets, tables,
      positions, G, W, nqg, Hk, P, bt, hd, nb, st, scale, V);
  return cudaGetLastError();
}

template <typename T, typename C, int QPW>
cudaError_t launch_q(const void* q, const void* k, const void* v, void* pool, float* ps,
                     void* out, float* ws, int* tickets, const int* tables, const int* positions,
                     int B, int Hq, int G, int W, int P, int bt, int hd, int nb,
                     const Strides& st, float scale, cudaStream_t s) {
  switch (decode::lanes_per_key(hd)) {
    case 4: return launch_k<T, C, QPW, 4>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
    case 8: return launch_k<T, C, QPW, 8>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
    default: return launch_k<T, C, QPW, 16>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
  }
}

template <typename T, typename C>
cudaError_t launch(const void* q, const void* k, const void* v, void* pool, float* ps, void* out,
                   float* ws, int* tickets, const int* tables, const int* positions, int B,
                   int Hq, int G, int W, int P, int bt, int hd, int nb, const Strides& st,
                   float scale, cudaStream_t s) {
  switch (queries_per_warp(G * W)) {
    case 1: return launch_q<T, C, 1>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
    case 2: return launch_q<T, C, 2>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
    default: return launch_q<T, C, 4>(q, k, v, pool, ps, out, ws, tickets, tables, positions, B, Hq, G, W, P, bt, hd, nb, st, scale, s);
  }
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

// The plan a launch takes at these shapes: out[0..7] = splits S a (row, kv
// head, query group), split length, prefix tile keys, tiles in flight,
// shared bytes, query groups, queries a warp, and QMAX, the queries a
// group (the merge scratch holds QMAX partials a split of each group).
void paged_verify_plan(int nb, int bt, int hd, int dtype, int q8, int G, int W, int* out) {
  const VPlan V = make_vplan((long long)nb * bt, bt, hd, q8 ? 1 : dtype == 0 ? 4 : 2, q8 != 0);
  const int vals[8] = {V.p.S, decode::SPLIT_KEYS, V.p.tile, V.p.nst, V.bytes,
                       (G * W + QMAX - 1) / QMAX, queries_per_warp(G * W), QMAX};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
}

const char* paged_verify_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

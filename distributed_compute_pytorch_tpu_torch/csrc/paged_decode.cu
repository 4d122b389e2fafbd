// Paged flash-decode read for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py,
//   `_paged_kernel` (launched by `decode_attention_paged_pallas`). One query
//   token per (row, head) attends its row's logical cache slots
//   0..min(pos[b], nb * bt - 1) read straight from the block pool through the
//   row's block table, with an online softmax in f32. On the JAX side the
//   serving path computes the same read as `gather_kv_blocks` +
//   `cached_attention`, which first builds a gathered copy of every row's
//   cache; here no copy is built and only the live blocks are read.
//
// What bounds it on this card: HBM bytes in principle, latency in
//   practice. Each (row, kv head) reads 2 * live_keys * hd elements of K and
//   V once (and two f32 scales a key in the int8 form) and does ~4 G FLOPs
//   per element, far below the card's ~295 FLOP/byte balance point; at
//   serving shapes the bytes are few, so the read is fast only with many of
//   them in flight and a short chain of round trips a block.
//
// Design: the split-key read of decode_common.cuh. The grid is (split, kv
//   head, row), S = nb * bt over the split length (256 keys), at most 16
//   (paged_decode_plan reports the plan); each block takes whole
//   table blocks of the row's live keys (its share rounded up to bt), looks
//   their physical blocks up in the table in one round trip, copies the
//   rows into shared memory with cp.async (K, then V, in two commit groups),
//   and the last split to finish merges the partials in split order through
//   the caller's workspace. Each block serves the G query heads that share
//   its kv head, so each K and V row is read once for all of them. The live
//   length is read from `pos` on the device, so the host never syncs and a
//   short row costs only its own blocks (the splits past its end load
//   nothing). The TPU kernel's packed-lane (hd == 64 pairs into 128 lanes)
//   layout stays behind.
//
// A parked row's table is all trash block, and its output is discarded by
//   the scheduler; it reads finite garbage and produces finite garbage.
//   Table entries outside [0, P) are clamped, as the reference's gather
//   clamps, so a bad table can never read outside the pool.
//
// The int8 form (`paged_decode_q8`): serving's kv_dtype="int8" pool, int8
//   K/V [2, P, Hk, bt, hd] beside f32 scales [2, P, Hk, bt, 1]. The JAX
//   package reads it in XLA (gather_kv_blocks of both leaves, then
//   ops/attention.py::cached_attention_q8); here the same kernel reads the
//   int8 rows and their scales through the table (decode_common.cuh), with
//   about half the bytes of the bf16 pool per key.
//
// The fused tick (`paged_decode_write`, `paged_decode_write_q8`): the
//   serving tick's slot write (kv_pool_insert.cu, `_pool_rows_kernel` of
//   the Pallas write, quantizing for the int8 pool) and this read in one
//   launch, the reference's `_paged_write_and_attend`
//   (ops/attention.py:313-353): row b's fresh K/V rows go to slot s =
//   min(pos[b] / bt, nb - 1) of its table, block table[b, s], offset
//   pos[b] % bt, dropped when that block lies outside [0, P) (as
//   kv_pool_insert drops it; the read still clamps table entries), and the
//   read then attends them (decode_common.cuh, design 5). The block that
//   writes is the one whose split holds logical key s * bt + pos[b] % bt:
//   pos[b] for a live row, always below the read's live length. The
//   host's (block, offset) arithmetic and the separate write launch go.

#include "decode_common.cuh"

namespace {

using decode::DMAX;
using decode::GMAX;
using decode::NTHREADS;


// a key's row through the row's block table; entries outside [0, P) clamp
// for the read, and drop the fused write
struct PagedKeys {
  const int* trow;
  int P, Hk, hk, bt;
  __device__ __forceinline__ long long row(int key) const {
    const int blk = min(max(trow[key / bt], 0), P - 1);
    return ((long long)blk * Hk + hk) * bt + key % bt;
  }
  __device__ __forceinline__ bool valid(int) const { return true; }
  __device__ __forceinline__ long long dest(int key) const {
    const int blk = trow[key / bt];
    return blk < 0 || blk >= P ? -1 : ((long long)blk * Hk + hk) * bt + key % bt;
  }
};

// the live keys of a row at position p: 0..min(p, nb * bt - 1)
__device__ __forceinline__ int live_keys(int p, int nb, int bt) {
  return p < 0 ? 0 : min(p, nb * bt - 1) + 1;
}

// T: query/output type; C: pool element type (T, or int8_t with the f32
// scale planes kscale/vscale). GT: 1 for plain multi-head attention, else
// the largest group the block can hold (the first G of GT heads are live).
// KL: lanes a key takes. Grid (split, kv head, row).
template <typename T, typename C, int GT, int KL>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const T* __restrict__ q, const C* __restrict__ kpool,
                    const C* __restrict__ vpool, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ tickets,
                    const int* __restrict__ tables, const int* __restrict__ pos,
                    int G, int Hk, int P, int bt, int hd, int nb, long long q_sb,
                    long long q_sh, long long o_sb, long long o_sh, float scale,
                    const decode::Plan plan) {
  const int hk = blockIdx.y, b = blockIdx.z;
  const int p = pos[b];
  const PagedKeys keys{tables + (long long)b * nb, P, Hk, hk, bt};
  decode::attend<T, C, GT, KL, false>(q, kpool, vpool, kscale, vscale, out, ws, tickets, keys,
                                      plan, live_keys(p, nb, bt), b, hk, Hk,
                                      GT == 1 ? 1 : G, hd, q_sb, q_sh, o_sb, o_sh, scale,
                                      decode::Write<T, C>{}, -1);
}

// The fused tick: the same read, after row b's fresh K/V rows (wr) are
// written at logical key s * bt + p % bt, s = min(p / bt, nb - 1). The
// pool pointers are not __restrict__: wr writes through them too.
template <typename T, typename C, int GT, int KL>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_write_kernel(const T* __restrict__ q, const C* kpool, const C* vpool,
                          const float* kscale, const float* vscale, T* __restrict__ out,
                          float* __restrict__ ws, int* __restrict__ tickets,
                          const int* __restrict__ tables, const int* __restrict__ pos,
                          int G, int Hk, int P, int bt, int hd, int nb, long long q_sb,
                          long long q_sh, long long o_sb, long long o_sh, float scale,
                          const decode::Write<T, C> wr, const decode::Plan plan) {
  const int hk = blockIdx.y, b = blockIdx.z;
  const int p = pos[b];
  const PagedKeys keys{tables + (long long)b * nb, P, Hk, hk, bt};
  const int wkey = p < 0 ? -1 : min(p / bt, nb - 1) * bt + p % bt;
  decode::attend<T, C, GT, KL, true>(q, kpool, vpool, kscale, vscale, out, ws, tickets, keys,
                                     plan, live_keys(p, nb, bt), b, hk, Hk,
                                     GT == 1 ? 1 : G, hd, q_sb, q_sh, o_sb, o_sh, scale, wr,
                                     wkey);
}

// the read-only kernel (no write operands) or the fused one (a Write)
template <typename T, typename C, int GT, int KL, bool WR>
constexpr auto kernel_of() {
  if constexpr (WR)
    return paged_decode_write_kernel<T, C, GT, KL>;
  else
    return paged_decode_kernel<T, C, GT, KL>;
}

// W: nothing for the read-only kernel, the decode::Write for the fused one
template <typename T, typename C, int GT, typename... W>
cudaError_t launch_g(int B, cudaStream_t stream, const T* q, const C* kpool,
                     const C* vpool, const float* ks, const float* vs, T* out, float* ws,
                     int* tickets, const int* tables, const int* pos, int G, int Hk, int P, int bt,
                     int hd, int nb, const long long* st, float scale, W... wr) {
#define DECODE_LAUNCH(KL)                                                                 \
  decode::launch_split(kernel_of<T, C, GT, KL, sizeof...(W) != 0>(), (long long)nb * bt, \
                       bt, hd, sizeof(C), std::is_same<C, int8_t>::value, GT, Hk, B,      \
                       stream, q, kpool, vpool, ks, vs, out, ws, tickets, tables, pos, G,  \
                       Hk, P, bt, hd, nb, st[0], st[1], st[2], st[3], scale, wr...)
  switch (decode::lanes_per_key(hd)) {
    case 4: return DECODE_LAUNCH(4);
    case 8: return DECODE_LAUNCH(8);
    default: return DECODE_LAUNCH(16);
  }
#undef DECODE_LAUNCH
}

// pool_scale: null for a float pool (C = T), else the f32 [2, P, Hk, bt, 1]
// scales of an int8 pool (C = int8_t). k, v: null for the read-only
// kernel, else the fused tick's K/V rows, element strides st[4..7].
template <typename T, typename C>
cudaError_t launch(const void* q, const void* k, const void* v, void* pool, float* pool_scale,
                   void* out, float* ws, int* tickets, const int* tables, const int* pos, int B,
                   int Hq, int G, int P, int bt, int hd, int nb, const long long* st,
                   float scale, cudaStream_t stream) {
  const int Hk = Hq / G;
  const long long plane = (long long)P * Hk * bt;  // rows in one K/V plane
  C* kpool = static_cast<C*>(pool);
  C* vpool = kpool + plane * hd;
  float* vscale = pool_scale == nullptr ? nullptr : pool_scale + plane;
  const T* qq = static_cast<const T*>(q);
  T* oo = static_cast<T*>(out);
  if (k == nullptr) {
    if (G == 1)
      return launch_g<T, C, 1>(B, stream, qq, kpool, vpool, pool_scale, vscale, oo, ws, tickets, tables, pos, G, Hk, P, bt, hd, nb, st, scale);
    return launch_g<T, C, GMAX>(B, stream, qq, kpool, vpool, pool_scale, vscale, oo, ws, tickets, tables, pos, G, Hk, P, bt, hd, nb, st, scale);
  }
  const decode::Write<T, C> wr{static_cast<const T*>(k), static_cast<const T*>(v), kpool, vpool,
                               pool_scale, vscale, st[4], st[5], st[6], st[7]};
  if (G == 1)
    return launch_g<T, C, 1>(B, stream, qq, kpool, vpool, pool_scale, vscale, oo, ws, tickets, tables, pos, G, Hk, P, bt, hd, nb, st, scale, wr);
  return launch_g<T, C, GMAX>(B, stream, qq, kpool, vpool, pool_scale, vscale, oo, ws, tickets, tables, pos, G, Hk, P, bt, hd, nb, st, scale, wr);
}

// one entry's launch: dtype 0 f32, 1 bf16 (the query's); an int8 pool with
// pool_scale; a fused tick with k and v
int dispatch(const void* q, const void* k, const void* v, void* pool, float* pool_scale,
             void* out, float* ws, int* tickets, const int* tables, const int* pos, int dtype,
             int B, int Hq, int G, int P, int bt, int hd, int nb, const long long* st,
             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q8 = pool_scale != nullptr;
  cudaError_t e;
  if (dtype == 0 && !q8)
    e = launch<float, float>(q, k, v, pool, pool_scale, out, ws, tickets, tables, pos, B, Hq, G, P, bt, hd, nb, st, scale, s);
  else if (dtype == 1 && !q8)
    e = launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pool, pool_scale, out, ws, tickets, tables, pos, B, Hq, G, P, bt, hd, nb, st, scale, s);
  else if (dtype == 0)
    e = launch<float, int8_t>(q, k, v, pool, pool_scale, out, ws, tickets, tables, pos, B, Hq, G, P, bt, hd, nb, st, scale, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16, int8_t>(q, k, v, pool, pool_scale, out, ws, tickets, tables, pos, B, Hq, G, P, bt, hd, nb, st, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

bool bad_shape(int B, int Hq, int G, int P, int bt, int hd, int nb) {
  // grid y and z hold the kv heads and rows; row indices are 32-bit
  return B < 1 || B > 65535 || Hq < 1 || G < 1 || G > GMAX || Hq % G ||
         Hq / G > 65535 || P < 1 || bt < 1 || nb < 1 || hd < 8 || hd > DMAX || hd % 8 ||
         (long long)P * (Hq / G) * bt > 0xffffffffLL;
}

}  // namespace

extern "C" {

// q: [B, Hq, hd] with element strides (q b, q h) and unit stride on hd;
// query head h reads kv head h / G, G <= 8.
// pool: [2, P, Hq / G, bt, hd] contiguous, 16-byte aligned. out: [B, Hq, hd]
// with strides (o b, o h); strides = (q b, q h, o b, o h). tables: int32
// [B, nb] contiguous. pos: int32 [B]. hd % 8 == 0, hd <= 128. dtype: 0 f32,
// 1 bf16. ws, tickets: the merge's scratch, private to the stream (see
// decode_common.cuh). Returns the cudaError_t of the launch.
int paged_decode(const void* q, const void* pool, void* out, float* ws, int* tickets,
                 const int* tables, const int* pos, int dtype, int B, int Hq, int G, int P,
                 int bt, int hd, int nb, const long long* strides, float scale,
                 void* stream) {
  if (bad_shape(B, Hq, G, P, bt, hd, nb) || ws == nullptr || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, nullptr, nullptr, const_cast<void*>(pool), nullptr, out, ws, tickets,
                  tables, pos, dtype, B, Hq, G, P, bt, hd, nb, strides, scale, stream);
}

// The int8 form: pool int8 [2, P, Hq / G, bt, hd] contiguous, 16-byte
// aligned; pool_scale f32 [2, P, Hq / G, bt, 1] contiguous. q and out as
// above, dtype 0 f32 or 1 bf16 (the query's).
int paged_decode_q8(const void* q, const void* pool, const float* pool_scale, void* out,
                    float* ws, int* tickets, const int* tables, const int* pos, int dtype,
                    int B, int Hq, int G,
                    int P, int bt, int hd, int nb, const long long* strides, float scale,
                    void* stream) {
  if (bad_shape(B, Hq, G, P, bt, hd, nb) || pool_scale == nullptr || ws == nullptr ||
      tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, nullptr, nullptr, const_cast<void*>(pool),
                  const_cast<float*>(pool_scale), out, ws, tickets, tables, pos, dtype, B, Hq,
                  G, P, bt, hd, nb, strides, scale, stream);
}

// The fused tick: row b's K and V rows ([B, Hq / G, hd], the query's
// dtype, element strides (k b, k h, v b, v h) and unit stride on hd) are
// written into the pool at slot min(pos[b] / bt, nb - 1) of its table,
// offset pos[b] % bt (dropped when that table entry lies outside [0, P)),
// then attended as paged_decode attends: one launch. pool as above (written
// in place); strides = (q b, q h, o b, o h, k b, k h, v b, v h).
int paged_decode_write(const void* q, const void* k, const void* v, void* pool, void* out,
                       float* ws, int* tickets, const int* tables, const int* pos, int dtype,
                       int B, int Hq, int G, int P, int bt, int hd, int nb,
                       const long long* strides, float scale, void* stream) {
  if (bad_shape(B, Hq, G, P, bt, hd, nb) || ws == nullptr || tickets == nullptr ||
      k == nullptr || v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, pool, nullptr, out, ws, tickets, tables, pos, dtype, B, Hq, G, P,
                  bt, hd, nb, strides, scale, stream);
}

// The fused tick on the int8 pool: the float K/V rows quantized per row
// (bit for bit kv_pool_insert_q8's) into pool and pool_scale, then read as
// paged_decode_q8 reads.
int paged_decode_write_q8(const void* q, const void* k, const void* v, void* pool,
                          float* pool_scale, void* out, float* ws, int* tickets,
                          const int* tables, const int* pos, int dtype, int B, int Hq, int G,
                          int P, int bt, int hd, int nb, const long long* strides,
                          float scale, void* stream) {
  if (bad_shape(B, Hq, G, P, bt, hd, nb) || pool_scale == nullptr || ws == nullptr ||
      tickets == nullptr || k == nullptr || v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, pool, pool_scale, out, ws, tickets, tables, pos, dtype, B, Hq, G,
                  P, bt, hd, nb, strides, scale, stream);
}

// The plan a launch takes at these shapes (it depends on nothing else):
// out[0..4] = splits S a (row, kv head), split length, tile keys, tiles in
// flight, shared bytes. dtype as above; q8: the int8 form.
void paged_decode_plan(int nb, int bt, int hd, int dtype, int q8, int G, int* out) {
  decode::report_plan(decode::make_plan((long long)nb * bt, bt, hd, q8 ? 1 : dtype == 0 ? 4 : 2,
                                        q8 != 0, G == 1 ? 1 : GMAX),
                      out);
}

const char* paged_decode_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

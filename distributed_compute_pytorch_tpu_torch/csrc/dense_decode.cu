// Dense flash-decode read for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py,
//   `_kernel` (launched by `decode_attention_pallas`). One query token per
//   (row, head) attends its row's dense KV-pair cache [2, B, Hk, T, hd] over
//   slots 0..min(pos[b], T - 1), read in place (the two planes through the
//   base pointer and the plane stride), with an online softmax in f32: the
//   Pallas kernel's dynamic length bound, with its clamp. It also takes an
//   optional [B, T] slot mask, which the Pallas kernel lacks: left-padded
//   generation masks each row's pad slots, so this kernel computes what
//   `ops/attention.py::cached_attention(..., slot_mask=...)` computes, the
//   read every generation tick makes.
//
// What bounds it on this card: HBM bytes in principle, latency in
//   practice. Each (row, kv head) needs the K and V rows of its slots 0..pos
//   once, 2 * hd elements each (and two f32 scales a slot in the int8 form),
//   and does ~4 G FLOPs per element, far below the card's ~295 FLOP/byte
//   balance point; at generation shapes the bytes are few, so the read is
//   fast only with many in flight and a short chain of round trips a block.
//
// Design: the split-key read of decode_common.cuh. The grid is (split, kv
//   head, row), S = T over the split length (256 keys), at most 16
//   (dense_decode_plan reports the plan); each block takes its share
//   of the row's slots 0..pos, reads their mask bytes first, copies the
//   contiguous K and V rows of the tiles with a valid slot into shared
//   memory with cp.async (K, then V, in two commit groups), and the last
//   split to finish merges the partials in split order through the caller's
//   workspace. A tile whose slots are all masked (a left-pad run) loads no K
//   or V and adds exactly 0, as the reference's -1e30 fill does; a masked
//   slot inside a live tile is loaded and weighted by 0. The block serves
//   the G <= 8 query heads that share the kv head, so each K and V row is
//   read once for all of them. The length comes from `pos` on the device
//   (pos[b * pos_stride]: stride 0 for the lockstep tick's one position, 1
//   for per-row positions), so the host never syncs. The TPU kernel's
//   packed-lane (hd == 64 pairs into 128 lanes) layout and its fold matrix
//   stay behind.
//
// The int8 form (`dense_decode_q8`): generation's kv_quant cache, int8 K/V
//   [2, B, Hk, T, hd] beside f32 scales [2, B, Hk, T, 1]. The JAX package
//   reads it in XLA (ops/attention.py::cached_attention_q8); here the same
//   kernel reads the int8 rows and their scales (decode_common.cuh), with
//   about half the bytes of the bf16 cache per key.
//
// The fused tick (`dense_decode_write`, `dense_decode_write_q8`): the
//   generation tick's slot write (kv_insert.cu, `_pair_kernel` /
//   `_pair_rows_kernel` of the Pallas writes, quantizing for the int8
//   cache) and this read in one launch, the reference's dense
//   `cache_write_and_attend` (ops/attention.py:425-466): row b's fresh K/V
//   rows go to slot pos[b * pos_stride] whatever the slot mask says (the
//   mask governs only what is attended), dropped when the slot lies
//   outside [0, T) (as kv_insert drops it; the JAX fallback clamps), and
//   the read then attends them (decode_common.cuh, design 5). The block
//   that writes is the one whose split holds that slot.

#include "decode_common.cuh"

namespace {

using decode::DMAX;
using decode::GMAX;
using decode::NTHREADS;

// a split's share of the slots is a multiple of this
constexpr int GRAN = 16;

// contiguous slots of one (row, kv head); mask: that row of the slot mask
// (nonzero = attend) or null
struct DenseKeys {
  long long base;
  const uint8_t* mask;
  __device__ __forceinline__ long long row(int key) const { return base + key; }
  __device__ __forceinline__ bool valid(int key) const {
    return mask == nullptr || mask[key] != 0;
  }
  __device__ __forceinline__ long long dest(int key) const { return base + key; }
};

// T: query/output type; C: cache element type (T, or int8_t with the f32
// scale planes kscale/vscale). KL: lanes a key takes. Grid (split, kv
// head, row).
template <typename T, typename C, int GT, int KL>
__global__ void __launch_bounds__(NTHREADS)
dense_decode_kernel(const T* __restrict__ q, const C* __restrict__ cache,
                    const float* __restrict__ kscale, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ tickets,
                    const int* __restrict__ pos,
                    const uint8_t* __restrict__ slot_mask, int G, int B, int Hk,
                    int T_, int hd, int pos_stride, long long q_sb,
                    long long q_sh, long long o_sb, long long o_sh,
                    long long m_sb, float scale,
                    const decode::Plan plan) {
  const int hk = blockIdx.y, b = blockIdx.z;
  const int p = pos[(long long)b * pos_stride];
  const int n_keys = p < 0 ? 0 : min(p, T_ - 1) + 1;
  const DenseKeys keys{((long long)b * Hk + hk) * T_,
                       slot_mask == nullptr ? nullptr : slot_mask + b * m_sb};
  const long long plane = (long long)B * Hk * T_;  // rows in one K/V plane
  const C* vplane = cache + plane * hd;
  const float* vscale = kscale == nullptr ? nullptr : kscale + plane;
  decode::attend<T, C, GT, KL, false>(q, cache, vplane, kscale, vscale, out, ws, tickets, keys,
                                      plan, n_keys, b, hk, Hk, GT == 1 ? 1 : G, hd, q_sb,
                                      q_sh, o_sb, o_sh, scale, decode::Write<T, C>{}, -1);
}

// The fused tick: the same read, after row b's fresh K/V rows (wr) are
// written at slot p when it lies in [0, T). The cache pointers are not
// __restrict__: wr writes through them too.
template <typename T, typename C, int GT, int KL>
__global__ void __launch_bounds__(NTHREADS)
dense_decode_write_kernel(const T* __restrict__ q, const C* cache, const float* kscale,
                          T* __restrict__ out, float* __restrict__ ws,
                          int* __restrict__ tickets, const int* __restrict__ pos,
                          const uint8_t* __restrict__ slot_mask, int G, int B, int Hk,
                          int T_, int hd, int pos_stride, long long q_sb,
                          long long q_sh, long long o_sb, long long o_sh,
                          long long m_sb, float scale, const decode::Write<T, C> wr,
                          const decode::Plan plan) {
  const int hk = blockIdx.y, b = blockIdx.z;
  const int p = pos[(long long)b * pos_stride];
  const int n_keys = p < 0 ? 0 : min(p, T_ - 1) + 1;
  const DenseKeys keys{((long long)b * Hk + hk) * T_,
                       slot_mask == nullptr ? nullptr : slot_mask + b * m_sb};
  const long long plane = (long long)B * Hk * T_;  // rows in one K/V plane
  const C* vplane = cache + plane * hd;
  const float* vscale = kscale == nullptr ? nullptr : kscale + plane;
  decode::attend<T, C, GT, KL, true>(q, cache, vplane, kscale, vscale, out, ws, tickets, keys,
                                     plan, n_keys, b, hk, Hk, GT == 1 ? 1 : G, hd, q_sb,
                                     q_sh, o_sb, o_sh, scale, wr, p >= 0 && p < T_ ? p : -1);
}

// the read-only kernel (no write operands) or the fused one (a Write)
template <typename T, typename C, int GT, int KL, bool WR>
constexpr auto kernel_of() {
  if constexpr (WR)
    return dense_decode_write_kernel<T, C, GT, KL>;
  else
    return dense_decode_kernel<T, C, GT, KL>;
}

// W: nothing for the read-only kernel, the decode::Write for the fused one
template <typename T, typename C, int GT, typename... W>
cudaError_t launch_g(cudaStream_t stream, const T* q, const C* cache, const float* ks,
                     T* out, float* ws, int* tickets, const int* pos, const uint8_t* mask, int G, int B, int Hk,
                     int T_, int hd, int pos_stride, const long long* st, float scale, W... wr) {
#define DECODE_LAUNCH(KL)                                                                  \
  decode::launch_split(kernel_of<T, C, GT, KL, sizeof...(W) != 0>(), T_, GRAN, hd,        \
                       sizeof(C), std::is_same<C, int8_t>::value, GT, Hk, B, stream, q,    \
                       cache, ks, out, ws, tickets, pos, mask, G, B, Hk, T_, hd,           \
                       pos_stride, st[0], st[1], st[2], st[3], st[4], scale, wr...)
  switch (decode::lanes_per_key(hd)) {
    case 4: return DECODE_LAUNCH(4);
    case 8: return DECODE_LAUNCH(8);
    default: return DECODE_LAUNCH(16);
  }
#undef DECODE_LAUNCH
}

// cache_scale: null for a float cache (C = T), else the f32 [2, B, Hk, T, 1]
// scales of an int8 cache (C = int8_t). k, v: null for the read-only
// kernel, else the fused tick's K/V rows, element strides st[5..8].
template <typename T, typename C>
cudaError_t launch(const void* q, const void* k, const void* v, void* cache,
                   float* cache_scale, void* out, float* ws, int* tickets, const int* pos,
                   const uint8_t* mask, int B, int Hq, int G, int T_, int hd, int pos_stride,
                   const long long* st, float scale, cudaStream_t stream) {
  const int Hk = Hq / G;
  const T* qq = static_cast<const T*>(q);
  C* cc = static_cast<C*>(cache);
  T* oo = static_cast<T*>(out);
  if (k == nullptr) {
    if (G == 1)
      return launch_g<T, C, 1>(stream, qq, cc, cache_scale, oo, ws, tickets, pos, mask, G, B, Hk, T_, hd, pos_stride, st, scale);
    return launch_g<T, C, GMAX>(stream, qq, cc, cache_scale, oo, ws, tickets, pos, mask, G, B, Hk, T_, hd, pos_stride, st, scale);
  }
  const long long plane = (long long)B * Hk * T_;  // rows in one K/V plane
  const decode::Write<T, C> wr{static_cast<const T*>(k), static_cast<const T*>(v), cc,
                               cc + plane * hd, cache_scale,
                               cache_scale == nullptr ? nullptr : cache_scale + plane,
                               st[5], st[6], st[7], st[8]};
  if (G == 1)
    return launch_g<T, C, 1>(stream, qq, cc, cache_scale, oo, ws, tickets, pos, mask, G, B, Hk, T_, hd, pos_stride, st, scale, wr);
  return launch_g<T, C, GMAX>(stream, qq, cc, cache_scale, oo, ws, tickets, pos, mask, G, B, Hk, T_, hd, pos_stride, st, scale, wr);
}

// one entry's launch: dtype 0 f32, 1 bf16 (the query's); an int8 cache
// with cache_scale; a fused tick with k and v
int dispatch(const void* q, const void* k, const void* v, void* cache, float* cache_scale,
             void* out, float* ws, int* tickets, const int* pos, const uint8_t* mask,
             int dtype, int B, int Hq, int G, int T, int hd, int pos_stride,
             const long long* st, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q8 = cache_scale != nullptr;
  cudaError_t e;
  if (dtype == 0 && !q8)
    e = launch<float, float>(q, k, v, cache, cache_scale, out, ws, tickets, pos, mask, B, Hq, G, T, hd, pos_stride, st, scale, s);
  else if (dtype == 1 && !q8)
    e = launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, cache, cache_scale, out, ws, tickets, pos, mask, B, Hq, G, T, hd, pos_stride, st, scale, s);
  else if (dtype == 0)
    e = launch<float, int8_t>(q, k, v, cache, cache_scale, out, ws, tickets, pos, mask, B, Hq, G, T, hd, pos_stride, st, scale, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16, int8_t>(q, k, v, cache, cache_scale, out, ws, tickets, pos, mask, B, Hq, G, T, hd, pos_stride, st, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

bool bad_shape(int B, int Hq, int G, int T, int hd, int pos_stride) {
  // grid y and z hold the kv heads and rows; row indices are 32-bit
  return B < 1 || B > 65535 || Hq < 1 || G < 1 || G > GMAX || Hq % G ||
         Hq / G > 65535 || T < 1 || hd < 8 || hd > DMAX || hd % 8 || pos_stride < 0 ||
         pos_stride > 1 || (long long)B * (Hq / G) * T > 0xffffffffLL;
}

}  // namespace

extern "C" {

// q: [B, Hq, hd] with element strides (q b, q h) and unit stride on hd;
// query head h reads kv head h / G, G <= 8. cache: [2, B, Hq / G, T, hd]
// contiguous, 16-byte aligned. out: [B, Hq, hd] with strides (o b, o h).
// pos: int32, row b reads pos[b * pos_stride] (pos_stride 0 or 1).
// slot_mask: null, or uint8 [B, T] with row stride (m b) and unit stride on
// T. strides = (q b, q h, o b, o h, m b). hd % 8 == 0, hd <= 128. dtype:
// 0 f32, 1 bf16. ws, tickets: the merge's scratch, private to the stream
// (see decode_common.cuh). Returns the cudaError_t of the
// launch.
int dense_decode(const void* q, const void* cache, void* out, float* ws, int* tickets,
                 const int* pos, const uint8_t* slot_mask, int dtype, int B, int Hq, int G,
                 int T, int hd, int pos_stride, const long long* strides,
                 float scale, void* stream) {
  if (bad_shape(B, Hq, G, T, hd, pos_stride) || ws == nullptr || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, nullptr, nullptr, const_cast<void*>(cache), nullptr, out, ws, tickets,
                  pos, slot_mask, dtype, B, Hq, G, T, hd, pos_stride, strides, scale, stream);
}

// The int8 form: cache int8 [2, B, Hq / G, T, hd] contiguous, 16-byte
// aligned; cache_scale f32 [2, B, Hq / G, T, 1] contiguous. The rest as
// above, dtype 0 f32 or 1 bf16 (the query's).
int dense_decode_q8(const void* q, const void* cache, const float* cache_scale, void* out,
                    float* ws, int* tickets, const int* pos, const uint8_t* slot_mask, int dtype, int B, int Hq,
                    int G, int T, int hd, int pos_stride, const long long* strides,
                    float scale, void* stream) {
  if (bad_shape(B, Hq, G, T, hd, pos_stride) || cache_scale == nullptr || ws == nullptr ||
      tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, nullptr, nullptr, const_cast<void*>(cache),
                  const_cast<float*>(cache_scale), out, ws, tickets, pos, slot_mask, dtype, B,
                  Hq, G, T, hd, pos_stride, strides, scale, stream);
}

// The fused tick: row b's K and V rows ([B, Hq / G, hd], the query's
// dtype, element strides (k b, k h, v b, v h) and unit stride on hd) are
// written into the cache at slot pos[b * pos_stride] (dropped outside
// [0, T); written whatever slot_mask says), then attended as dense_decode
// attends: one launch. cache as above (written in place); strides = (q b,
// q h, o b, o h, m b, k b, k h, v b, v h).
int dense_decode_write(const void* q, const void* k, const void* v, void* cache, void* out,
                       float* ws, int* tickets, const int* pos, const uint8_t* slot_mask,
                       int dtype, int B, int Hq, int G, int T, int hd, int pos_stride,
                       const long long* strides, float scale, void* stream) {
  if (bad_shape(B, Hq, G, T, hd, pos_stride) || ws == nullptr || tickets == nullptr ||
      k == nullptr || v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, cache, nullptr, out, ws, tickets, pos, slot_mask, dtype, B, Hq, G,
                  T, hd, pos_stride, strides, scale, stream);
}

// The fused tick on the int8 cache: the float K/V rows quantized per row
// (bit for bit kv_insert_q8's) into cache and cache_scale, then read as
// dense_decode_q8 reads.
int dense_decode_write_q8(const void* q, const void* k, const void* v, void* cache,
                          float* cache_scale, void* out, float* ws, int* tickets,
                          const int* pos, const uint8_t* slot_mask, int dtype, int B, int Hq,
                          int G, int T, int hd, int pos_stride, const long long* strides,
                          float scale, void* stream) {
  if (bad_shape(B, Hq, G, T, hd, pos_stride) || cache_scale == nullptr || ws == nullptr ||
      tickets == nullptr || k == nullptr || v == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, cache, cache_scale, out, ws, tickets, pos, slot_mask, dtype, B, Hq,
                  G, T, hd, pos_stride, strides, scale, stream);
}

// The plan a launch takes at these shapes (it depends on nothing else):
// out[0..4] = splits S a (row, kv head), split length, tile keys, tiles in
// flight, shared bytes. dtype as above; q8: the int8 form.
void dense_decode_plan(int T, int hd, int dtype, int q8, int G, int* out) {
  decode::report_plan(
      decode::make_plan(T, GRAN, hd, q8 ? 1 : dtype == 0 ? 4 : 2, q8 != 0, G == 1 ? 1 : GMAX),
      out);
}

const char* dense_decode_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// Dense KV-cache slot write for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces three Pallas kernels of
//   distributed_compute_pytorch_tpu/ops/pallas/cache_update.py:
//   `_insert_kernel` (cache_insert_pallas: one [B, Hk, T, hd] cache at a
//   scalar pos; s = 1), `_pair_kernel` (kv_insert_pallas: the K/V pair
//   cache [2, B, Hk, T, hd] at a scalar pos, the lockstep generation tick;
//   s = 2, pos_stride = 0) and `_pair_rows_kernel` (kv_insert_rows_pallas:
//   the pair at per-row pos[b]; s = 2, pos_stride = 1). Plane i of the
//   [s, B, Hk, 1, w] update goes into the contiguous [s, B, Hk, T, w] cache
//   at slot pos[b * pos_stride], in place. A slot outside [0, T) drops the
//   row, as kv_pool_insert drops one (the JAX fallback,
//   dynamic_update_slice, clamps it instead). Generation's tick no longer
//   launches it: its write is fused into its read (dense_decode.cu,
//   `dense_decode_write`), which is held bit for bit to this kernel
//   followed by the read-only read.
//
// What bounds it on this card: pure data movement, s * B * Hk * w elements
//   read and written once each — HBM bytes (3.35 TB/s), and at generation
//   sizes (16 rows * 12 heads * 64 * 2 planes) launch latency long before
//   that.
//
// Design: one thread per written element, consecutive threads on
//   consecutive head-dim elements, so each warp reads and writes contiguous
//   runs. Each update plane may be a strided view (the K/V split-head views
//   of the fused QKV projection): only the head dim needs unit stride, so
//   the caller stacks or copies nothing, and the lockstep position is one
//   device int read by every row (pos_stride 0), so no per-row copy of it
//   is made either. The TPU kernels' 8- and 32-slot write windows (a Mosaic
//   tiling rule) stay behind: the card writes the one slot directly. The
//   copy moves 2- or 4-byte words and never looks at their value.
//
// The int8 form (`kv_insert_q8`): the same three Pallas kernels on the
//   int8 tree {"kv": int8 [s, B, Hk, T, hd], "scale": f32 [s, B, Hk, T, 1]}
//   (the JAX package quantizes outside the kernel and writes both leaves,
//   each with its own window, 32 slots for int8). Here the kernel takes the
//   FLOAT update and quantizes it as it writes: one warp per (plane, row,
//   kv head) reads the hd floats, reduces their absmax with shuffles and
//   writes hd int8 bytes and one f32 scale at the slot
//   (quantize_common.cuh, bit for bit the reference's `_q8`), so a decode
//   tick's quantization costs no launch of its own. Bound: the float
//   update read once, the int8 bytes and the scale written once (bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize_common.cuh"

namespace {

template <typename W>
__global__ void kv_insert_kernel(W* __restrict__ cache, const W* __restrict__ k,
                                 const W* __restrict__ v, const int* __restrict__ pos,
                                 int S, int B, int Hk, int T, int w, int pos_stride,
                                 long long k_sb, long long k_sh, long long v_sb,
                                 long long v_sh) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long total = (long long)S * B * Hk * w;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % w);
  long long r = idx / w;
  const int h = static_cast<int>(r % Hk);
  r /= Hk;
  const int b = static_cast<int>(r % B);
  const int s = static_cast<int>(r / B);
  const int p = pos[(long long)b * pos_stride];
  if (p < 0 || p >= T) return;  // dropped
  const W* src = s == 0 ? k + b * k_sb + h * k_sh : v + b * v_sb + h * v_sh;
  cache[((((long long)s * B + b) * Hk + h) * T + p) * w + c] = src[c];
}

template <typename W>
cudaError_t launch(void* cache, const void* k, const void* v, const int* pos,
                   int S, int B, int Hk, int T, int w, int pos_stride,
                   const long long* st, cudaStream_t stream) {
  const long long total = (long long)S * B * Hk * w;
  const int threads = 256;
  const long long blocks_needed = (total + threads - 1) / threads;
  if (blocks_needed > 2147483647LL) return cudaErrorInvalidValue;
  kv_insert_kernel<W><<<static_cast<unsigned>(blocks_needed), threads, 0, stream>>>(
      static_cast<W*>(cache), static_cast<const W*>(k), static_cast<const W*>(v),
      pos, S, B, Hk, T, w, pos_stride, st[0], st[1], st[2], st[3]);
  return cudaGetLastError();
}

// one warp per (plane s, row b, kv head h): quantize the update row and
// write it, and its scale, at slot pos[b * pos_stride]
template <typename T>
__global__ void kv_insert_q8_kernel(int8_t* __restrict__ cache, float* __restrict__ scale,
                                    const T* __restrict__ k, const T* __restrict__ v,
                                    const int* __restrict__ pos, int S, int B, int Hk,
                                    int T_, int hd, int pos_stride, long long k_sb,
                                    long long k_sh, long long v_sb, long long v_sh) {
  const long long w = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)S * B * Hk) return;  // uniform across the warp
  const int h = static_cast<int>(w % Hk);
  const long long r = w / Hk;
  const int b = static_cast<int>(r % B);
  const int s = static_cast<int>(r / B);
  const int p = pos[(long long)b * pos_stride];
  if (p < 0 || p >= T_) return;  // dropped (uniform across the warp)
  const T* src = s == 0 ? k + b * k_sb + h * k_sh : v + b * v_sb + h * v_sh;
  const long long row = (((long long)s * B + b) * Hk + h) * T_ + p;
  q8::quantize_row(src, hd, lane, cache + row * hd, scale + row);
}

template <typename T>
cudaError_t launch_q8(void* cache, float* scale, const void* k, const void* v,
                      const int* pos, int S, int B, int Hk, int T_, int hd,
                      int pos_stride, const long long* st, cudaStream_t stream) {
  const int threads = 256;  // 8 warps, 8 rows
  const long long blocks_needed = ((long long)S * B * Hk + 7) / 8;
  if (blocks_needed > 2147483647LL) return cudaErrorInvalidValue;
  kv_insert_q8_kernel<T><<<static_cast<unsigned>(blocks_needed), threads, 0, stream>>>(
      static_cast<int8_t*>(cache), scale, static_cast<const T*>(k),
      static_cast<const T*>(v), pos, S, B, Hk, T_, hd, pos_stride, st[0], st[1],
      st[2], st[3]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cache: [S, B, Hk, T, w] contiguous, S 1 or 2. k (plane 0) and, for S = 2,
// v (plane 1): [B, Hk, w] with element strides strides = (k b, k h, v b,
// v h) and unit stride on w (v and its strides unused for S = 1). pos:
// int32, row b writes slot pos[b * pos_stride] (pos_stride 0 or 1).
// elem_size: bytes per element, 2 or 4. Returns the cudaError_t of the
// launch.
int kv_insert(void* cache, const void* k, const void* v, const int* pos,
              int elem_size, int S, int B, int Hk, int T, int w, int pos_stride,
              const long long* strides, void* stream) {
  if (S < 1 || S > 2 || B < 1 || Hk < 1 || T < 1 || w < 1 || pos_stride < 0 ||
      pos_stride > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (elem_size == 4)
    e = launch<uint32_t>(cache, k, v, pos, S, B, Hk, T, w, pos_stride, strides, s);
  else if (elem_size == 2)
    e = launch<uint16_t>(cache, k, v, pos, S, B, Hk, T, w, pos_stride, strides, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The int8 form. cache: int8 [S, B, Hk, T, hd] contiguous; scale: f32
// [S, B, Hk, T, 1] contiguous. k, v: FLOAT updates as above (dtype 0 f32,
// 1 bf16, both of one dtype), quantized per (plane, row, head) as they are
// written. hd <= 128. Returns the cudaError_t of the launch.
int kv_insert_q8(void* cache, float* scale, const void* k, const void* v,
                 const int* pos, int dtype, int S, int B, int Hk, int T, int hd,
                 int pos_stride, const long long* strides, void* stream) {
  if (S < 1 || S > 2 || B < 1 || Hk < 1 || T < 1 || hd < 1 || hd > q8::DMAX ||
      pos_stride < 0 || pos_stride > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_q8<float>(cache, scale, k, v, pos, S, B, Hk, T, hd, pos_stride, strides, s);
  else if (dtype == 1)
    e = launch_q8<__nv_bfloat16>(cache, scale, k, v, pos, S, B, Hk, T, hd, pos_stride,
                                 strides, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* kv_insert_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

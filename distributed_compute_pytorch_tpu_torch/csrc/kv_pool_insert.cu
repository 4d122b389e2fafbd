// Paged KV-pool slot write for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/cache_update.py,
//   `_pool_rows_kernel` (launched by `kv_pool_insert_rows_pallas`): for each
//   row i, pool[0, blocks[i], :, offsets[i], :] = k[i] and
//   pool[1, blocks[i], :, offsets[i], :] = v[i], in place. Row ids outside
//   [0, P) (or offsets outside [0, bt)) are SKIPPED, the `mode="drop"`
//   contract of the XLA fallback `_pool_scatter`, so one kernel serves both
//   the decode tick (B rows, one token each) and the admission scatter (a
//   wave's K * window tokens flattened into rows, pad tokens aimed at block
//   id P and dropped). On the serving path it is the admission scatter:
//   the tick's write is fused into its read (paged_decode.cu,
//   `paged_decode_write`), which is held bit for bit to this kernel
//   followed by the read-only read.
//
// What bounds it on this card: pure data movement, 2 * N * H * hd elements
//   read and written once each — HBM bytes (3.35 TB/s), and at decode sizes
//   (16 rows * 12 heads * 64) launch latency long before that.
//
// Design: one thread per written element, consecutive threads on
//   consecutive head-dim elements, so each warp reads and writes contiguous
//   runs of the update and of the pool row. The update may be a strided view
//   (the K/V slices of the fused QKV projection): only the head dim needs
//   unit stride, so the caller stacks or copies nothing. The TPU kernel's
//   8/32-slot write windows (a Mosaic tiling rule) stay behind: the card
//   writes one slot directly.
//
// Parked decode rows all point at the shared trash block, so several rows
//   may write the same trash slot in one launch. That race is benign: the
//   trash block is never attended, so whichever value lands is never read.
//
// The int8 form (`kv_pool_insert_q8`): the same Pallas kernel on the int8
//   pool {"kv": int8 [2, P, H, bt, hd], "scale": f32 [2, P, H, bt, 1]}
//   (serving's kv_dtype="int8"; the JAX package quantizes outside the
//   kernel, and its admission quantizes inside the XLA scatter). Here the
//   kernel takes the FLOAT rows and quantizes them as it writes: one warp
//   per (row, plane, head) reduces the row's absmax with shuffles and
//   writes hd int8 bytes and one f32 scale (quantize_common.cuh, bit for
//   bit the reference's `_q8`), both for the decode tick and for the
//   admission scatter. Bound: the float rows read once, the int8 bytes and
//   scales written once (bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize_common.cuh"

namespace {

template <typename T>
__global__ void kv_pool_insert_kernel(T* __restrict__ pool, const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      const int* __restrict__ blocks,
                                      const int* __restrict__ offsets, int N,
                                      int P, int H, int bt, int hd,
                                      long long k_sn, long long k_sh,
                                      long long v_sn, long long v_sh) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long per_row = 2LL * H * hd;
  if (idx >= N * per_row) return;
  const int n = static_cast<int>(idx / per_row);
  int rem = static_cast<int>(idx % per_row);
  const int s = rem / (H * hd);
  rem %= H * hd;
  const int h = rem / hd, c = rem % hd;
  const int blk = blocks[n], off = offsets[n];
  if (blk < 0 || blk >= P || off < 0 || off >= bt) return;  // dropped
  const T* src = s == 0 ? k + n * k_sn + h * k_sh : v + n * v_sn + h * v_sh;
  pool[(((s * (long long)P + blk) * H + h) * bt + off) * hd + c] = src[c];
}

template <typename T>
cudaError_t launch(void* pool, const void* k, const void* v, const int* blocks,
                   const int* offsets, int N, int P, int H, int bt, int hd,
                   const long long* st, cudaStream_t stream) {
  const long long total = 2LL * N * H * hd;
  const int threads = 256;
  const long long blocks_needed = (total + threads - 1) / threads;
  if (blocks_needed > 2147483647LL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks_needed);
  kv_pool_insert_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<T*>(pool), static_cast<const T*>(k), static_cast<const T*>(v),
      blocks, offsets, N, P, H, bt, hd, st[0], st[1], st[2], st[3]);
  return cudaGetLastError();
}

// one warp per (row n, plane s, head h): quantize update row n's head h and
// write it, and its scale, at (blocks[n], offsets[n])
template <typename T>
__global__ void kv_pool_insert_q8_kernel(int8_t* __restrict__ pool, float* __restrict__ scale,
                                         const T* __restrict__ k, const T* __restrict__ v,
                                         const int* __restrict__ blocks,
                                         const int* __restrict__ offsets, int N, int P,
                                         int H, int bt, int hd, long long k_sn,
                                         long long k_sh, long long v_sn, long long v_sh) {
  const long long w = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= 2LL * N * H) return;  // uniform across the warp
  const int n = static_cast<int>(w / (2 * H));
  const int rem = static_cast<int>(w % (2 * H));
  const int s = rem / H, h = rem % H;
  const int blk = blocks[n], off = offsets[n];
  if (blk < 0 || blk >= P || off < 0 || off >= bt) return;  // dropped
  const T* src = s == 0 ? k + n * k_sn + h * k_sh : v + n * v_sn + h * v_sh;
  const long long row = ((s * (long long)P + blk) * H + h) * bt + off;
  q8::quantize_row(src, hd, lane, pool + row * hd, scale + row);
}

template <typename T>
cudaError_t launch_q8(void* pool, float* scale, const void* k, const void* v,
                      const int* blocks, const int* offsets, int N, int P, int H,
                      int bt, int hd, const long long* st, cudaStream_t stream) {
  const int threads = 256;  // 8 warps, 8 rows
  const long long blocks_needed = (2LL * N * H + 7) / 8;
  if (blocks_needed > 2147483647LL) return cudaErrorInvalidValue;
  kv_pool_insert_q8_kernel<T><<<static_cast<unsigned>(blocks_needed), threads, 0, stream>>>(
      static_cast<int8_t*>(pool), scale, static_cast<const T*>(k),
      static_cast<const T*>(v), blocks, offsets, N, P, H, bt, hd, st[0], st[1],
      st[2], st[3]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pool: [2, P, H, bt, hd] contiguous. k, v: [N, H, hd] with element strides
// strides = (k n, k h, v n, v h) and unit stride on hd. blocks, offsets:
// int32 [N] contiguous. dtype: 0 f32, 1 bf16. Returns the cudaError_t of the
// launch (N == 0 launches nothing).
int kv_pool_insert(void* pool, const void* k, const void* v, const int* blocks,
                   const int* offsets, int dtype, int N, int P, int H, int bt,
                   int hd, const long long* strides, void* stream) {
  if (N < 0 || P < 1 || H < 1 || bt < 1 || hd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(pool, k, v, blocks, offsets, N, P, H, bt, hd, strides, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(pool, k, v, blocks, offsets, N, P, H, bt, hd, strides, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The int8 form. pool: int8 [2, P, H, bt, hd] contiguous; scale: f32
// [2, P, H, bt, 1] contiguous. k, v: FLOAT rows as above (dtype 0 f32, 1
// bf16, both of one dtype), quantized per (row, plane, head) as they are
// written. hd <= 128. Returns the cudaError_t of the launch (N == 0
// launches nothing).
int kv_pool_insert_q8(void* pool, float* scale, const void* k, const void* v,
                      const int* blocks, const int* offsets, int dtype, int N, int P,
                      int H, int bt, int hd, const long long* strides, void* stream) {
  if (N < 0 || P < 1 || H < 1 || bt < 1 || hd < 1 || hd > q8::DMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch_q8<float>(pool, scale, k, v, blocks, offsets, N, P, H, bt, hd, strides, s);
  else if (dtype == 1)
    e = launch_q8<__nv_bfloat16>(pool, scale, k, v, blocks, offsets, N, P, H, bt, hd,
                                 strides, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* kv_pool_insert_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

// Shared device code of the int8 KV slot writes (kv_insert.cu,
// kv_pool_insert.cu, and the fused write of the decode reads'
// *_write_q8 entries, decode_common.cuh), Hopper (sm_90a): one warp
// quantizes one cached row.
//
// `quantize_row` is `_q8` of distributed_compute_pytorch_tpu/utils/quantize.py
// (and its plain PyTorch copy, utils/quantize.py::quantize_kv) for one row of
// hd <= 128 elements, bit for bit: lane j loads elements j, j + 32, ... as
// f32 (a bf16 element converts exactly), the row's absmax is reduced with
// shuffles (max is exact in any order), scale = max(absmax / 127, 1e-12)
// with IEEE division (this file is compiled without --use_fast_math), and
// each element is rintf(x / scale) (IEEE division; rintf rounds half to
// even, as torch.round and jnp.round do) clipped to [-127, 127]. The warp
// writes the hd int8 bytes, coalesced, and lane 0 the one f32 scale.
// `quantize_values` is the same from values a caller has already loaded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace q8 {

constexpr int DMAX = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// call from all 32 lanes of a warp; x: lane j's elements j, j + 32, ... of
// the row as f32, 0 past hd
__device__ __forceinline__ void quantize_values(const float (&x)[DMAX / 32], int hd, int lane,
                                                int8_t* __restrict__ dst,
                                                float* __restrict__ scale) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
  const float sc = fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int c = lane + 32 * i;
    if (c < hd)
      dst[c] = static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(x[i], sc)), -127.f), 127.f));
  }
  if (lane == 0) *scale = sc;
}

// call from all 32 lanes of a warp; src: the row's hd elements (unit stride)
template <typename T>
__device__ __forceinline__ void quantize_row(const T* __restrict__ src, int hd, int lane,
                                             int8_t* __restrict__ dst,
                                             float* __restrict__ scale) {
  float x[DMAX / 32];
#pragma unroll
  for (int i = 0; i < DMAX / 32; ++i) {
    const int c = lane + 32 * i;
    x[i] = c < hd ? to_f(src[c]) : 0.f;
  }
  quantize_values(x, hd, lane, dst, scale);
}

}  // namespace q8

// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/flash_attention.py,
//   `_fwd_kernel` (launched by `_flash_fwd`, public `flash_attention`).
//   Forward only: softmax(Q K^T * scale + mask) V with an online softmax in
//   f32, bottom-right causal alignment (query row i attends keys
//   <= i + tk - t), an optional [b, tk] key-validity mask with the finite
//   -1e30 fill, and the logsumexp saved for a later backward.
//
// What bounds it on this card: at the serving shapes (t = tk <= 1024,
//   d = 64) the work is ~t*tk*d*2 FLOPs per head against ~(t + 2 tk) * d
//   bytes, i.e. compute-bound in principle (989 TFLOP/s bf16 on the tensor
//   cores). This first version does its products with plain f32 FMAs on the
//   CUDA cores (67 TFLOP/s f32 peak), so it is bounded by FMA and
//   shared-memory issue rate, not by HBM. Tensor cores (mma.sync / wgmma)
//   are left to a later change.
//
// Design: one thread block per (batch*head, tile of BQ = 16 query rows),
//   four warps, each owning RPW = 4 rows and their online-softmax state in
//   registers. The block loops over key tiles of BK = 32, staged in shared
//   memory as f32, and stops at the causal limit of its last row, so a
//   causal prefill reads about half the keys. Inside a tile lane j owns key
//   j for the scores (rows of the K tile are padded to 129 floats so the 32
//   lanes hit 32 banks), and lane j owns output columns j, j+32, ... for the
//   P V product, with each p broadcast by a warp shuffle. Ragged t, tk and
//   d <= 128 are handled by masking, so the host pads nothing. The TPU
//   kernel's 128-wide MXU blocks and the wrapper's padding stay behind.
//
// Semantics of the masks (those of the dense reference
//   `ops/attention.py::dot_product_attention`): keys past the causal limit
//   or past tk take no weight; keys the causal rule allows but the kv mask
//   refuses score -1e30, so a row whose allowed keys are all refused
//   averages V over them instead of producing NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 16;            // query rows per block
constexpr int BK = 32;            // keys per shared-memory tile (one per lane)
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;  // query rows per warp
constexpr int DMAX = 128;
constexpr int KPAD = DMAX + 1;    // lane j reading row j, column c: bank (j + c) % 32

struct Strides {                  // element strides of the b, h and t axes
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename T, int DV>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ mask,
                 int H, int t, int tk, int d, Strides st, float scale,
                 int causal, int offset) {
  __shared__ float qs[BQ][DMAX];
  __shared__ float ks[BK][KPAD];
  __shared__ float vs[BK][KPAD];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  T* ob = o + b * st.o[0] + h * st.o[1];

  for (int i = threadIdx.x; i < BQ * d; i += blockDim.x) {
    const int r = i / d, c = i % d, row = q0 + r;
    qs[r][c] = row < t ? to_f(qb[row * st.q[2] + c]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][DV];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < DV; ++x) acc[r][x] = 0.f;
  }

  // the causal limit of the tile's last row bounds the key loop
  const int last_row = min(q0 + BQ, t) - 1;
  const int kv_end = causal ? min(tk, last_row + offset + 1) : tk;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < BK * d; i += blockDim.x) {
      const int j = i / d, c = i % d, key = k0 + j;
      const bool in = key < kv_end;
      ks[j][c] = in ? to_f(kb[key * st.k[2] + c]) : 0.f;
      vs[j][c] = in ? to_f(vb[key * st.v[2] + c]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool in = key < kv_end;
    const bool refused = mask != nullptr && !(in && mask[(long long)b * tk + key] > 0.5f);

    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = ks[lane][c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = fmaf(qs[warp * RPW + r][c], kc, s[r]);
    }

    float p[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = q0 + warp * RPW + r;
      float sr = -INFINITY;                      // no weight at all
      if (in && (!causal || key <= row + offset))
        sr = refused ? -1e30f : s[r] * scale;    // finite fill
      const float m_new = fmaxf(m[r], warp_max(sr));
      const bool none = m_new == -INFINITY;      // nothing allowed yet
      const float alpha = none ? 1.f : expf(m[r] - m_new);
      p[r] = none ? 0.f : expf(sr - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
      for (int x = 0; x < DV; ++x) acc[r][x] *= alpha;
      m[r] = m_new;
    }

    for (int j = 0; j < BK; ++j) {
      float pj[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        if (c < d) {
          const float vc = vs[j][c];
#pragma unroll
          for (int r = 0; r < RPW; ++r) acc[r][x] = fmaf(pj[r], vc, acc[r][x]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= t) continue;
    const float ll = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int x = 0; x < DV; ++x) {
      const int c = lane + 32 * x;
      if (c < d) store(&ob[row * st.o[2] + c], acc[r][x] / ll);
    }
    if (lane == 0) lse[(long long)bh * t + row] = m[r] + logf(ll);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const float* mask, int B, int H, int t, int tk,
                   int d, const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((t + BQ - 1) / BQ, B * H);
  const dim3 block(NWARPS * 32);
  const int offset = causal ? tk - t : 0;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  switch ((d + 31) / 32) {
    case 1: flash_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(qq, kk, vv, oo, lse, mask, H, t, tk, d, st, scale, causal, offset); break;
    case 2: flash_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(qq, kk, vv, oo, lse, mask, H, t, tk, d, st, scale, causal, offset); break;
    case 3: flash_fwd_kernel<T, 3><<<grid, block, 0, stream>>>(qq, kk, vv, oo, lse, mask, H, t, tk, d, st, scale, causal, offset); break;
    default: flash_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(qq, kk, vv, oo, lse, mask, H, t, tk, d, st, scale, causal, offset); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, t|tk, d] with element strides `strides` = (q b, h, t;
// k b, h, t; v b, h, t; o b, h, t) and unit stride on d. lse: f32 [B, H, t]
// contiguous. mask: f32 [B, tk] contiguous or null. dtype: 0 f32, 1 bf16.
// Returns the cudaError_t of the launch.
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
              const float* mask, int dtype, int B, int H, int t, int tk, int d,
              const long long* strides, float scale, int causal, void* stream) {
  if (d < 1 || d > DMAX || t < 1 || tk < 1 || B * H < 1 || B * H > 65535 ||
      (causal && t > tk))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, k, v, o, lse, mask, B, H, t, tk, d, st, scale, causal, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, k, v, o, lse, mask, B, H, t, tk, d, st, scale, causal, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* flash_fwd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

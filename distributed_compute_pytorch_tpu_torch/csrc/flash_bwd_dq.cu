// Flash attention backward, dQ, for Hopper (sm_90a), CUDA C++ with a plain C
// entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/flash_attention.py,
//   `_bwd_dq_kernel` (launched by `_flash_bwd`, the backward of the custom
//   VJPs `_flash` / `_flash_masked`). Given the forward's saved logsumexp
//   and delta = rowsum(dO * O) it recomputes p = exp(s - lse) per key tile,
//   dp = dO V^T, ds = p (dp - delta), and accumulates dQ = scale * ds K in
//   f32, with the forward's masks: bottom-right causal alignment (query row
//   i attends keys <= i + tk - t; keys past it take no weight) and the
//   [b, tk] key-validity mask's finite -1e30 fill.
//
// What bounds it on this card: three T x Tk x d products per head (s, dp,
//   ds K) against ~(2 t + 2 tk) * d elements of traffic, so at training
//   shapes (t = tk = 1024, d = 64) it is compute-bound in principle (989
//   TFLOP/s bf16 on the tensor cores). This first version does the products
//   with plain f32 FMAs on the CUDA cores (67 TFLOP/s f32 peak), as
//   flash_fwd.cu does, so FMA and shared-memory issue bound it. Tensor cores
//   (mma.sync / wgmma) are left to a later change.
//
// Design: the TPU kernel's sequential kv grid axis and its VMEM dq scratch
//   become a loop inside one thread block. A block owns a (batch*head, tile
//   of BQ = 16 query rows): it stages its Q and dO rows once in shared
//   memory as f32, then walks key tiles of BK = 32 (K and V staged as f32,
//   rows padded to an odd stride so lane j reading row j hits its own bank)
//   up to the causal limit of its last row. Four warps own RPW = 4 rows
//   each; inside a tile lane j owns key j for s and dp, and lane j owns dQ
//   columns j, j+32, ... for ds K, with each ds broadcast by a warp shuffle.
//   dQ stays in registers and is written once. Ragged t, tk and d <= 128
//   are masked in the kernel, so the host pads nothing; shared memory is
//   sized for the head dim (dynamic, above 48 KB only for d > 96).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 16;            // query rows per block
constexpr int BK = 32;            // keys per shared-memory tile (one per lane)
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;  // query rows per warp
constexpr int DMAX = 128;
constexpr float NEG_FILL = -1e30f;

struct Strides {                  // element strides of the b, h and t axes
  long long q[3], k[3], v[3], g[3], dq[3];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DV>
constexpr int smem_bytes() {
  // qs, gs [BQ][D]; ks, vs [BK][D + 1]
  return (2 * BQ * DV * 32 + 2 * BK * (DV * 32 + 1)) * static_cast<int>(sizeof(float));
}

template <typename T, int DV>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq,
                    int H, int t, int tk, int d, Strides st, float scale,
                    int causal, int offset) {
  constexpr int D = DV * 32;
  constexpr int KP = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][D]
  float* gs = qs + BQ * D;        // [BQ][D]
  float* ks = gs + BQ * D;        // [BK][KP]
  float* vs = ks + BK * KP;       // [BK][KP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const T* gb = g + b * st.g[0] + h * st.g[1];
  T* dqb = dq + b * st.dq[0] + h * st.dq[1];

  for (int i = threadIdx.x; i < BQ * d; i += blockDim.x) {
    const int r = i / d, c = i % d, row = q0 + r;
    const bool in = row < t;
    qs[r * D + c] = in ? to_f(qb[row * st.q[2] + c]) : 0.f;
    gs[r * D + c] = in ? to_f(gb[row * st.g[2] + c]) : 0.f;
  }

  float lse_r[RPW], delta_r[RPW], acc[RPW][DV];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    lse_r[r] = row < t ? lse[(long long)bh * t + row] : 0.f;
    delta_r[r] = row < t ? delta[(long long)bh * t + row] : 0.f;
#pragma unroll
    for (int x = 0; x < DV; ++x) acc[r][x] = 0.f;
  }

  // the causal limit of the tile's last row bounds the key loop
  const int last_row = min(q0 + BQ, t) - 1;
  const int kv_end = causal ? min(tk, last_row + offset + 1) : tk;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and qs, gs written)
    for (int i = threadIdx.x; i < BK * d; i += blockDim.x) {
      const int j = i / d, c = i % d, key = k0 + j;
      const bool in = key < kv_end;
      ks[j * KP + c] = in ? to_f(kb[key * st.k[2] + c]) : 0.f;
      vs[j * KP + c] = in ? to_f(vb[key * st.v[2] + c]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const bool in = key < kv_end;
    const bool refused = mask != nullptr && !(in && mask[(long long)b * tk + key] > 0.5f);

    float s[RPW], dp[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float kc = ks[lane * KP + c];
      const float vc = vs[lane * KP + c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        s[r] = fmaf(qs[(warp * RPW + r) * D + c], kc, s[r]);
        dp[r] = fmaf(gs[(warp * RPW + r) * D + c], vc, dp[r]);
      }
    }

    float ds[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = q0 + warp * RPW + r;
      float p = 0.f;                             // no weight at all
      if (in && row < t && (!causal || key <= row + offset))
        p = expf((refused ? NEG_FILL : s[r] * scale) - lse_r[r]);
      ds[r] = p * (dp[r] - delta_r[r]);
    }

    for (int j = 0; j < BK; ++j) {
      float dsj[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) dsj[r] = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        if (c < d) {
          const float kc = ks[j * KP + c];
#pragma unroll
          for (int r = 0; r < RPW; ++r) acc[r][x] = fmaf(dsj[r], kc, acc[r][x]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= t) continue;
#pragma unroll
    for (int x = 0; x < DV; ++x) {
      const int c = lane + 32 * x;
      if (c < d) store(&dqb[row * st.dq[2] + c], acc[r][x] * scale);
    }
  }
}

template <typename T, int DV>
cudaError_t launch_dv(const T* q, const T* k, const T* v, const T* g,
                      const float* lse, const float* delta, const float* mask,
                      T* dq, int B, int H, int t, int tk, int d,
                      const Strides& st, float scale, int causal,
                      cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((t + BQ - 1) / BQ, B * H);
  const int offset = causal ? tk - t : 0;
  flash_bwd_dq_kernel<T, DV><<<grid, NWARPS * 32, bytes, stream>>>(
      q, k, v, g, lse, delta, mask, dq, H, t, tk, d, st, scale, causal, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, const float* mask,
                   void* dq, int B, int H, int t, int tk, int d,
                   const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(g);
  T* out = static_cast<T*>(dq);
  switch ((d + 31) / 32) {
    case 1: return launch_dv<T, 1>(qq, kk, vv, gg, lse, delta, mask, out, B, H, t, tk, d, st, scale, causal, stream);
    case 2: return launch_dv<T, 2>(qq, kk, vv, gg, lse, delta, mask, out, B, H, t, tk, d, st, scale, causal, stream);
    case 3: return launch_dv<T, 3>(qq, kk, vv, gg, lse, delta, mask, out, B, H, t, tk, d, st, scale, causal, stream);
    default: return launch_dv<T, 4>(qq, kk, vv, gg, lse, delta, mask, out, B, H, t, tk, d, st, scale, causal, stream);
  }
}

}  // namespace

extern "C" {

// q, dO (g), dq: [B, H, t, d]; k, v: [B, H, tk, d]; element strides
// `strides` = (q b, h, t; k ...; v ...; g ...; dq ...) with unit stride on
// d. lse, delta: f32 [B, H, t] contiguous. mask: f32 [B, tk] contiguous or
// null. dtype: 0 f32, 1 bf16 (q, k, v, g, dq alike). Returns the
// cudaError_t of the launch.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, const float* mask,
                 void* dq, int dtype, int B, int H, int t, int tk, int d,
                 const long long* strides, float scale, int causal,
                 void* stream) {
  if (d < 1 || d > DMAX || t < 1 || tk < 1 || B * H < 1 || B * H > 65535 ||
      (causal && t > tk))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.g[i] = strides[9 + i];
    st.dq[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, k, v, g, lse, delta, mask, dq, B, H, t, tk, d, st, scale, causal, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, k, v, g, lse, delta, mask, dq, B, H, t, tk, d, st, scale, causal, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* flash_bwd_dq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

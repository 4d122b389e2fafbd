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
//   shapes it is compute-bound (19.35 GFLOP at [8, 12, 1024, 64] causal,
//   0.020 ms at 989 TFLOP/s bf16 on the tensor cores).
//
// Two kernels, and the wrapper (ops/flash_attention.py::_tensor_core_path)
// picks one by shape, dtype and alignment before it launches:
//
// * flash_bwd_dq_tc_kernel, the tensor-core path: bf16, d % 8 == 0, every
//   base pointer and b/h/t stride 16-byte aligned (every bf16 call of the
//   port's paths). A block owns TC_BQ = 64 query rows of one (batch, head),
//   four warps of 16 rows; Q and dO are loaded once into shared memory as
//   bf16, lse and delta into registers. It walks key tiles of TC_WK = 32 up
//   to the causal limit of its last row, streaming K and V by
//   cp.async into a double buffer while the previous tile is computed. Per
//   tile and warp, on mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by
//   ldmatrix: S = Q K^T; P = exp(scale S - lse) with the masks; dP = dO V^T;
//   dS = P (dP - delta); dQ += dS K with dS rounded to bf16 and taken
//   straight from the accumulator registers as the A operand and K read
//   through ldmatrix.trans. dQ stays in f32 registers and is written once.
//   Only a tile that crosses the causal diagonal or a ragged edge compares
//   positions. Under causal masking the last query tiles, which walk the
//   most keys, launch first. No atomics: two launches give the same bits.
//   Measured by chip_smoke.py at [8, 12, 1024, 64] bf16 causal on an NVIDIA
//   H100 80GB HBM3 at 700 W: 0.111 ms, 174 TFLOP/s, 18 % of the bound
//   (the CUDA-core kernel took 1.41 ms there).
// * flash_bwd_dq_kernel, the CUDA-core path and the f32 parity path: f32
//   (and any bf16 call outside the rule) with plain f32 FMAs, so the f32
//   train parity and tests keep an exact f32 product. A block owns a
//   (batch*head, tile of BQ = 16 query rows): it stages its Q and dO rows
//   once in shared memory as f32, then walks key tiles of BK = 32 (K and V
//   staged as f32, rows padded to an odd stride so lane j reading row j hits
//   its own bank) up to the causal limit of its last row. Four warps own
//   RPW = 4 rows each; inside a tile lane j owns key j for s and dp, and lane
//   j owns dQ columns j, j+32, ... for ds K, with each ds broadcast by a warp
//   shuffle. dQ stays in registers and is written once.
//
// Both replace the TPU kernel's sequential kv grid axis and its VMEM dq
// scratch by a loop inside one thread block. Ragged t, tk and d <= 128 are
// masked in the kernels, so the host pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_common.cuh"

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

// ---- the tensor-core path ---------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BQ = 64;  // query rows per block: four warps of 16
// Keys per walked tile: 32 keeps each of a warp's two 16 x 32 score tiles
// (S into P, dP into dS) at 16 registers a thread, so they fit beside dQ's
// accumulator at every head dim; 64-key tiles ran slower on the card.
constexpr int TC_WK = 32;

template <int DP>
constexpr int tc_smem_bytes() {
  constexpr int RS = DP + mma::PAD, WK = TC_WK;
  // qs, gs [TC_BQ][RS] and ks, vs [2][WK][RS], bf16
  return (2 * TC_BQ * RS + 4 * WK * RS) * 2;
}

template <int DP>
__global__ void MMA_LAUNCH_BOUNDS
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ mask, bf16* __restrict__ dq,
                       int H, int t, int tk, int d, Strides st, float scale,
                       int causal, int offset) {
  constexpr int RS = DP + mma::PAD;
  constexpr int WK = TC_WK;
  constexpr int NB = DP / 8;  // n8 blocks across the head dim
  constexpr int NK = WK / 8;  // n8 blocks across a key tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [TC_BQ][RS]
  bf16* gs = qs + TC_BQ * RS;                   // [TC_BQ][RS]
  bf16* ks = gs + TC_BQ * RS;                   // [2][WK][RS]
  bf16* vs = ks + 2 * WK * RS;                  // [2][WK][RS]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // under causal masking the last query tiles walk the most keys: first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TC_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  const bf16* gb = g + b * st.g[0] + h * st.g[1];
  bf16* dqb = dq + b * st.dq[0] + h * st.dq[1];

  // the causal limit of the tile's last row bounds the key loop
  const int last_row = min(q0 + TC_BQ, t) - 1;
  const int kv_end = causal ? min(tk, last_row + offset + 1) : tk;
  const int n_it = (kv_end + WK - 1) / WK;
  auto prefetch = [&](int it, int buf) {
    mma::load_tile<WK, DP>(ks + buf * WK * RS, kb, st.k[2], it * WK, kv_end, d);
    mma::load_tile<WK, DP>(vs + buf * WK * RS, vb, st.v[2], it * WK, kv_end, d);
  };
  mma::load_tile<TC_BQ, DP>(qs, qb, st.q[2], q0, t, d);
  mma::load_tile<TC_BQ, DP>(gs, gb, st.g[2], q0, t, d);
  prefetch(0, 0);
  mma::cp_async_commit();

  // this lane's two query rows: the C fragments' rows
  const int c2 = (lane % 4) * 2;
  const int row_lo = q0 + warp * 16 + lane / 4, row_hi = row_lo + 8;
  const float* lse_b = lse + (long long)bh * t;
  const float* delta_b = delta + (long long)bh * t;
  const float lse_lo = row_lo < t ? lse_b[row_lo] : 0.f;
  const float lse_hi = row_hi < t ? lse_b[row_hi] : 0.f;
  const float delta_lo = row_lo < t ? delta_b[row_lo] : 0.f;
  const float delta_hi = row_hi < t ? delta_b[row_hi] : 0.f;
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) prefetch(it + 1, buf ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * WK;
    const bf16* kt = ks + buf * WK * RS;
    const bf16* vt = vs + buf * WK * RS;

    float p[NK][4], ds[NK][4];
    mma::mma_abt<NK, DP, RS>(p, qs, warp * 16, kt);   // S = Q K^T
    mma::mma_abt<NK, DP, RS>(ds, gs, warp * 16, vt);  // dP = dO V^T
    // only a tile across the causal diagonal or a ragged edge compares
    const bool edge = q0 + TC_BQ > t || k0 + WK > tk ||
                      (causal && k0 + WK - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      bool refused[2] = {false, false};
      if (mask != nullptr) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int key = k0 + j * 8 + c2 + x;
          refused[x] = !(key < tk && mask[(long long)b * tk + key] > 0.5f);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + c2 + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float pe = __expf((refused[e & 1] ? NEG_FILL : p[j][e] * scale) -
                          (e < 2 ? lse_lo : lse_hi));
        if (edge && !(row < t && key < tk && (!causal || key <= row + offset)))
          pe = 0.f;                                  // no weight at all
        ds[j][e] = pe * (ds[j][e] - (e < 2 ? delta_lo : delta_hi));
      }
    }
    mma::mma_c_tile<NK, NB, RS>(acc, ds, kt);  // dQ += dS K
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = n * 8 + c2;
    if (col >= d) continue;
    if (row_lo < t)
      mma::store_bf16x2(dqb + row_lo * st.dq[2] + col, acc[n][0] * scale,
                        acc[n][1] * scale);
    if (row_hi < t)
      mma::store_bf16x2(dqb + row_hi * st.dq[2] + col, acc[n][2] * scale,
                        acc[n][3] * scale);
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      const float* mask, void* dq, int B, int H, int t,
                      int tk, int d, const Strides& st, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (t + TC_BQ - 1) / TC_BQ);
  const int offset = causal ? tk - t : 0;
  flash_bwd_dq_tc_kernel<DP><<<grid, mma::NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
      mask, static_cast<bf16*>(dq), H, t, tk, d, st, scale, causal, offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dO (g), dq: [B, H, t, d]; k, v: [B, H, tk, d]; element strides
// `strides` = (q b, h, t; k ...; v ...; g ...; dq ...) with unit stride on
// d. lse, delta: f32 [B, H, t] contiguous. mask: f32 [B, tk] contiguous or
// null. dtype: 0 f32, 1 bf16 (q, k, v, g, dq alike). tensor_cores: 1 takes
// the tensor-core kernel, which needs bf16, d % 8 == 0 and 16-byte aligned
// pointers and strides; 0 the CUDA-core kernel. Returns the cudaError_t of
// the launch.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                 const float* lse, const float* delta, const float* mask,
                 void* dq, int dtype, int B, int H, int t, int tk, int d,
                 const long long* strides, float scale, int causal,
                 int tensor_cores, void* stream) {
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
  if (tensor_cores) {
    const void* ptrs[] = {q, k, v, g, dq};
    if (dtype != 1 || !mma::tc_takes(d, ptrs, 5, strides, 15) ||
        (t + TC_BQ - 1) / TC_BQ > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    switch ((d + 31) / 32) {
      case 1: e = launch_tc<32>(q, k, v, g, lse, delta, mask, dq, B, H, t, tk, d, st, scale, causal, s); break;
      case 2: e = launch_tc<64>(q, k, v, g, lse, delta, mask, dq, B, H, t, tk, d, st, scale, causal, s); break;
      case 3: e = launch_tc<96>(q, k, v, g, lse, delta, mask, dq, B, H, t, tk, d, st, scale, causal, s); break;
      default: e = launch_tc<128>(q, k, v, g, lse, delta, mask, dq, B, H, t, tk, d, st, scale, causal, s); break;
    }
  } else if (dtype == 0) {
    e = launch<float>(q, k, v, g, lse, delta, mask, dq, B, H, t, tk, d, st, scale, causal, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, k, v, g, lse, delta, mask, dq, B, H, t, tk, d, st, scale, causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* flash_bwd_dq_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

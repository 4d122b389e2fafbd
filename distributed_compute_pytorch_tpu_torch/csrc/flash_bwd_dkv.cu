// Flash attention backward, dK and dV, for Hopper (sm_90a), CUDA C++ with a
// plain C entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/flash_attention.py,
//   `_bwd_dkv_kernel` (launched by `_flash_bwd`, the backward of the custom
//   VJPs `_flash` / `_flash_masked`). Given the forward's saved logsumexp
//   and delta = rowsum(dO * O) it recomputes p = exp(s - lse) per query
//   tile and accumulates dV = p^T dO and dK = scale * ds^T Q with
//   ds = p (dO V^T - delta), in f32, with the forward's masks: bottom-right
//   causal alignment (query row i attends keys <= i + tk - t) and the
//   [b, tk] key-validity mask's finite -1e30 fill.
//
// What bounds it on this card: four T x Tk x d products per head (s, dp,
//   p^T dO, ds^T Q) against ~(2 t + 4 tk) * d elements of traffic: compute-
//   bound in principle at training shapes (989 TFLOP/s bf16 on the tensor
//   cores). This first version does the products with plain f32 FMAs on the
//   CUDA cores (67 TFLOP/s f32 peak), so FMA, shuffle and shared-memory
//   issue bound it. Tensor cores (mma.sync / wgmma) are left to a later
//   change.
//
// Design: the TPU kernel's sequential q grid axis and its VMEM dk/dv scratch
//   become a loop inside one thread block, and the dQ / dK-dV split stays,
//   so no block ever writes another block's output and no atomics are
//   needed (the reasons of the Pallas file's docstring hold here too). A
//   block owns a (batch*head, tile of BKB = 32 keys), staged once in shared
//   memory as f32, and walks query tiles of BQT = 32 rows from the first
//   one its causal offset reaches ((qi+1)*Bq + offset > ki*Bk in the TPU
//   kernel) to the end. Four warps own KPW = 8 keys each, with their dK and
//   dV rows in registers (lane j owns columns j, j+32, ...), written once at
//   the end. Per query tile, lane i owns query row i for s and dp (Q and dO
//   rows padded to an odd stride so the lanes hit distinct banks), then
//   each row's p and ds are broadcast by warp shuffles into the column
//   sums. Ragged t, tk and d <= 128 are masked in the kernel; shared memory
//   is sized for the head dim (dynamic, above 48 KB for d > 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BKB = 32;            // keys per block
constexpr int BQT = 32;            // query rows per shared-memory tile (one per lane)
constexpr int NWARPS = 4;
constexpr int KPW = BKB / NWARPS;  // keys per warp
constexpr int DMAX = 128;
constexpr float NEG_FILL = -1e30f;

struct Strides {                   // element strides of the b, h and t axes
  long long q[3], k[3], v[3], g[3], dk[3], dv[3];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DV>
constexpr int smem_bytes() {
  // ks, vs [BKB][D]; qs, gs [BQT][D + 1]; lse, delta [BQT]
  return (2 * BKB * DV * 32 + 2 * BQT * (DV * 32 + 1) + 2 * BQT) *
         static_cast<int>(sizeof(float));
}

template <typename T, int DV>
__global__ void __launch_bounds__(NWARPS * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int t, int tk, int d,
                     Strides st, float scale, int causal, int offset) {
  constexpr int D = DV * 32;
  constexpr int QP = D + 1;
  extern __shared__ float smem[];
  float* ks = smem;                // [BKB][D]
  float* vs = ks + BKB * D;        // [BKB][D]
  float* qs = vs + BKB * D;        // [BQT][QP]
  float* gs = qs + BQT * QP;       // [BQT][QP]
  float* lse_s = gs + BQT * QP;    // [BQT]
  float* delta_s = lse_s + BQT;    // [BQT]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BKB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  const T* gb = g + b * st.g[0] + h * st.g[1];
  T* dkb = dk + b * st.dk[0] + h * st.dk[1];
  T* dvb = dv + b * st.dv[0] + h * st.dv[1];

  for (int i = threadIdx.x; i < BKB * d; i += blockDim.x) {
    const int j = i / d, c = i % d, key = k0 + j;
    const bool in = key < tk;
    ks[j * D + c] = in ? to_f(kb[key * st.k[2] + c]) : 0.f;
    vs[j * D + c] = in ? to_f(vb[key * st.v[2] + c]) : 0.f;
  }

  int kidx[KPW];
  bool kin[KPW], refused[KPW];
  float acc_k[KPW][DV], acc_v[KPW][DV];
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    kidx[kk] = k0 + warp * KPW + kk;
    kin[kk] = kidx[kk] < tk;
    refused[kk] = mask != nullptr &&
                  !(kin[kk] && mask[(long long)b * tk + kidx[kk]] > 0.5f);
#pragma unroll
    for (int x = 0; x < DV; ++x) acc_k[kk][x] = acc_v[kk][x] = 0.f;
  }

  // the first query row whose causal limit reaches this block's first key
  const int q_first = causal ? max(0, k0 - offset) : 0;

  for (int q0 = (q_first / BQT) * BQT; q0 < t; q0 += BQT) {
    __syncthreads();  // the previous tile is consumed (and ks, vs written)
    for (int i = threadIdx.x; i < BQT * d; i += blockDim.x) {
      const int r = i / d, c = i % d, row = q0 + r;
      const bool in = row < t;
      qs[r * QP + c] = in ? to_f(qb[row * st.q[2] + c]) : 0.f;
      gs[r * QP + c] = in ? to_f(gb[row * st.g[2] + c]) : 0.f;
    }
    if (threadIdx.x < BQT) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < t ? lse[(long long)bh * t + row] : 0.f;
      delta_s[threadIdx.x] = row < t ? delta[(long long)bh * t + row] : 0.f;
    }
    __syncthreads();

    const int row = q0 + lane;
    const bool rin = row < t;
    float s[KPW], dp[KPW];
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) s[kk] = dp[kk] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qc = qs[lane * QP + c];
      const float gc = gs[lane * QP + c];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        s[kk] = fmaf(qc, ks[(warp * KPW + kk) * D + c], s[kk]);
        dp[kk] = fmaf(gc, vs[(warp * KPW + kk) * D + c], dp[kk]);
      }
    }

    const float lse_i = lse_s[lane], delta_i = delta_s[lane];
    float p[KPW], ds[KPW];
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) {
      p[kk] = 0.f;                               // no weight at all
      if (rin && kin[kk] && (!causal || kidx[kk] <= row + offset))
        p[kk] = expf((refused[kk] ? NEG_FILL : s[kk] * scale) - lse_i);
      ds[kk] = p[kk] * (dp[kk] - delta_i);
    }

    const int rows = min(BQT, t - q0);
    for (int i = 0; i < rows; ++i) {
      float pi[KPW], dsi[KPW];
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        pi[kk] = __shfl_sync(0xffffffffu, p[kk], i);
        dsi[kk] = __shfl_sync(0xffffffffu, ds[kk], i);
      }
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        if (c < d) {
          const float gc = gs[i * QP + c];
          const float qc = qs[i * QP + c];
#pragma unroll
          for (int kk = 0; kk < KPW; ++kk) {
            acc_v[kk][x] = fmaf(pi[kk], gc, acc_v[kk][x]);
            acc_k[kk][x] = fmaf(dsi[kk], qc, acc_k[kk][x]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    if (!kin[kk]) continue;
#pragma unroll
    for (int x = 0; x < DV; ++x) {
      const int c = lane + 32 * x;
      if (c < d) {
        store(&dkb[kidx[kk] * st.dk[2] + c], acc_k[kk][x] * scale);
        store(&dvb[kidx[kk] * st.dv[2] + c], acc_v[kk][x]);
      }
    }
  }
}

template <typename T, int DV>
cudaError_t launch_dv(const T* q, const T* k, const T* v, const T* g,
                      const float* lse, const float* delta, const float* mask,
                      T* dk, T* dv, int B, int H, int t, int tk, int d,
                      const Strides& st, float scale, int causal,
                      cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((tk + BKB - 1) / BKB, B * H);
  const int offset = causal ? tk - t : 0;
  flash_bwd_dkv_kernel<T, DV><<<grid, NWARPS * 32, bytes, stream>>>(
      q, k, v, g, lse, delta, mask, dk, dv, H, t, tk, d, st, scale, causal, offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, const float* mask,
                   void* dk, void* dv, int B, int H, int t, int tk, int d,
                   const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* gg = static_cast<const T*>(g);
  T* ok = static_cast<T*>(dk);
  T* ov = static_cast<T*>(dv);
  switch ((d + 31) / 32) {
    case 1: return launch_dv<T, 1>(qq, kk, vv, gg, lse, delta, mask, ok, ov, B, H, t, tk, d, st, scale, causal, stream);
    case 2: return launch_dv<T, 2>(qq, kk, vv, gg, lse, delta, mask, ok, ov, B, H, t, tk, d, st, scale, causal, stream);
    case 3: return launch_dv<T, 3>(qq, kk, vv, gg, lse, delta, mask, ok, ov, B, H, t, tk, d, st, scale, causal, stream);
    default: return launch_dv<T, 4>(qq, kk, vv, gg, lse, delta, mask, ok, ov, B, H, t, tk, d, st, scale, causal, stream);
  }
}

}  // namespace

extern "C" {

// q, dO (g): [B, H, t, d]; k, v, dk, dv: [B, H, tk, d]; element strides
// `strides` = (q b, h, t; k ...; v ...; g ...; dk ...; dv ...) with unit
// stride on d. lse, delta: f32 [B, H, t] contiguous. mask: f32 [B, tk]
// contiguous or null. dtype: 0 f32, 1 bf16 (all tensors but lse, delta and
// mask alike). Returns the cudaError_t of the launch.
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, const float* mask,
                  void* dk, void* dv, int dtype, int B, int H, int t, int tk,
                  int d, const long long* strides, float scale, int causal,
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
    st.dk[i] = strides[12 + i];
    st.dv[i] = strides[15 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, k, v, g, lse, delta, mask, dk, dv, B, H, t, tk, d, st, scale, causal, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, k, v, g, lse, delta, mask, dk, dv, B, H, t, tk, d, st, scale, causal, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* flash_bwd_dkv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

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
//   bound at training shapes (25.79 GFLOP at [8, 12, 1024, 64] causal, 0.026
//   ms at 989 TFLOP/s bf16 on the tensor cores).
//
// Two kernels, and the wrapper (ops/flash_attention.py::_tensor_core_path)
// picks one by shape, dtype and alignment before it launches:
//
// * flash_bwd_dkv_tc_kernel, the tensor-core path: bf16, d % 8 == 0, every
//   base pointer and b/h/t stride 16-byte aligned (every bf16 call of the
//   port's paths). A block owns TC_BK = 64 keys of one (batch, head), four
//   warps of 16 keys; its K and V tiles stay in shared memory as bf16. It
//   walks query tiles of WQ = 64 rows (32 at d > 64, for registers) from the
//   first one its causal offset reaches; each tile's Q, dO, lse and delta
//   are streamed by cp.async into a double buffer while the previous tile
//   is computed. Per tile and warp, on mma.sync.m16n8k16 (bf16 in, f32
//   accumulate) fed by ldmatrix: S^T = K Q^T; P^T = exp(scale S^T - lse)
//   with the masks; dV += P^T dO with P^T rounded to bf16 and taken
//   straight from the accumulator registers as the A operand; dP^T =
//   V dO^T; dS^T = P^T (dP^T - delta); dK += dS^T Q. dK and dV stay in f32
//   registers and are written once. Only a tile that crosses the causal
//   diagonal or a ragged edge compares positions. Blocks are ordered so the
//   first key tiles, which walk the most queries, launch first. No atomics:
//   two launches give the same bits. Measured by chip_smoke.py at [8, 12,
//   1024, 64] bf16 causal on an NVIDIA H100 80GB HBM3 at 700 W: 0.160 ms,
//   161 TFLOP/s, 16 % of the bound (the CUDA-core kernel took 1.99 ms).
// * flash_bwd_dkv_kernel, the CUDA-core path and the f32 parity path: f32
//   (and any bf16 call outside the rule) with plain f32 FMAs, so the f32
//   train parity and tests keep an exact f32 product. A block owns a
//   (batch*head, tile of BKB = 32 keys), staged once in shared memory as
//   f32, and walks query tiles of BQT = 32 rows from the first one its
//   causal offset reaches ((qi+1)*Bq + offset > ki*Bk in the TPU kernel) to
//   the end. Four warps own KPW = 8 keys each, with their dK and dV rows in
//   registers (lane j owns columns j, j+32, ...), written once at the end.
//   Per query tile, lane i owns query row i for s and dp (Q and dO rows
//   padded to an odd stride so the lanes hit distinct banks), then each
//   row's p and ds are broadcast by warp shuffles into the column sums.
//
// Both keep the TPU kernel's split from dQ (no block writes another block's
// output; the reasons of the Pallas file's docstring hold here too). Ragged
// t, tk and d <= 128 are masked in the kernels: the host pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_common.cuh"

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

// ---- the tensor-core path ---------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BK = 64;  // keys per block: four warps of 16

// Query rows per walked tile: 64, or 32 at DP > 64, where the two 16 x DP
// f32 accumulators per warp leave too few registers for two 16 x 64
// score tiles.
__host__ __device__ constexpr int walk_tile(int dp) { return dp > 64 ? 32 : 64; }

template <int DP>
constexpr int tc_smem_bytes() {
  constexpr int RS = DP + mma::PAD, WQ = walk_tile(DP);
  // ks, vs [TC_BK][RS] and qs, gs [2][WQ][RS] bf16; lse, delta [2][WQ] f32
  return (2 * TC_BK * RS + 4 * WQ * RS) * 2 + 4 * WQ * 4;
}

template <int DP>
__global__ void MMA_LAUNCH_BOUNDS
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ mask, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int t, int tk, int d,
                        Strides st, float scale, int causal, int offset) {
  constexpr int RS = DP + mma::PAD;
  constexpr int WQ = walk_tile(DP);
  constexpr int NB = DP / 8;  // n8 blocks across the head dim
  constexpr int NQ = WQ / 8;  // n8 blocks across a query tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);                // [TC_BK][RS]
  bf16* vs = ks + TC_BK * RS;                                 // [TC_BK][RS]
  bf16* qs = vs + TC_BK * RS;                                 // [2][WQ][RS]
  bf16* gs = qs + 2 * WQ * RS;                                // [2][WQ][RS]
  float* lse_s = reinterpret_cast<float*>(gs + 2 * WQ * RS);  // [2][WQ]
  float* delta_s = lse_s + 2 * WQ;                            // [2][WQ]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * TC_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  const bf16* gb = g + b * st.g[0] + h * st.g[1];
  bf16* dkb = dk + b * st.dk[0] + h * st.dk[1];
  bf16* dvb = dv + b * st.dv[0] + h * st.dv[1];
  const float* lse_b = lse + (long long)bh * t;
  const float* delta_b = delta + (long long)bh * t;

  // from the first query tile whose causal limit reaches this block's keys
  const int it0 = (causal ? max(0, k0 - offset) : 0) / WQ;
  const int n_it = (t + WQ - 1) / WQ;
  auto prefetch = [&](int it, int buf) {
    const int q0 = it * WQ;
    mma::load_tile<WQ, DP>(qs + buf * WQ * RS, qb, st.q[2], q0, t, d);
    mma::load_tile<WQ, DP>(gs + buf * WQ * RS, gb, st.g[2], q0, t, d);
    mma::load_row_values(lse_s + buf * WQ, lse_b, q0, t, WQ, 0);
    mma::load_row_values(delta_s + buf * WQ, delta_b, q0, t, WQ, WQ);
  };
  mma::load_tile<TC_BK, DP>(ks, kb, st.k[2], k0, tk, d);
  mma::load_tile<TC_BK, DP>(vs, vb, st.v[2], k0, tk, d);
  prefetch(it0, 0);
  mma::cp_async_commit();

  // this lane's two keys: the C fragments' rows
  const int c2 = (lane % 4) * 2;
  const int key_lo = k0 + warp * 16 + lane / 4, key_hi = key_lo + 8;
  const bool ref_lo = mask != nullptr &&
      !(key_lo < tk && mask[(long long)b * tk + key_lo] > 0.5f);
  const bool ref_hi = mask != nullptr &&
      !(key_hi < tk && mask[(long long)b * tk + key_hi] > 0.5f);
  float acc_k[NB][4], acc_v[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = it0; it < n_it; ++it) {
    const int buf = (it - it0) & 1;
    if (it + 1 < n_it) prefetch(it + 1, buf ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const int q0 = it * WQ;
    const bf16* qt = qs + buf * WQ * RS;
    const bf16* gt = gs + buf * WQ * RS;
    const float* lse_t = lse_s + buf * WQ;
    const float* delta_t = delta_s + buf * WQ;

    float p[NQ][4], ds[NQ][4];
    mma::mma_abt<NQ, DP, RS>(p, ks, warp * 16, qt);   // S^T = K Q^T
    mma::mma_abt<NQ, DP, RS>(ds, vs, warp * 16, gt);  // dP^T = V dO^T
    // only a tile across the causal diagonal or a ragged edge compares
    const bool edge = q0 + WQ > t || k0 + TC_BK > tk ||
                      (causal && k0 + TC_BK - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + c2 + (e & 1);
        const int row = q0 + col;
        const int key = e < 2 ? key_lo : key_hi;
        const bool refused = e < 2 ? ref_lo : ref_hi;
        float pe = __expf((refused ? NEG_FILL : p[j][e] * scale) - lse_t[col]);
        if (edge && !(row < t && key < tk && (!causal || key <= row + offset)))
          pe = 0.f;                                  // no weight at all
        p[j][e] = pe;
        ds[j][e] = pe * (ds[j][e] - delta_t[col]);
      }
    }
    mma::mma_c_tile<NQ, NB, RS>(acc_v, p, gt);   // dV += P^T dO
    mma::mma_c_tile<NQ, NB, RS>(acc_k, ds, qt);  // dK += dS^T Q
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = n * 8 + c2;
    if (col >= d) continue;
    if (key_lo < tk) {
      mma::store_bf16x2(dkb + key_lo * st.dk[2] + col, acc_k[n][0] * scale,
                        acc_k[n][1] * scale);
      mma::store_bf16x2(dvb + key_lo * st.dv[2] + col, acc_v[n][0], acc_v[n][1]);
    }
    if (key_hi < tk) {
      mma::store_bf16x2(dkb + key_hi * st.dk[2] + col, acc_k[n][2] * scale,
                        acc_k[n][3] * scale);
      mma::store_bf16x2(dvb + key_hi * st.dv[2] + col, acc_v[n][2], acc_v[n][3]);
    }
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* g, const float* lse, const float* delta,
                      const float* mask, void* dk, void* dv, int B, int H,
                      int t, int tk, int d, const Strides& st, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  // blockIdx.y = key tile: the first (heaviest, under causal) launch first
  const dim3 grid(B * H, (tk + TC_BK - 1) / TC_BK);
  const int offset = causal ? tk - t : 0;
  flash_bwd_dkv_tc_kernel<DP><<<grid, mma::NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
      mask, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, t, tk, d, st,
      scale, causal, offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, dO (g): [B, H, t, d]; k, v, dk, dv: [B, H, tk, d]; element strides
// `strides` = (q b, h, t; k ...; v ...; g ...; dk ...; dv ...) with unit
// stride on d. lse, delta: f32 [B, H, t] contiguous. mask: f32 [B, tk]
// contiguous or null. dtype: 0 f32, 1 bf16 (all tensors but lse, delta and
// mask alike). tensor_cores: 1 takes the tensor-core kernel, which needs
// bf16, d % 8 == 0 and 16-byte aligned pointers and strides; 0 the CUDA-core
// kernel. Returns the cudaError_t of the launch.
int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                  const float* lse, const float* delta, const float* mask,
                  void* dk, void* dv, int dtype, int B, int H, int t, int tk,
                  int d, const long long* strides, float scale, int causal,
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
    st.dk[i] = strides[12 + i];
    st.dv[i] = strides[15 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (tensor_cores) {
    const void* ptrs[] = {q, k, v, g, dk, dv};
    if (dtype != 1 || !mma::tc_takes(d, ptrs, 6, strides, 18) ||
        (tk + TC_BK - 1) / TC_BK > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    switch ((d + 31) / 32) {
      case 1: e = launch_tc<32>(q, k, v, g, lse, delta, mask, dk, dv, B, H, t, tk, d, st, scale, causal, s); break;
      case 2: e = launch_tc<64>(q, k, v, g, lse, delta, mask, dk, dv, B, H, t, tk, d, st, scale, causal, s); break;
      case 3: e = launch_tc<96>(q, k, v, g, lse, delta, mask, dk, dv, B, H, t, tk, d, st, scale, causal, s); break;
      default: e = launch_tc<128>(q, k, v, g, lse, delta, mask, dk, dv, B, H, t, tk, d, st, scale, causal, s); break;
    }
  } else if (dtype == 0) {
    e = launch<float>(q, k, v, g, lse, delta, mask, dk, dv, B, H, t, tk, d, st, scale, causal, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, k, v, g, lse, delta, mask, dk, dv, B, H, t, tk, d, st, scale, causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* flash_bwd_dkv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

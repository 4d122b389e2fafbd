// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/flash_attention.py,
//   `_fwd_kernel` (launched by `_flash_fwd`, public `flash_attention`).
//   Forward only: softmax(Q K^T * scale + mask) V with an online softmax in
//   f32, bottom-right causal alignment (query row i attends keys
//   <= i + tk - t), an optional [b, tk] key-validity mask with the finite
//   -1e30 fill, and the logsumexp lse = m + log(max(l, 1e-30)) in f32
//   [b, h, t], the residual the two backward kernels read.
//
// What bounds it on this card: two t x tk x d products per head against
//   ~(2 t + 2 tk) * d elements of traffic, so at the port's shapes it is
//   compute-bound in principle (12.9 GFLOP at [8, 12, 1024, 64] causal,
//   0.013 ms at 989 TFLOP/s bf16 on the tensor cores) and its byte bound
//   (q, k, v read and o written once) is the larger only at small t.
//
// Two kernels, and the wrapper (ops/flash_attention.py::_tensor_core_path)
// picks one by shape, dtype and alignment before it launches:
//
// * flash_fwd_tc_kernel, the tensor-core path: bf16, d % 8 == 0, every base
//   pointer and b/h/t stride 16-byte aligned (every bf16 call of the port's
//   paths). A block owns TC_BQ = 64 query rows of one (batch, head), four
//   warps of 16 rows: the rows of one mma.sync.m16n8k16 C fragment. Q is
//   copied once by cp.async and then held as A fragments in registers for
//   the whole key walk. K and V stream by cp.async through two buffers of
//   TC_WK = 64-key tiles (and the kv mask's values for each tile beside
//   it), the next tile landing while this one is computed, one barrier
//   per tile, up to the causal limit of the block's last row; a
//   warp skips the tiles past its own rows' limit. Per tile and warp, on
//   the tensor cores (bf16 in, f32 accumulate) fed by ldmatrix: S = Q K^T;
//   the online softmax on the C fragments in log2 units (scale * log2(e)
//   folded into one multiply, ex2.approx; row max and sum across the four
//   lanes of a quad; only a tile that crosses the warp's causal diagonal or
//   the tk edge compares positions); O = O * 2^(m_old - m_new) + P V with P
//   rounded to bf16 in registers and taken straight from the score
//   accumulators as the A operand (the reference's `p.astype(v.dtype)`), V
//   read through ldmatrix.trans. O stays in f32 registers and is written
//   once, O / l as bf16 pairs, and lse in natural-log units. Under causal
//   masking the last query tiles, which walk the most keys, launch first.
//   No atomics: two launches give the same bits.
// * flash_fwd_kernel, the CUDA-core path and the f32 parity path: f32 (and
//   any bf16 call outside the rule) with plain f32 FMAs, keeping P in f32.
//   One block per (batch*head, tile of BQ = 16 query rows), four warps,
//   each owning RPW = 4 rows and their online-softmax state in registers.
//   The block loops over key tiles of BK = 32, staged in shared memory as
//   f32, and stops at the causal limit of its last row. Inside a tile lane
//   j owns key j for the scores (rows of the K tile are padded to 129
//   floats so the 32 lanes hit 32 banks), and lane j owns output columns j,
//   j+32, ... for the P V product, with each p broadcast by a warp shuffle.
//
// Both replace the TPU kernel's sequential kv grid axis and its VMEM
// accumulators by a loop inside one thread block. Ragged t, tk and
// d <= 128 are masked in the kernels, so the host pads nothing.
//
// Semantics of the masks (those of the dense reference
//   `ops/attention.py::dot_product_attention`): keys past the causal limit
//   or past tk take no weight; keys the causal rule allows but the kv mask
//   refuses score -1e30, so a row whose allowed keys are all refused
//   averages V over them instead of producing NaN. A row with nothing
//   allowed yet keeps m = -inf and weights nothing; a pad row (row >= t)
//   stores nothing.

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
constexpr int KPAD = DMAX + 1;    // lane j reading row j, column c: bank (j + c) % 32
constexpr float NEG_FILL = -1e30f;

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
        sr = refused ? NEG_FILL : s[r] * scale;  // finite fill
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

// ---- the tensor-core path ---------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BQ = 64;  // query rows per block: four warps of 16
constexpr int TC_WK = 64;  // keys per walked tile, double-buffered
static_assert(TC_WK % 16 == 0 && TC_WK <= mma::NTHREADS, "whole k16 steps");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
constexpr int tc_smem_bytes() {
  constexpr int RS = DP + mma::PAD;
  // qs [TC_BQ][RS] and ks, vs [2][TC_WK][RS] bf16; the mask values
  // [2][TC_WK] f32
  return (TC_BQ * RS + 2 * 2 * TC_WK * RS) * 2 + 2 * TC_WK * 4;
}

// at d <= 64 the register cap lets three blocks share an SM without a
// spill; a wider head keeps one
template <int DP>
__global__ void __launch_bounds__(mma::NTHREADS, DP <= 64 ? 3 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, const float* __restrict__ mask,
                    int H, int t, int tk, int d, Strides st, float scale,
                    int causal, int offset) {
  constexpr int RS = DP + mma::PAD;
  constexpr int WK = TC_WK;
  constexpr int NB = DP / 8;  // n8 blocks across the head dim
  constexpr int NK = WK / 8;  // n8 blocks across a key tile
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);                 // [TC_BQ][RS]
  bf16* ks = qs + TC_BQ * RS;                                  // [2][WK][RS]
  bf16* vs = ks + 2 * WK * RS;                                 // [2][WK][RS]
  float* ms = reinterpret_cast<float*>(vs + 2 * WK * RS);      // [2][WK]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  // under causal masking the last query tiles walk the most keys: first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TC_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + b * st.q[0] + h * st.q[1];
  const bf16* kb = k + b * st.k[0] + h * st.k[1];
  const bf16* vb = v + b * st.v[0] + h * st.v[1];
  bf16* ob = o + b * st.o[0] + h * st.o[1];
  const float* mask_b = mask == nullptr ? nullptr : mask + (long long)b * tk;

  // the block walks keys to the causal limit of its last row; a warp
  // computes only to the limit of its own last row (nothing past t)
  const int last_row = min(q0 + TC_BQ, t) - 1;
  const int kv_end = causal ? min(tk, last_row + offset + 1) : tk;
  const int w0 = q0 + warp * 16;  // this warp's first row
  const int w_end = w0 >= t ? 0
                    : causal ? min(tk, min(w0 + 16, t) + offset) : tk;
  const int n_it = (kv_end + WK - 1) / WK;
  // tile `it` goes to buffer it % 2, one cp.async group per tile (the
  // first with Q)
  auto prefetch = [&](int it) {
    const int slot = it % 2;
    mma::load_tile<WK, DP>(ks + slot * WK * RS, kb, st.k[2], it * WK, kv_end, d);
    mma::load_tile<WK, DP>(vs + slot * WK * RS, vb, st.v[2], it * WK, kv_end, d);
    if (mask_b != nullptr)
      mma::load_row_values(ms + slot * WK, mask_b, it * WK, tk, WK, 0);
    mma::cp_async_commit();
  };
  mma::load_tile<TC_BQ, DP>(qs, qb, st.q[2], q0, t, d);
  prefetch(0);  // n_it >= 1: kv_end >= 1 (t <= tk under causal masking)
  mma::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[DP / 16][4];  // this warp's 16 query rows, for the whole walk
  mma::ldsm_a_rows<DP, RS>(qa, qs, warp * 16);

  // this lane's two query rows (the C fragments' rows) and their softmax
  // state, in log2 units (scores times scale * log2(e)); l holds this
  // lane's share of a row's sum until the quad adds it up
  const int c2 = (lane % 4) * 2;
  const int row_lo = w0 + lane / 4;
  const float sl2 = scale * LOG2E, fill = NEG_FILL * LOG2E;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it > 0) {
      mma::cp_async_wait<0>();  // tile `it` has landed
      __syncthreads();  // for every thread; and buffer (it + 1) % 2 is free
    }
    if (it + 1 < n_it) prefetch(it + 1);  // lands while this tile computes
    const int k0 = it * WK;
    if (k0 >= w_end) continue;  // past this warp's causal limit
    const int slot = it % 2;
    const bf16* kt = ks + slot * WK * RS;
    const bf16* vt = vs + slot * WK * RS;
    const float* mt = ms + slot * WK;

    float s[NK][4];
    mma::mma_abt_regs<NK, DP, RS>(s, qa, kt);  // S = Q K^T
    // only a tile across this warp's causal diagonal or the tk edge
    // compares positions
    const bool edge = k0 + WK > tk || (causal && k0 + WK - 1 > w0 + offset);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      bool refused[2] = {false, false};
      if (mask_b != nullptr) {
        refused[0] = !(mt[j * 8 + c2] > 0.5f);
        refused[1] = !(mt[j * 8 + c2 + 1] > 0.5f);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + c2 + (e & 1);
        const int row = row_lo + (e >> 1) * 8;
        float x = refused[e & 1] ? fill : s[j][e] * sl2;  // finite fill
        if (edge && !(key < tk && (!causal || key <= row + offset)))
          x = -INFINITY;                                   // no weight at all
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = mx[r];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x);
      // a row with nothing allowed yet keeps m = -inf and weights nothing
      const bool none = m_new == -INFINITY;
      const float alpha = none ? 1.f : fast_exp2(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = none ? 0.f : fast_exp2(s[j][e] - m_new);
          sum += s[j][e];
        }
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    // O += P V, P rounded to bf16 (the reference's p.astype(v.dtype))
    mma::mma_c_tile<NK, NB, RS>(acc, s, vt);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float ll = l[r];
    ll += __shfl_xor_sync(0xffffffffu, ll, 1);
    ll += __shfl_xor_sync(0xffffffffu, ll, 2);
    ll = fmaxf(ll, 1e-30f);
    const int row = row_lo + r * 8;
    if (row >= t) continue;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int col = n * 8 + c2;
      if (col < d)
        mma::store_bf16x2(ob + row * st.o[2] + col, acc[n][2 * r] / ll,
                          acc[n][2 * r + 1] / ll);
    }
    // back to natural-log units; a row whose allowed keys are all refused
    // keeps the exact -1e30 fill, as the reference's lse does, so that the
    // backward's exp(s - lse) weights those keys alike
    const float m_nat = m[r] == fill ? NEG_FILL : m[r] * LN2;
    if (lane % 4 == 0) lse[(long long)bh * t + row] = m_nat + logf(ll);
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, const float* mask, int B, int H, int t,
                      int tk, int d, const Strides& st, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (t + TC_BQ - 1) / TC_BQ);
  const int offset = causal ? tk - t : 0;
  flash_fwd_tc_kernel<DP><<<grid, mma::NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, mask, H, t,
      tk, d, st, scale, causal, offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H, t|tk, d] with element strides `strides` = (q b, h, t;
// k b, h, t; v b, h, t; o b, h, t) and unit stride on d. lse: f32 [B, H, t]
// contiguous. mask: f32 [B, tk] contiguous or null. dtype: 0 f32, 1 bf16.
// tensor_cores: 1 takes the tensor-core kernel, which needs bf16,
// d % 8 == 0 and 16-byte aligned pointers and strides; 0 the CUDA-core
// kernel. Returns the cudaError_t of the launch.
int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
              const float* mask, int dtype, int B, int H, int t, int tk, int d,
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
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (tensor_cores) {
    const void* ptrs[] = {q, k, v, o};
    if (dtype != 1 || !mma::tc_takes(d, ptrs, 4, strides, 12) ||
        (t + TC_BQ - 1) / TC_BQ > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    switch ((d + 31) / 32) {
      case 1: e = launch_tc<32>(q, k, v, o, lse, mask, B, H, t, tk, d, st, scale, causal, s); break;
      case 2: e = launch_tc<64>(q, k, v, o, lse, mask, B, H, t, tk, d, st, scale, causal, s); break;
      case 3: e = launch_tc<96>(q, k, v, o, lse, mask, B, H, t, tk, d, st, scale, causal, s); break;
      default: e = launch_tc<128>(q, k, v, o, lse, mask, B, H, t, tk, d, st, scale, causal, s); break;
    }
  } else if (dtype == 0) {
    e = launch<float>(q, k, v, o, lse, mask, B, H, t, tk, d, st, scale, causal, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(q, k, v, o, lse, mask, B, H, t, tk, d, st, scale, causal, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* flash_fwd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

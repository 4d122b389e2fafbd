// Paged flash-decode read for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/decode_attention.py,
//   `_paged_kernel` (launched by `decode_attention_paged_pallas`). One query
//   token per (row, head) attends its row's logical cache slots
//   0..min(pos[b], nb * bt - 1) read straight from the block pool through the
//   row's block table, with an online softmax in f32. On the JAX side the
//   serving path computes the same read as `gather_kv_blocks` +
//   `cached_attention`, which first builds a gathered copy of every row's
//   cache; here no copy is built and only the live blocks are read.
//
// What bounds it on this card: HBM bytes. Each (row, kv head) reads
//   2 * live_keys * hd elements of K and V once and does ~4 G FLOPs per
//   element, far below the card's ~295 FLOP/byte balance point.
//
// Design: grid (row, kv head); the block serves the G query heads that share
//   the kv head, so each K and V row is read once for all of them. Four
//   warps split the row's live keys in chunks of 32 (chunk i goes to warp
//   i % 4); each warp keeps its own online softmax (m, l, acc) per query head
//   and the four are merged through shared memory at the end. Within a chunk
//   lane j owns key j: it looks its physical block up in the table and reads
//   the key row once, with 16-byte vector loads, for all G scores; then lane
//   j owns output columns j, j + 32, ... and reads each V row coalesced,
//   with p and the row offset broadcast by warp shuffles. The live length is
//   read from `pos` on the device, so the host never syncs and a short row
//   costs only its own blocks. The TPU kernel's packed-lane (hd == 64 pairs
//   into 128 lanes) layout stays behind.
//
// A parked row's table is all trash block, and its output is discarded by
//   the scheduler; it reads finite garbage and produces finite garbage.
//   Table entries outside [0, P) are clamped, as the reference's gather
//   clamps, so a bad table can never read outside the pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int DMAX = 128;
constexpr int GMAX = 8;  // query heads per kv head a block takes

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// s[g] += q_g . row over hd elements for the first ng of GT query heads
// (hd % 8 == 0, row 16-byte aligned): the row is read once for all heads
template <int GT>
__device__ __forceinline__ void row_dots(const float (*qs)[DMAX], const float* row,
                                         int hd, int ng, float* s) {
  for (int c = 0; c < hd; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < ng) {
        s[g] = fmaf(qs[g][c], x.x, s[g]);
        s[g] = fmaf(qs[g][c + 1], x.y, s[g]);
        s[g] = fmaf(qs[g][c + 2], x.z, s[g]);
        s[g] = fmaf(qs[g][c + 3], x.w, s[g]);
      }
    }
  }
}

template <int GT>
__device__ __forceinline__ void row_dots(const float (*qs)[DMAX], const __nv_bfloat16* row,
                                         int hd, int ng, float* s) {
  for (int c = 0; c < hd; c += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c);
    const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&u);
    float2 f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(pr[i]);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < ng) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[g] = fmaf(qs[g][c + 2 * i], f[i].x, s[g]);
          s[g] = fmaf(qs[g][c + 2 * i + 1], f[i].y, s[g]);
        }
      }
    }
  }
}

// GT: 1 for plain multi-head attention, else the largest group the block
// can hold (the first G of GT heads are live)
template <typename T, int DV, int GT>
__global__ void __launch_bounds__(NWARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, T* __restrict__ out,
                    const int* __restrict__ tables, const int* __restrict__ pos,
                    int G, int Hk, int P, int bt, int hd, int nb,
                    long long q_sb, long long q_sh, long long o_sb,
                    long long o_sh, float scale) {
  __shared__ float qs[GT][DMAX];
  __shared__ float red_m[NWARPS][GT], red_l[NWARPS][GT];
  __shared__ float red_acc[NWARPS][GT][DMAX];

  const int b = blockIdx.x, hk = blockIdx.y;
  const int ng = GT == 1 ? 1 : G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < ng * hd; i += blockDim.x) {
    const int g = i / hd, c = i % hd;
    qs[g][c] = to_f(q[b * q_sb + (hk * ng + g) * q_sh + c]);
  }
  __syncthreads();

  const int p = pos[b];
  const int n_keys = p < 0 ? 0 : min(p, nb * bt - 1) + 1;
  const int* trow = tables + (long long)b * nb;

  float m[GT], l[GT], acc[GT][DV];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int x = 0; x < DV; ++x) acc[g][x] = 0.f;
  }

  for (int k0 = warp * 32; k0 < n_keys; k0 += NWARPS * 32) {
    const int key = k0 + lane;
    const bool live = key < n_keys;
    long long row = 0;  // element offset of this key's row in one pool plane
    float s[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) s[g] = 0.f;
    if (live) {
      const int blk = min(max(trow[key / bt], 0), P - 1);
      row = (((long long)blk * Hk + hk) * bt + key % bt) * hd;
      row_dots<GT>(qs, kpool + row, hd, ng, s);
    }
    float pr[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < ng) {  // uniform across the block: the shuffles see every lane
        const float sg = live ? s[g] * scale : -INFINITY;
        // lane 0's key is live, so m_new is finite
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = expf(m[g] - m_new);
        pr[g] = expf(sg - m_new);
        l[g] = l[g] * alpha + warp_sum(pr[g]);
#pragma unroll
        for (int x = 0; x < DV; ++x) acc[g][x] *= alpha;
        m[g] = m_new;
      }
    }
    const int cnt = min(32, n_keys - k0);
    for (int j = 0; j < cnt; ++j) {
      const long long rj = __shfl_sync(0xffffffffu, row, j);
      const T* vr = vpool + rj;
      float vv[DV];
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        vv[x] = c < hd ? to_f(vr[c]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < ng) {
          const float pj = __shfl_sync(0xffffffffu, pr[g], j);
#pragma unroll
          for (int x = 0; x < DV; ++x) acc[g][x] = fmaf(pj, vv[x], acc[g][x]);
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < ng) {
      if (lane == 0) {
        red_m[warp][g] = m[g];
        red_l[warp][g] = l[g];
      }
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        if (c < hd) red_acc[warp][g][c] = acc[g][x];
      }
    }
  }
  __syncthreads();
  for (int g = warp; g < ng; g += NWARPS) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, red_m[w][g]);
    float L = 0.f, o[DV];
#pragma unroll
    for (int x = 0; x < DV; ++x) o[x] = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = red_m[w][g] == -INFINITY ? 0.f : expf(red_m[w][g] - M);
      L += red_l[w][g] * f;
#pragma unroll
      for (int x = 0; x < DV; ++x) {
        const int c = lane + 32 * x;
        if (c < hd) o[x] = fmaf(red_acc[w][g][c], f, o[x]);
      }
    }
    L = fmaxf(L, 1e-30f);
    T* orow = out + b * o_sb + (hk * ng + g) * o_sh;
#pragma unroll
    for (int x = 0; x < DV; ++x) {
      const int c = lane + 32 * x;
      if (c < hd) store(&orow[c], o[x] / L);
    }
  }
}

template <typename T, int GT>
void launch_g(const dim3& grid, cudaStream_t stream, const T* q, const T* kpool,
              const T* vpool, T* out, const int* tables, const int* pos, int G,
              int Hk, int P, int bt, int hd, int nb, const long long* st,
              float scale) {
  const dim3 block(NWARPS * 32);
  switch ((hd + 31) / 32) {
    case 1: paged_decode_kernel<T, 1, GT><<<grid, block, 0, stream>>>(q, kpool, vpool, out, tables, pos, G, Hk, P, bt, hd, nb, st[0], st[1], st[2], st[3], scale); break;
    case 2: paged_decode_kernel<T, 2, GT><<<grid, block, 0, stream>>>(q, kpool, vpool, out, tables, pos, G, Hk, P, bt, hd, nb, st[0], st[1], st[2], st[3], scale); break;
    case 3: paged_decode_kernel<T, 3, GT><<<grid, block, 0, stream>>>(q, kpool, vpool, out, tables, pos, G, Hk, P, bt, hd, nb, st[0], st[1], st[2], st[3], scale); break;
    default: paged_decode_kernel<T, 4, GT><<<grid, block, 0, stream>>>(q, kpool, vpool, out, tables, pos, G, Hk, P, bt, hd, nb, st[0], st[1], st[2], st[3], scale); break;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* pool, void* out, const int* tables,
                   const int* pos, int B, int Hq, int G, int P, int bt, int hd,
                   int nb, const long long* st, float scale, cudaStream_t stream) {
  const int Hk = Hq / G;
  const T* kpool = static_cast<const T*>(pool);
  const T* vpool = kpool + (long long)P * Hk * bt * hd;
  const dim3 grid(B, Hk);
  const T* qq = static_cast<const T*>(q);
  T* oo = static_cast<T*>(out);
  if (G == 1)
    launch_g<T, 1>(grid, stream, qq, kpool, vpool, oo, tables, pos, G, Hk, P, bt, hd, nb, st, scale);
  else
    launch_g<T, GMAX>(grid, stream, qq, kpool, vpool, oo, tables, pos, G, Hk, P, bt, hd, nb, st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [B, Hq, hd] with element strides (q b, q h) and unit stride on hd;
// query head h reads kv head h / G, G <= 8.
// pool: [2, P, Hq / G, bt, hd] contiguous, 16-byte aligned. out: [B, Hq, hd]
// with strides (o b, o h); strides = (q b, q h, o b, o h). tables: int32
// [B, nb] contiguous. pos: int32 [B]. hd % 8 == 0, hd <= 128. dtype: 0 f32,
// 1 bf16. Returns the cudaError_t of the launch.
int paged_decode(const void* q, const void* pool, void* out, const int* tables,
                 const int* pos, int dtype, int B, int Hq, int G, int P, int bt,
                 int hd, int nb, const long long* strides, float scale,
                 void* stream) {
  if (B < 1 || Hq < 1 || G < 1 || G > GMAX || Hq % G || Hq / G > 65535 ||
      P < 1 || bt < 1 || nb < 1 || hd < 8 || hd > DMAX || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(q, pool, out, tables, pos, B, Hq, G, P, bt, hd, nb, strides, scale, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(q, pool, out, tables, pos, B, Hq, G, P, bt, hd, nb, strides, scale, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

const char* paged_decode_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

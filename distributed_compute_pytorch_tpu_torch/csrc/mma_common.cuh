// Shared device code of the tensor-core flash kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu), Hopper (sm_90a): bf16 tiles streamed
// into shared memory with cp.async, read into mma.sync fragments with
// ldmatrix, multiplied on the tensor cores with f32 accumulation.
//
// Tiles live in shared memory row-major as [rows][DP + 8] bf16: DP is the
// head dim rounded up to 32, and the 16 bytes of padding shift each row by
// four banks, so the eight 16-byte rows that one ldmatrix phase reads hit
// 32 distinct banks. Columns d..DP are zero-filled by the copy (d % 8 == 0,
// so each 16-byte chunk is either all inside the head or all outside it),
// and so are rows past the tensor's end: a padded product adds exactly 0.
//
// The fragment layouts are those of mma.sync.m16n8k16 (row.col): lane l
// holds C/D elements (row l/4, cols 2*(l%4) + {0, 1}) in c[0..1] and the
// same columns of row l/4 + 8 in c[2..3]. Two adjacent n8 blocks of a C
// tile are, rounded to bf16, the A fragment of one k16 step of the next
// product (the FA2 register reuse of P and dS).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

constexpr int NTHREADS = 128;  // four warps
constexpr int PAD = 8;         // bf16 elements of padding per shared row

// The kernels' launch bounds: NTHREADS, and one block per SM suffices.
// With the default bound ptxas held some instantiations at 168 registers
// (three blocks an SM) and spilled; with this one none at d <= 64 spills.
#define MMA_LAUNCH_BOUNDS __launch_bounds__(mma::NTHREADS, 1)

// What the tensor-core kernels take (the wrapper's rule, checked again
// here): d % 8 == 0 and d <= 128, every base pointer 16-byte aligned, and
// every stride a multiple of 8 bf16 elements.
inline bool tc_takes(int d, const void* const* ptrs, int n_ptrs,
                     const long long* strides, int n_strides) {
  if (d % 8 != 0 || d > 128) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows row0 .. row0 + ROWS - 1 of a [n_rows][d] bf16 matrix (row
// stride `stride` elements, unit column stride) into a [ROWS][DP + PAD]
// shared tile; rows >= n_rows and columns >= d are zero-filled.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0,
                                          int n_rows, int d) {
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per row
  constexpr int RS = DP + PAD;
  static_assert((ROWS * CHUNKS) % NTHREADS == 0, "whole passes only");
#pragma unroll
  for (int pass = 0; pass < ROWS * CHUNKS / NTHREADS; ++pass) {
    const int i = pass * NTHREADS + threadIdx.x;
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const int row = row0 + r;
    const bool in = row < n_rows && c < d;
    cp_async16(dst + r * RS + c, in ? src + row * stride + c : src,
               in ? 16 : 0);
  }
}

// Copy n f32 values src[first .. first + n - 1] into dst[0 .. n - 1],
// zero past `limit`, with threads [lane0, lane0 + n).
__device__ __forceinline__ void load_row_values(float* dst, const float* src,
                                                int first, int limit, int n,
                                                int lane0) {
  const int i = static_cast<int>(threadIdx.x) - lane0;
  if (i >= 0 && i < n) {
    const bool in = first + i < limit;
    cp_async4(dst + i, in ? src + first + i : src, in ? 4 : 0);
  }
}

// A fragment (16 x 16, row-major) at rows row0.., cols k0.. of a tile.
template <int RS>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int k0) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* p = tile + (row0 + (lane & 15)) * RS + k0 + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p)));
}

// B fragments of two n8 blocks (n0.., n0 + 8..) x k16 (k0..) from a tile
// stored [n][k] (B = tile^T): b[0], b[1] for block n0, b[2], b[3] for n0+8.
template <int RS>
__device__ __forceinline__ void ldsm_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int n0,
                                          int k0) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* p =
      tile + (n0 + (lane & 7) + (lane >> 4) * 8) * RS + k0 + ((lane >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// The same fragments from a tile stored [k][n] (B = tile), transposed on
// the way by ldmatrix.trans.
template <int RS>
__device__ __forceinline__ void ldsm_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int k0,
                                          int n0) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* p =
      tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + n0 + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 step `s` of a product whose left operand is the
// 16 x (8 * NBLK) C tile `c`, rounded to bf16.
template <int NBLK>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[NBLK][4], int s) {
  a[0] = pack_bf16(c[2 * s][0], c[2 * s][1]);
  a[1] = pack_bf16(c[2 * s][2], c[2 * s][3]);
  a[2] = pack_bf16(c[2 * s + 1][0], c[2 * s + 1][1]);
  a[3] = pack_bf16(c[2 * s + 1][2], c[2 * s + 1][3]);
}

// acc (16 x 8 NB) += c (16 x 8 NBLK, rounded to bf16) times the tile
// stored [k][n] (rows k = the C tile's columns, n = 0 .. 8 NB).
template <int NBLK, int NB, int RS>
__device__ __forceinline__ void mma_c_tile(float (&acc)[NB][4],
                                           const float (&c)[NBLK][4],
                                           const __nv_bfloat16* tile) {
#pragma unroll
  for (int s = 0; s < NBLK / 2; ++s) {
    uint32_t a[4];
    c_to_a<NBLK>(a, c, s);
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t b[4];
      ldsm_b_kn<RS>(b, tile, s * 16, n * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// c (16 x 8 NBLK) = rows row0 .. row0 + 15 of tile `a_tile` (16 x DP)
// times the transpose of `b_tile` ([8 NBLK][DP]): one row of scores per
// (row, key) pair, summed over the head dim.
template <int NBLK, int DP, int RS>
__device__ __forceinline__ void mma_abt(float (&c)[NBLK][4],
                                        const __nv_bfloat16* a_tile, int row0,
                                        const __nv_bfloat16* b_tile) {
#pragma unroll
  for (int j = 0; j < NBLK; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int k = 0; k < DP; k += 16) {
    uint32_t a[4];
    ldsm_a<RS>(a, a_tile, row0, k);
#pragma unroll
    for (int j = 0; j < NBLK; j += 2) {
      uint32_t b[4];
      ldsm_b_nk<RS>(b, b_tile, j * 8, k);
      mma_bf16(c[j], a, b[0], b[1]);
      mma_bf16(c[j + 1], a, b[2], b[3]);
    }
  }
}

// The A fragments of rows row0 .. row0 + 15 of a 16 x DP tile, one per k16
// step, to hold in registers across many products (mma_abt_regs).
template <int DP, int RS>
__device__ __forceinline__ void ldsm_a_rows(uint32_t (&a)[DP / 16][4],
                                            const __nv_bfloat16* tile,
                                            int row0) {
#pragma unroll
  for (int k = 0; k < DP / 16; ++k) ldsm_a<RS>(a[k], tile, row0, k * 16);
}

// mma_abt with the left operand's A fragments already in registers.
template <int NBLK, int DP, int RS>
__device__ __forceinline__ void mma_abt_regs(float (&c)[NBLK][4],
                                             const uint32_t (&a)[DP / 16][4],
                                             const __nv_bfloat16* b_tile) {
#pragma unroll
  for (int j = 0; j < NBLK; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int k = 0; k < DP / 16; ++k) {
#pragma unroll
    for (int j = 0; j < NBLK; j += 2) {
      uint32_t b[4];
      ldsm_b_nk<RS>(b, b_tile, j * 8, k * 16);
      mma_bf16(c[j], a[k], b[0], b[1]);
      mma_bf16(c[j + 1], a[k], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float lo,
                                             float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

}  // namespace mma

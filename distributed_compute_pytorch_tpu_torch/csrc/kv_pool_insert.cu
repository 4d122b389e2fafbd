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
// What bounds it on this card: pure data movement. The live rows' bytes
//   read once and written once, plus 8 bytes of lookups (block id,
//   offset) a token row, over HBM's 3.35 TB/s; at decode sizes (16 rows *
//   12 heads * 64) the launch latency long before that.
//
// Design: one warp a token row, both planes, four warps a block. The warp
//   loads blocks[n] and offsets[n] once (one broadcast request), and a
//   dropped row's warp exits after that load. Its lanes cover (plane,
//   head, vector): an aligned group of G lanes (G a power of two, at most
//   32) takes one (plane, head) row of C = hd * esize / VB vectors, so a
//   warp moves 32 * VB bytes an instruction: at VB = 16, 512 bytes,
//   GPT-2's 24 bf16 rows of 128 bytes in six rounds, Llama's 8 in two.
//   Every load of a batch of up to eight rounds is issued (read-only
//   `ld.global.nc`) before the batch's first store, so several 16-byte
//   requests are in flight a lane. Offsets inside a warp are 32-bit (a
//   pool block's plane and an update row's heads each span less than 2
//   GiB, checked at launch); only the warp's row bases are 64-bit. A
//   lane's row and vector come from shifts, masks and one compare (the
//   plane): no division runs per element. The vector width VB (16, 8, 4
//   bytes or one element) is a template, chosen at launch from the
//   alignment of pool, k, v, their strides and hd * esize (`vec_bytes`):
//   every width is this one kernel. A warp a (token row, plane), twice
//   the warps with half the work each, timed slower on an H100 at the
//   admission and suffix shapes (bf16 0.0055 against 0.0052 ms at the
//   serve cell's first wave, Llama's 4 heads 0.0049 against 0.0037), and
//   faster only at the decode shape, which no path launches.
//   The update may be a strided view (the K/V slices of the fused QKV
//   projection): only the head dim needs unit stride, so the caller stacks
//   or copies nothing. The TPU kernel's 8/32-slot write windows (a Mosaic
//   tiling rule) stay behind: the card writes one slot directly.
//
// Why neither TMA nor `wgmma`: nothing is multiplied, and TMA copies whole
//   tiles between device and shared memory, where each row of this copy is
//   a 128-byte head row placed through a per-token lookup; staging through
//   shared memory would add a second trip for bytes that go straight from
//   one device address to another.
//
// Parked decode rows all point at the shared trash block, so several rows
//   may write the same trash slot in one launch. That race is benign: the
//   trash block is never attended, so whichever value lands is never read.
//
// The int8 form (`kv_pool_insert_q8`): the same Pallas kernel on the int8
//   pool {"kv": int8 [2, P, H, bt, hd], "scale": f32 [2, P, H, bt, 1]}
//   (serving's kv_dtype="int8"; the JAX package quantizes outside the
//   kernel, and its admission quantizes inside the XLA scatter). Here the
//   kernel takes the FLOAT rows and quantizes them as it writes, with the
//   same lane layout but a warp a (token row, plane): a row's quantizing
//   (conversion, the absmax's shuffles, a division an element) runs round
//   after round inside the warp, and a warp with both planes took 0.0108
//   ms at the serve cell's first wave against 0.0079 with one (bf16, an
//   H100; two runs whose old kernel timed alike). A group quantizes one head's row from its vector loads (8
//   lanes for bf16 at hd 64, four heads a round), the row's absmax reduced
//   in log2(G) xor shuffles (`q8::group_scale`), and each lane stores its
//   VB / esize int8 codes at once (8 bytes for bf16 at VB = 16), one lane
//   of the group the f32 scale. Bit for bit the
//   reference's `_q8` (quantize_common.cuh). hd <= 128. Bound: the float
//   rows read once, the int8 bytes and scales written once (bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "quantize_common.cuh"

namespace {

constexpr int WARPS = 4;   // warps a block

template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

template <int VB>
__device__ __forceinline__ typename Vec<VB>::type load_nc(const char* p) {
  return __ldg(reinterpret_cast<const typename Vec<VB>::type*>(p));
}

// The launch's geometry. Byte strides; the int8 form's pool rows are hd
// bytes, the float form's row_b.
struct Rows {
  int N, P, H, bt, hd;
  int C;          // vectors in one update row: hd * esize / VB
  int log2g;      // lanes a row: G = 1 << log2g = min(32, next power of 2 >= C)
  int np;         // passes of a group over its row: ceil(C / G)
  int row_b;      // bytes of one update row, hd * esize
  int src_h0, src_h1;           // bytes between two heads of k, of v
  long long src_n0, src_n1;     // bytes between two token rows of k, of v
};

// A lane's place in its warp: lane gl of a group of G lanes, the group
// taking rows r0, r0 + rpw, ... (rpw groups a warp)
struct Lanes {
  int G, rpw, gl, r0;
  __device__ __forceinline__ explicit Lanes(const Rows& g) {
    const int lane = threadIdx.x & 31;
    G = 1 << g.log2g;
    rpw = 32 >> g.log2g;
    gl = lane & (G - 1);
    r0 = lane >> g.log2g;
  }
};

__device__ __forceinline__ int warp_index() {
  return blockIdx.x * WARPS + (threadIdx.x >> 5);
}

__device__ __forceinline__ bool dropped(int blk, int off, const Rows& g) {
  return blk < 0 || blk >= g.P || off < 0 || off >= g.bt;
}

// The float write, a warp a token row and both its planes (rows r < H of
// k into plane 0, the rest of v into plane 1): bytes copied as they are,
// so one kernel a width serves f32 and bf16.
template <int VB>
__global__ void __launch_bounds__(32 * WARPS)
kv_pool_insert_kernel(char* __restrict__ pool, const char* __restrict__ k,
                      const char* __restrict__ v, const int* __restrict__ blocks,
                      const int* __restrict__ offsets, Rows g) {
  using V = typename Vec<VB>::type;
  constexpr int BATCH = 8;   // rounds whose loads a lane issues before a store
  const int n = warp_index();
  if (n >= g.N) return;
  const int blk = __ldg(blocks + n), off = __ldg(offsets + n);
  if (dropped(blk, off, g)) return;
  const Lanes l(g);
  const int head_b = g.bt * g.row_b;                  // a head's rows in a block
  char* const dst0 = pool + ((long long)blk * g.H * g.bt + off) * g.row_b;
  char* const dst1 = dst0 + (long long)g.P * g.H * head_b;
  const char* const src0 = k + n * g.src_n0;
  const char* const src1 = v + n * g.src_n1;
  const int rows = 2 * g.H;
  const int items = (rows + l.rpw - 1) / l.rpw * g.np;  // rounds x passes
  int r = l.r0, p = 0;                                   // this lane's row, pass
  for (int t = 0; t < items; t += BATCH) {
    V val[BATCH];
    int rr[BATCH], cc[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      rr[u] = r;
      cc[u] = l.gl + p * l.G;
      if (r < rows && cc[u] < g.C) {
        const int s = r >= g.H, h = r - s * g.H;
        val[u] = load_nc<VB>((s ? src1 : src0) + h * (s ? g.src_h1 : g.src_h0) +
                             cc[u] * VB);
      }
      if (++p == g.np) {
        p = 0;
        r += l.rpw;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (rr[u] < rows && cc[u] < g.C) {
        const int s = rr[u] >= g.H, h = rr[u] - s * g.H;
        *reinterpret_cast<V*>((s ? dst1 : dst0) + h * head_b + cc[u] * VB) = val[u];
      }
    }
  }
}

// `EV` int8 codes stored at once
template <int EV> struct Codes;
template <> struct Codes<8> { using type = uint2; };
template <> struct Codes<4> { using type = unsigned int; };
template <> struct Codes<2> { using type = unsigned short; };
template <> struct Codes<1> { using type = unsigned char; };

// the EV = VB / sizeof(T) elements of one loaded vector, as f32 (a bf16
// element converts exactly: its bits are the f32's upper half)
template <typename T, int VB>
__device__ __forceinline__ void to_floats(const typename Vec<VB>::type& raw,
                                          float* x) {
  if constexpr (VB == 2) {
    x[0] = __uint_as_float(static_cast<unsigned>(raw) << 16);
  } else {
    unsigned w[VB / 4];
    memcpy(w, &raw, VB);
#pragma unroll
    for (int i = 0; i < VB / static_cast<int>(sizeof(T)); ++i) {
      if constexpr (sizeof(T) == 4)
        x[i] = __uint_as_float(w[i]);
      else
        x[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
    }
  }
}

template <int EV>
__device__ __forceinline__ void store_codes(int8_t* dst, const float* x, float sc) {
  unsigned w[(EV + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < EV; ++i)
    w[i / 4] |= static_cast<unsigned>(static_cast<uint8_t>(q8::quantize_value(x[i], sc)))
                << (8 * (i % 4));
  typename Codes<EV>::type c;
  memcpy(&c, w, EV);
  *reinterpret_cast<typename Codes<EV>::type*>(dst) = c;
}

// The int8 write, a warp a (token row, plane): each group quantizes its
// head's row, a round at a time after the batch's loads. Every lane runs
// every round's shuffles (a round past the last head reduces zeros), so
// the reduction's mask is the whole warp.
template <typename T, int VB>
__global__ void __launch_bounds__(32 * WARPS)
kv_pool_insert_q8_kernel(int8_t* __restrict__ pool, float* __restrict__ scale,
                         const char* __restrict__ k, const char* __restrict__ v,
                         const int* __restrict__ blocks,
                         const int* __restrict__ offsets, Rows g) {
  using V = typename Vec<VB>::type;
  constexpr int BATCH = 4;   // rounds whose loads a lane issues before a store
  constexpr int EV = VB / static_cast<int>(sizeof(T));
  // passes a group makes over a row of hd <= 128 elements
  constexpr int NP = VB >= 4 * static_cast<int>(sizeof(T)) ? 1
                                                           : 4 * sizeof(T) / VB;
  const int w = warp_index(), n = w >> 1, s = w & 1;
  if (n >= g.N) return;
  const int blk = __ldg(blocks + n), off = __ldg(offsets + n);
  if (dropped(blk, off, g)) return;
  const Lanes l(g);
  const long long row0 = (s * (long long)g.P + blk) * g.H * g.bt + off;  // head 0
  int8_t* const dst = pool + row0 * g.hd;
  float* const sc_dst = scale + row0;
  const char* const src = (s ? v : k) + n * (s ? g.src_n1 : g.src_n0);
  const int src_h = s ? g.src_h1 : g.src_h0;
  for (int q = 0; q * l.rpw < g.H; q += BATCH) {
    V raw[BATCH][NP];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int h = l.r0 + (q + b) * l.rpw;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = l.gl + p * l.G;
        if (h < g.H && p < g.np && c < g.C)
          raw[b][p] = load_nc<VB>(src + h * src_h + c * VB);
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      if ((q + b) * l.rpw >= g.H) break;   // uniform across the warp
      const int h = l.r0 + (q + b) * l.rpw;
      float x[NP * EV];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = l.gl + p * l.G;
        if (h < g.H && p < g.np && c < g.C) {
          to_floats<T, VB>(raw[b][p], x + p * EV);
        } else {
#pragma unroll
          for (int i = 0; i < EV; ++i) x[p * EV + i] = 0.f;
        }
      }
      const float sc = q8::group_scale(x, l.G);
      if (h >= g.H) continue;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int c = l.gl + p * l.G;
        if (p < g.np && c < g.C)
          store_codes<EV>(dst + h * g.bt * g.hd + c * EV, x + p * EV, sc);
      }
      if (l.gl == 0) sc_dst[h * g.bt] = sc;
    }
  }
}

constexpr long long kMax32 = 2147483647LL;

// The widest vector, in bytes of the update, that every access of the
// launch can take: hd * esize a multiple of it, k and v and their
// strides aligned to it, and the pool aligned to what a vector fills
// there (the same bytes; the int8 form's VB / esize codes).
int choose_vec(const void* pool, const void* k, const void* v, int esize,
               bool q8, int hd, const long long* st) {
  for (int vb = 16; vb > esize; vb >>= 1) {
    const int pool_b = q8 ? vb / esize : vb;
    bool ok = (static_cast<long long>(hd) * esize) % vb == 0 &&
              reinterpret_cast<uintptr_t>(k) % vb == 0 &&
              reinterpret_cast<uintptr_t>(v) % vb == 0 &&
              reinterpret_cast<uintptr_t>(pool) % pool_b == 0;
    for (int i = 0; i < 4 && ok; ++i) ok = (st[i] * esize) % vb == 0;
    if (ok) return vb;
  }
  return esize;
}

// The geometry of a launch at vector width vb; false where a 32-bit offset
// inside a warp could overflow.
bool geometry(Rows& g, int N, int P, int H, int bt, int hd, int esize, int vb,
              bool q8, const long long* st) {
  g.N = N;
  g.P = P;
  g.H = H;
  g.bt = bt;
  g.hd = hd;
  g.row_b = hd * esize;
  g.C = g.row_b / vb;
  g.log2g = 0;
  while ((1 << g.log2g) < g.C && g.log2g < 5) ++g.log2g;
  g.np = (g.C + (1 << g.log2g) - 1) >> g.log2g;
  const long long sh[2] = {st[1] * esize, st[3] * esize};
  for (long long s : sh)
    if (s < 0 || (H - 1) * s + g.row_b > kMax32) return false;
  g.src_h0 = static_cast<int>(sh[0]);
  g.src_h1 = static_cast<int>(sh[1]);
  g.src_n0 = st[0] * esize;
  g.src_n1 = st[2] * esize;
  const long long block_b = static_cast<long long>(H) * bt * (q8 ? hd : g.row_b);
  return block_b <= kMax32 && 2LL * N <= kMax32;
}

unsigned grid_of(long long warps) {
  return static_cast<unsigned>((warps + WARPS - 1) / WARPS);
}

template <int VB>
cudaError_t launch_vec(void* pool, const void* k, const void* v, const int* blocks,
                       const int* offsets, const Rows& g, cudaStream_t stream) {
  kv_pool_insert_kernel<VB><<<grid_of(g.N), 32 * WARPS, 0, stream>>>(
      static_cast<char*>(pool), static_cast<const char*>(k),
      static_cast<const char*>(v), blocks, offsets, g);
  return cudaGetLastError();
}

template <typename T, int VB>
cudaError_t launch_q8_vec(void* pool, float* scale, const void* k, const void* v,
                          const int* blocks, const int* offsets, const Rows& g,
                          cudaStream_t stream) {
  kv_pool_insert_q8_kernel<T, VB><<<grid_of(2LL * g.N), 32 * WARPS, 0, stream>>>(
      static_cast<int8_t*>(pool), scale, static_cast<const char*>(k),
      static_cast<const char*>(v), blocks, offsets, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_q8(int vb, void* pool, float* scale, const void* k, const void* v,
                      const int* blocks, const int* offsets, const Rows& g,
                      cudaStream_t s) {
  switch (vb) {
    case 16: return launch_q8_vec<T, 16>(pool, scale, k, v, blocks, offsets, g, s);
    case 8: return launch_q8_vec<T, 8>(pool, scale, k, v, blocks, offsets, g, s);
    case 4: return launch_q8_vec<T, 4>(pool, scale, k, v, blocks, offsets, g, s);
    default: break;
  }
  if constexpr (sizeof(T) == 2)
    return launch_q8_vec<T, 2>(pool, scale, k, v, blocks, offsets, g, s);
  return cudaErrorInvalidValue;
}

int esize_of(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

}  // namespace

extern "C" {

// pool: [2, P, H, bt, hd] contiguous. k, v: [N, H, hd] with element strides
// strides = (k n, k h, v n, v h) and unit stride on hd. blocks, offsets:
// int32 [N] contiguous. dtype: 0 f32, 1 bf16. Returns the cudaError_t of the
// launch (N == 0 launches nothing; cudaErrorInvalidValue where a pool
// block's plane or an update row's heads span 2 GiB or more).
int kv_pool_insert(void* pool, const void* k, const void* v, const int* blocks,
                   const int* offsets, int dtype, int N, int P, int H, int bt,
                   int hd, const long long* strides, void* stream) {
  const int esize = esize_of(dtype);
  if (N < 0 || P < 1 || H < 1 || bt < 1 || hd < 1 || esize == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const int vb = choose_vec(pool, k, v, esize, false, hd, strides);
  Rows g;
  if (!geometry(g, N, P, H, bt, hd, esize, vb, false, strides))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (vb) {
    case 16: e = launch_vec<16>(pool, k, v, blocks, offsets, g, s); break;
    case 8: e = launch_vec<8>(pool, k, v, blocks, offsets, g, s); break;
    case 4: e = launch_vec<4>(pool, k, v, blocks, offsets, g, s); break;
    default: e = launch_vec<2>(pool, k, v, blocks, offsets, g, s); break;
  }
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
  const int esize = esize_of(dtype);
  if (N < 0 || P < 1 || H < 1 || bt < 1 || hd < 1 || hd > q8::DMAX || esize == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const int vb = choose_vec(pool, k, v, esize, true, hd, strides);
  Rows g;
  if (!geometry(g, N, P, H, bt, hd, esize, vb, true, strides))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? launch_q8<float>(vb, pool, scale, k, v, blocks, offsets, g, s)
      : launch_q8<__nv_bfloat16>(vb, pool, scale, k, v, blocks, offsets, g, s);
  return static_cast<int>(e);
}

// The vector width, in bytes of k and v, that a launch of the float form
// (q8 == 0) or of the int8 form (q8 != 0) on these arguments takes: 16, 8,
// 4 or one element. Launches nothing; 0 for an unknown dtype.
int kv_pool_insert_vec_bytes(const void* pool, const void* k, const void* v,
                             int dtype, int q8, int hd, const long long* strides) {
  const int esize = esize_of(dtype);
  if (esize == 0) return 0;
  return choose_vec(pool, k, v, esize, q8 != 0, hd, strides);
}

const char* kv_pool_insert_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

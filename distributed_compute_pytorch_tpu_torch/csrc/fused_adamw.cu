// Fused AdamW update for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces: distributed_compute_pytorch_tpu/ops/pallas/fused_adamw.py,
//   `_adamw_kernel` (launched once per parameter leaf by
//   `_fused_leaf_update`). One elementwise f32 pass: read g, p, mu, nu;
//   write p, mu, nu:
//     mu = b1 mu + (1 - b1) g
//     nu = b2 nu + (1 - b2) g^2
//     p -= lr (mu c1 / (sqrt(nu c2) + eps) + wd p)
//   with the per-step scalars [lr, wd, c1, c2] (c1 = 1/(1 - b1^t),
//   c2 = 1/(1 - b2^t)) read from a device f32 array, as the Pallas kernel
//   reads its [1, 4] scalar block `sc_ref`: the optimizer computes them on
//   the device from its int32 count (`ops/fused_adamw.py::scalars`, the
//   reference's `_scalars`), so a captured CUDA graph replays each step
//   with that step's values.
//
// The non-finite guard (the reference's `_guarded`, train/step.py): a
//   device flag `ok` (one byte, 0 or 1). When it is 0 the kernel writes
//   nothing, so p, mu and nu stay bit-untouched, as the reference's
//   `where` against the incoming state keeps them; either way the device
//   step count advances by `ok`, so a skipped update does not move the
//   schedule or the bias corrections.
//
// What bounds it on this card: bytes. 28 bytes per parameter (four f32
//   reads, three f32 writes) against about 15 FLOPs, far below the ~20
//   FLOPs per byte where f32 arithmetic would start to bound it; GPT-2-small
//   (124.4 M parameters) moves 3.48 GB, 1.04 ms at 3.35 TB/s.
//
// Design: the TPU kernel runs one pallas_call per leaf (148 for
//   GPT-2-small), each in VMEM-capped 2-D blocks. Here the optimizer keeps
//   params, grads, mu and nu in one flat f32 buffer each (the model's
//   parameters and their .grad are views into them), so ONE launch updates
//   every leaf: a grid-stride loop of 16-byte (float4) loads and stores,
//   consecutive threads on consecutive addresses, then a scalar tail. The
//   grid is a few waves of the SMs, enough loads in flight to reach HBM
//   rate; nothing is reused, so no shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Coef {
  float b1, omb1, b2, omb2, eps;
};

struct Hyper {
  float lr, wd, c1, c2, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adamw(float g, float& p, float& mu, float& nu,
                                      const Hyper& h) {
  mu = h.b1 * mu + h.omb1 * g;
  nu = h.b2 * nu + h.omb2 * g * g;
  const float update = mu * h.c1 / (sqrtf(nu * h.c2) + h.eps) + h.wd * p;
  p = p - h.lr * update;
}

__global__ void __launch_bounds__(256)
fused_adamw_kernel(const float* __restrict__ g, float* __restrict__ p,
                   float* __restrict__ mu, float* __restrict__ nu,
                   long long n, const float* __restrict__ sc, int* count,
                   const unsigned char* __restrict__ ok, Coef c) {
  // every thread reads the flag and the four scalars (one cached line);
  // one thread advances the count, which nothing else in the launch reads
  const int apply = ok[0] != 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *count += apply;
  if (!apply) return;
  const Hyper h{sc[0], sc[1], sc[2], sc[3], c.b1, c.omb1, c.b2, c.omb2, c.eps};
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(mu);
  float4* v4 = reinterpret_cast<float4*>(nu);
  for (long long i = first; i < n4; i += stride) {
    const float4 gg = g4[i];
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    adamw(gg.x, pp.x, mm.x, vv.x, h);
    adamw(gg.y, pp.y, mm.y, vv.y, h);
    adamw(gg.z, pp.z, mm.z, vv.z, h);
    adamw(gg.w, pp.w, mm.w, vv.w, h);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float pp = p[i], mm = mu[i], vv = nu[i];
    adamw(g[i], pp, mm, vv, h);
    p[i] = pp;
    mu[i] = mm;
    nu[i] = vv;
  }
}

}  // namespace

extern "C" {

// g, p, mu, nu: f32 [n] contiguous, 16-byte aligned; p, mu, nu updated in
// place. sc: device f32 [4] = [lr, wd, c1, c2]. count: a device int32
// advanced by ok. ok: a device byte, 0 (skip the update) or 1. omb1 = 1 - b1 and omb2 = 1 - b2 are
// rounded on the host, as the reference's Python-float arithmetic rounds
// them. Returns the cudaError_t of the launch.
int fused_adamw(const float* g, float* p, float* mu, float* nu, long long n,
                const float* sc, int* count, const unsigned char* ok,
                float b1, float omb1, float b2, float omb2, float eps,
                void* stream) {
  if (n < 1 || sc == nullptr || count == nullptr || ok == nullptr ||
      (reinterpret_cast<unsigned long long>(g) |
       reinterpret_cast<unsigned long long>(p) |
       reinterpret_cast<unsigned long long>(mu) |
       reinterpret_cast<unsigned long long>(nu)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (n / 4 + 255) / 256;
  const int blocks = static_cast<int>(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  const Coef c{b1, omb1, b2, omb2, eps};
  fused_adamw_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      g, p, mu, nu, n, sc, count, ok, c);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_adamw_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"

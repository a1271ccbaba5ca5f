// RG-LRU linear recurrence for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/rg_lru.py::rg_lru_pallas (the Pallas TPU
// kernel _rg_lru_kernel). Same function: h_t = a_t * h_{t-1} + gx_t,
// elementwise over channels, with an f32 carry; a, gx (B, S, D) and an
// optional h0 (B, D) in one dtype (float32 or bfloat16); outputs h (B, S, D)
// and h_last (B, D) in that dtype.
//
// What bounds it on this card: bytes. Each step is one multiply and one add
// per element against 6 bytes moved in bf16 (a and gx read, h written), so
// the bound is the 3.35 TB/s of device memory: 0.090 ms for the serving
// prefill shape (B=4, S=3072, D=4096, bf16). At decode (S=1) the work is a
// few hundred KB and the launch itself sets the time.
//
// Design, and what it does about the TPU kernel's shape:
//  * The TPU grid walks sequence blocks in order and carries h in VMEM
//    scratch from one grid step to the next. Blocks on Hopper run in no
//    order, so one thread owns one (b, channel) and loops over t itself;
//    the carry lives in a register for the whole sequence.
//  * The 256 threads of a block own 256 neighbouring channels, so each
//    timestep's loads and stores coalesce.
//  * Loads run ahead of the dependent chain: the thread holds the next U
//    timesteps of a and gx in registers while it computes the current U,
//    so memory latency hides behind the chain instead of stalling each step.
//  * No S % block_s or D % block_d restriction: the sequence tail and the
//    channel tail are guarded in the kernel.
//  * Rounding: each step is __fmul_rn then __fadd_rn, never a contracted
//    FMA, because the plain PyTorch version rounds the product before the
//    add; the kernel is then bit-identical to it.
//
// Known limit: one thread per (b, channel) gives B * D threads, 16384 at
// the serving shape, which fill only 64 blocks on 132 SMs. A chunked
// two-pass scan over S would add parallelism; that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;  // timesteps held in registers per chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a,
                                           const T* __restrict__ gx,
                                           size_t base, int t0, int S,
                                           int D, float (&ar)[U],
                                           float (&gr)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u;
    if (t < S) {
      const size_t i = base + (size_t)t * D;
      ar[u] = to_f32(a[i]);
      gr[u] = to_f32(gx[i]);
    } else {
      ar[u] = 0.f;
      gr[u] = 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ gx,
              const T* __restrict__ h0, T* __restrict__ h,
              T* __restrict__ h_last, int S, int D) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= D) return;
  const size_t base = (size_t)b * S * D + c;

  float carry = h0 ? to_f32(h0[(size_t)b * D + c]) : 0.f;
  float an[U], gn[U];
  load_chunk(a, gx, base, 0, S, D, an, gn);
  for (int t0 = 0; t0 < S; t0 += U) {
    float ac[U], gc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = an[u];
      gc[u] = gn[u];
    }
    if (t0 + U < S) load_chunk(a, gx, base, t0 + U, S, D, an, gn);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        carry = __fadd_rn(__fmul_rn(ac[u], carry), gc[u]);
        store(&h[base + (size_t)t * D], carry);
      }
    }
  }
  store(&h_last[(size_t)b * D + c], carry);
}

template <typename T>
int launch(const void* a, const void* gx, const void* h0, void* h,
           void* h_last, int B, int S, int D, cudaStream_t stream) {
  dim3 grid((D + THREADS - 1) / THREADS, B);
  rg_lru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(gx),
      static_cast<const T*>(h0), static_cast<T*>(h), static_cast<T*>(h_last),
      S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// a, gx, h: (B, S, D); h0 (may be null: zeros), h_last: (B, D); all
// contiguous, dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t
// (0 = launched).
extern "C" int rg_lru_fwd(const void* a, const void* gx, const void* h0,
                          void* h, void* h_last, int B, int S, int D,
                          int dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, gx, h0, h, h_last, B, S, D, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, gx, h0, h, h_last, B, S, D, s);
  return (int)cudaErrorInvalidValue;
}

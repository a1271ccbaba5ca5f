// Blockwise symmetric int8 quantize / dequantize for Hopper (sm_90a), plain
// C interface for ctypes.
//
// Replaces: src/repro/kernels/quantize.py::quantize_blockwise_pallas
// (_quant_kernel) and ::dequantize_blockwise_pallas (_dequant_kernel), the
// checkpoint path's on-device int8 compression of optimizer moments.
//
// What bounds them on this card: both are memory-bound streams, about one
// operation per byte (quantize reads 4 B and writes 1 B per element,
// dequantize the reverse), so the bound is the 3.35 TB/s of device memory.
// The design moves each byte once and vectorises: 16-byte float4 loads and
// 4-byte char4 stores per thread, neighbouring threads on neighbouring
// addresses.
//
// quantize: one 256-thread block per quantization block (2048 elements in
// the checkpoint path): an abs-max reduction (warp shuffles, then one
// shared-memory step across warps), then scale and round. The block's 8 KB
// row is read twice; the second read hits L1/L2. The result is
// bit-identical to the reference: scale = max|x| / 127.0 floored at 1e-12
// and q = clip(rint(x / scale), -127, 127), with IEEE division (this file is
// built without --use_fast_math, so '/' is correctly rounded) and
// round-half-to-even (rintf in the default rounding mode).
//
// dequantize: elementwise q * scale[i / block] in f32, cast to the output
// type with round-to-nearest-even; a grid-stride loop of char4 loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QTHREADS = 256;

__device__ __forceinline__ signed char quant1(float x, float scale) {
  float r = rintf(x / scale);
  r = fminf(fmaxf(r, -127.f), 127.f);
  return static_cast<signed char>(static_cast<int>(r));
}

__global__ void __launch_bounds__(QTHREADS)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int block) {
  __shared__ float warp_max[QTHREADS / 32];
  const size_t row = blockIdx.x;
  const float4* xr = reinterpret_cast<const float4*>(x + row * block);
  char4* qr = reinterpret_cast<char4*>(q + row * block);
  const int n4 = block / 4;

  float amax = 0.f;
  for (int i = threadIdx.x; i < n4; i += QTHREADS) {
    const float4 v = xr[i];
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < QTHREADS / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float scale = fmaxf(amax / 127.0f, 1e-12f);
  if (threadIdx.x == 0) scales[row] = scale;
  for (int i = threadIdx.x; i < n4; i += QTHREADS) {
    const float4 v = xr[i];
    char4 c;
    c.x = quant1(v.x, scale);
    c.y = quant1(v.y, scale);
    c.z = quant1(v.z, scale);
    c.w = quant1(v.w, scale);
    qr[i] = c;
  }
}

__device__ __forceinline__ void store4(float* out, size_t i, float a, float b,
                                       float c, float d) {
  reinterpret_cast<float4*>(out)[i] = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, size_t i, float a,
                                       float b, float c, float d) {
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out) + 2 * i;
  o2[0] = __floats2bfloat162_rn(a, b);
  o2[1] = __floats2bfloat162_rn(c, d);
}

template <typename OutT>
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  OutT* __restrict__ out, size_t n4,
                                  int block) {
  const char4* q4 = reinterpret_cast<const char4*>(q);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const char4 c = q4[i];
    const float s = scales[(i * 4) / block];   // block % 4 == 0
    store4(out, i, (float)c.x * s, (float)c.y * s, (float)c.z * s,
           (float)c.w * s);
  }
}

}  // namespace

// x: flat f32 (nblocks * block,), 16-byte aligned, block % 4 == 0 ->
// q int8 (nblocks * block,), scales f32 (nblocks,). Returns a cudaError_t.
extern "C" int quantize_blockwise(const void* x, void* q, void* scales,
                                  long long nblocks, int block,
                                  void* stream) {
  if (nblocks <= 0 || block <= 0 || block % 4 != 0 ||
      nblocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  quantize_kernel<<<(unsigned)nblocks, QTHREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), block);
  return (int)cudaGetLastError();
}

// q int8 (n,), scales f32 (n / block,) -> out (n,), out_dtype 0 = float32,
// 1 = bfloat16. n % block == 0, block % 4 == 0. Returns a cudaError_t.
extern "C" int dequantize_blockwise(const void* q, const void* scales,
                                    void* out, long long n, int block,
                                    int out_dtype, void* stream) {
  if (n <= 0 || block <= 0 || block % 4 != 0 || n % block != 0)
    return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)n / 4;
  const int threads = 256;
  size_t blocks = (n4 + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  if (out_dtype == 0)
    dequantize_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        qp, sp, static_cast<float*>(out), n4, block);
  else if (out_dtype == 1)
    dequantize_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        qp, sp, static_cast<__nv_bfloat16*>(out), n4, block);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

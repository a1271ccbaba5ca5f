// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the Pallas TPU kernel _attn_kernel). Same function: online-softmax
// attention over KV tiles with GQA (kv head = h / group), causal and
// sliding-window masks, gemma-style logit softcap, q_offset and a ragged
// key length; f32 running max / sum / accumulator; masked scores are -1e30
// and the final denominator is max(l, 1e-30), as in the TPU kernel.
//
// What bounds it on this card: at the serving prefill shape (B=4, S=512,
// H=24, KV=2, D=128, bf16, causal) the two products over the causal pairs
// are 6.5 GFLOP (6.5 us at the bf16 tensor-core rate) and q/k/v/o are
// 27 MB (8.1 us at the memory rate): the two bounds are close, and the
// products take over as the sequence grows. This first version does its
// two products on the CUDA cores in f32 (no wgmma / mma.sync, no TMA) out
// of shared memory, so shared-memory bandwidth in the two inner loops
// bounds it and it runs far from either bound; tensor-core tiles are
// later work.
//
// Design, and what it does about the TPU kernel's shape:
//  * The TPU grid walks KV blocks in order and carries m, l, acc in VMEM
//    scratch from one grid step to the next. Blocks on Hopper run in no
//    order, so one block owns one (b, h, 64-row q tile) and loops over the
//    KV tiles itself; m, l and acc live in registers for the whole loop.
//  * 256 threads as a 16 x 16 grid: thread (ty, tx) owns q rows ty + 16 i
//    (i < 4) and, per KV tile, key columns tx + 16 j (j < 4) of the score
//    tile and output columns tx + 16 j (j < D / 16) of the accumulator.
//    A row's 16 owners are 16 neighbouring lanes of one warp, so the row
//    max and row sum are warp shuffles.
//  * Q (pre-scaled by d^-0.5 in f32), K and V tiles are staged in shared
//    memory as f32 with a row pitch of D + 1 words, so the 16 lanes that
//    read 16 different key rows at one d hit 16 different banks. At the
//    largest head dim, D = 256 (gemma3, recurrentgemma), that is
//    4 * (64 * 257 * 3 + 64 * 65) = 214,016 bytes, under the 232,448 a
//    block may use, so one block runs per SM; the accumulator is then
//    4 x 16 floats a thread.
//  * The ragged key edge is masked in the kernel (kpos < Sk) instead of
//    padding K/V in the wrapper; KV tiles that the causal / window masks
//    hide from every row of the q tile are not visited (skipping them does
//    not change the result: a fully masked tile adds exp(-1e30 - m) = 0).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int Sq, int Sk, int H, int KV, int causal, int window,
                 float softcap, float scale, int q_offset) {
  constexpr int P = D + 1;          // padded smem row pitch (words)
  constexpr int DJ = D / 16;        // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x P
  float* Ks = Qs + BQ * P;          // BK x P
  float* Vs = Ks + BK * P;          // BK x P
  float* Ps = Vs + BK * P;          // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  const size_t q_row_stride = (size_t)H * D;
  const size_t k_row_stride = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Sq * H + h) * D;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * D;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * D;

  // stage the q tile, scaled in f32 (rows past Sq are zero, never stored)
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = q0 + r;
    Qs[r * P + d] = row < Sq ? to_f32(qb[(size_t)row * q_row_stride + d]) * scale
                             : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // KV tiles that hold at least one key visible to some row of this tile
  const int qlo = q0 + q_offset;                                // first abs pos
  const int qhi = min(q0 + BQ, Sq) - 1 + q_offset;              // last abs pos
  int k_end = Sk;
  if (causal) k_end = min(k_end, qhi + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, qlo - window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // previous tile's Ks/Vs/Ps reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int key = k0 + r;
      const bool ok = key < Sk;
      Ks[r * P + d] = ok ? to_f32(kb[(size_t)key * k_row_stride + d]) : 0.f;
      Vs[r * P + d] = ok ? to_f32(vb[(size_t)key * k_row_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * P + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + q_offset;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        bool keep = kpos < Sk;
        if (causal) keep = keep && kpos <= qpos;
        if (window) keep = keep && kpos > qpos - window;
        x = keep ? x : NEG_INF;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // Ps complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + ((size_t)b * Sq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(&ob[(size_t)row * q_row_stride + tx + 16 * j], acc[i][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           float softcap, float scale, int q_offset, cudaStream_t stream) {
  constexpr int P = D + 1;
  const size_t smem = sizeof(float) * ((size_t)BQ * P + 2 * (size_t)BK * P +
                                       (size_t)BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, softcap, scale, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int KV, int D, int causal, int window,
               float softcap, float scale, int q_offset, cudaStream_t stream) {
#define FLASH_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,      \
                         softcap, scale, q_offset, stream);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Sk, KV, D), o: (B, Sq, H, D), all contiguous,
// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Sq,
                                   int Sk, int H, int KV, int D, int dtype,
                                   int causal, int window, float softcap,
                                   float scale, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, causal, window,
                             softcap, scale, q_offset, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D, causal,
                                     window, softcap, scale, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

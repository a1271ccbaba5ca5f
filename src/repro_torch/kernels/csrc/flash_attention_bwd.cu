// Flash attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/ops.py::_flash_bwd, the backward of the
// reference's custom VJP around flash attention (plain jnp there: the
// Pallas TPU kernel flash_attention_pallas is forward-only). Same
// function: from the forward's (q, k, v, o) and its f32 row statistics
// (m = row max of the scaled, soft-capped, masked scores, l = sum
// exp(s - m)), and the output gradient dO, recompute per key tile
//   p  = exp(sc - m) / max(l, 1e-30)   (0 where masked),
//   dv = p^T dO,   dp = dO v^T,
//   ds = p (dp - D) [(1 - (sc/cap)^2) under softcap] d^-0.5,
//   dq = ds k,     dk = ds^T q,
// with D = rowsum(dO o) in f32 (o as stored: bf16 o is upcast). GQA: kv
// head = h / (H / KV), and dk, dv sum over the query heads of a group.
// Masks: causal, sliding window (kpos > qpos - window), q_offset, ragged
// Sq and Sk, as the forward.
//
// Three kernels, one launch each, no atomics:
//  * flash_bwd_delta_kernel: D per (b, row, head), one warp a row.
//  * flash_bwd_dkdv_kernel<D, T>: one block per (key tile, kv head, b). The
//    K and V tiles stay in shared memory; the block walks the H / KV query
//    heads of its group and, per head, the q tiles whose rows can see a key
//    of the tile (causal and window bounds), recomputes S and dP for each,
//    and accumulates dv += P^T dO and dk += dS^T Q in registers; dk and dv
//    are written once.
//  * flash_bwd_dq_kernel<D, T>: one block per (q tile, head, b), the Q and
//    dO tiles resident; it walks the visible key tiles and accumulates
//    dq += dS K in registers.
// S and dP are recomputed by both (seven tile products where the
// reference has five), which is what keeps dk, dv and dq free of atomics.
// Every sum runs in a fixed order, so two launches on the same inputs give
// the same bits (the training restart is checked bit for bit).
//
// Arithmetic: f32 on the CUDA cores for both input types (bf16 is upcast
// as it is staged), outputs rounded once to the input type, as the
// reference casts them. Tensor cores, TMA and a ring of tiles come later.
//
// What bounds it on this card, at the training shape of starcoder2-3b
// (B = 8, S = 2048, H = 24, KV = 2, D = 128, bf16, causal): the five
// products over the 50.4 M causal (q, k) pairs of each (b, h) are 515 GFLOP
// (0.52 ms at the 989 TFLOP/s of the bf16 tensor cores) against 0.44 GB of
// inputs and outputs (0.13 ms at 3.35 TB/s): operations. On the CUDA cores
// (67 TFLOP/s f32, less out of shared memory) this kernel sits far above
// that bound; its time is in PERF.md.
//
// Tiles and threads: 256 threads as a 16 x 16 grid (ty, tx). In a tile
// product a thread owns rows ty + 16 i and columns tx + 16 j, so a warp
// reads two rows of one operand (a broadcast) and 16 rows of the other at
// a row pitch of D + 1 words (16 banks). Tiles of 64 q rows x 64 keys for
// D <= 128, 32 x 32 for D = 256; shared memory a block (f32 staging, four
// (rows x (D + 1)) tiles, two (BQ x (BK + 1)) score tiles, three row
// vectors): D = 128 166,144 bytes, D = 256 140,416 bytes, so one block an
// SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
struct BwdPlan {
  static constexpr int BQ = D > 128 ? 32 : 64;  // q rows per tile
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per tile
  static constexpr int RI = BQ / 16;            // q rows per thread
  static constexpr int RJ = BK / 16;            // keys per thread
  static constexpr int DJ = D / 16;             // d columns per thread
  static constexpr int P = D + 1;               // smem row pitch (words)
  static constexpr int PS = BK + 1;             // score tile pitch
  static constexpr int SMEM =
      (int)sizeof(float) * (2 * BQ * P + 2 * BK * P + 2 * BQ * PS + 3 * BQ);
};

struct Masks {
  int Sq, Sk, causal, window, q_offset;
  float softcap, scale;
};

// rows [r0, r0 + ROWS) of a (rows, stride) matrix of T, columns [0, D),
// into an f32 tile of pitch D + 1; rows past n are zero
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n,
                                      size_t stride) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] = row < n ? to_f32(src[(size_t)row * stride + d])
                                   : 0.f;
  }
}

// the tile's row statistics: m, 1 / max(l, 1e-30) and D of rows
// [q0, q0 + BQ) of head h (zeros past Sq, never used: p is 0 there)
template <int BQ>
__device__ __forceinline__ void stage_rows(float* rowm, float* rowli,
                                           float* rowd, const float* m,
                                           const float* l, const float* delta,
                                           int b, int q0, int h, int Sq,
                                           int H) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int row = q0 + r;
    const size_t i = ((size_t)b * Sq + row) * H + h;
    const bool ok = row < Sq;
    rowm[r] = ok ? m[i] : 0.f;
    rowli[r] = ok ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
    rowd[r] = ok ? delta[i] : 0.f;
  }
}

// P and dS of one (BQ x BK) tile from the staged Q, dO, K, V and row
// statistics, into Ps and dSs: thread (ty, tx) computes rows ty + 16 i,
// keys tx + 16 j, in the reference's order of operations
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* rowm, const float* rowli,
                                       const float* rowd, float* Ps,
                                       float* dSs, int q0, int k0,
                                       const Masks& mk) {
  using Plan = BwdPlan<D>;
  constexpr int RI = Plan::RI, RJ = Plan::RJ, P = Plan::P, PS = Plan::PS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[RI][RJ], dp[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RI], gv[RI], kv[RJ], vv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = Qs[(ty + 16 * i) * P + d];
      gv[i] = dOs[(ty + 16 * i) * P + d];
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      kv[j] = Ks[(tx + 16 * j) * P + d];
      vv[j] = Vs[(tx + 16 * j) * P + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    const int qpos = row + mk.q_offset;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int c = tx + 16 * j;
      const int kpos = k0 + c;
      float x = s[i][j] * mk.scale;
      float dcap = 1.f;
      if (mk.softcap != 0.f) {
        x = tanhf(x / mk.softcap) * mk.softcap;
        const float t = x / mk.softcap;
        dcap = 1.f - t * t;
      }
      bool keep = row < mk.Sq && kpos < mk.Sk;
      if (mk.causal) keep = keep && kpos <= qpos;
      if (mk.window) keep = keep && kpos > qpos - mk.window;
      const float p = keep ? expf(x - rowm[r]) * rowli[r] : 0.f;
      float ds = p * (dp[i][j] - rowd[r]);
      if (mk.softcap != 0.f) ds = ds * dcap;
      Ps[r * PS + c] = p;
      dSs[r * PS + c] = ds * mk.scale;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const void* __restrict__ dout,
                       const void* __restrict__ o, float* __restrict__ delta,
                       int rows, int D, int bf16_in) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (THREADS / 32) + warp;
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    float g, x;
    if (bf16_in) {
      g = to_f32(static_cast<const bf16*>(dout)[base + d]);
      x = to_f32(static_cast<const bf16*>(o)[base + d]);
    } else {
      g = static_cast<const float*>(dout)[base + d];
      x = static_cast<const float*>(o)[base + d];
    }
    acc = fmaf(g, x, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ m,
                      const float* __restrict__ l,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KV, Masks mk) {
  using Plan = BwdPlan<D>;
  constexpr int BQ = Plan::BQ, BK = Plan::BK, RJ = Plan::RJ, DJ = Plan::DJ;
  constexpr int P = Plan::P, PS = Plan::PS;
  extern __shared__ float smem[];
  float* Ks = smem;                 // BK x P
  float* Vs = Ks + BK * P;          // BK x P
  float* Qs = Vs + BK * P;          // BQ x P
  float* dOs = Qs + BQ * P;         // BQ x P
  float* Ps = dOs + BQ * P;         // BQ x PS
  float* dSs = Ps + BQ * PS;        // BQ x PS
  float* rowm = dSs + BQ * PS;      // BQ
  float* rowli = rowm + BQ;         // BQ
  float* rowd = rowli + BQ;         // BQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int Sq = mk.Sq, Sk = mk.Sk;
  const size_t q_stride = (size_t)H * D, k_stride = (size_t)KV * D;

  const size_t kv_off = ((size_t)b * Sk * KV + kvh) * D;
  stage<D, BK>(Ks, k + kv_off, k0, Sk, k_stride);
  stage<D, BK>(Vs, v + kv_off, k0, Sk, k_stride);

  float adk[RJ][DJ], adv[RJ][DJ];
#pragma unroll
  for (int i = 0; i < RJ; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  // q rows that see at least one key of [k0, kmax]: causal needs
  // qpos >= k0, the window qpos < kmax + window
  const int kmax = min(k0 + BK, Sk) - 1;
  const int q_lo = mk.causal ? max(0, k0 - mk.q_offset) : 0;
  const int q_hi = mk.window ? min(Sq, kmax + mk.window - mk.q_offset) : Sq;
  const int t_begin = q_lo / BQ;
  const int t_end = q_hi > q_lo ? (q_hi + BQ - 1) / BQ : t_begin;

  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    const size_t q_off = ((size_t)b * Sq * H + h) * D;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's Qs, dOs, Ps, dSs reads are done
      stage<D, BQ>(Qs, q + q_off, q0, Sq, q_stride);
      stage<D, BQ>(dOs, dout + q_off, q0, Sq, q_stride);
      stage_rows<BQ>(rowm, rowli, rowd, m, l, delta, b, q0, h, Sq, H);
      __syncthreads();
      scores<D>(Qs, dOs, Ks, Vs, rowm, rowli, rowd, Ps, dSs, q0, k0, mk);
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q: keys ty + 16 i, columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[RJ], sv[RJ], gv[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < RJ; ++i) {
          pv[i] = Ps[r * PS + ty + 16 * i];
          sv[i] = dSs[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gv[j] = dOs[r * P + tx + 16 * j];
          qv[j] = Qs[r * P + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RJ; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            adv[i][j] = fmaf(pv[i], gv[j], adv[i][j]);
            adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RJ; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
    const size_t off = kv_off + (size_t)key * k_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(adk[i][j]);
      dv[off + tx + 16 * j] = from_f32<T>(adv[i][j]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int KV, Masks mk) {
  using Plan = BwdPlan<D>;
  constexpr int BQ = Plan::BQ, BK = Plan::BK, RI = Plan::RI, DJ = Plan::DJ;
  constexpr int P = Plan::P, PS = Plan::PS;
  extern __shared__ float smem[];
  float* Ks = smem;                 // BK x P
  float* Vs = Ks + BK * P;          // BK x P
  float* Qs = Vs + BK * P;          // BQ x P
  float* dOs = Qs + BQ * P;         // BQ x P
  float* Ps = dOs + BQ * P;         // BQ x PS
  float* dSs = Ps + BQ * PS;        // BQ x PS
  float* rowm = dSs + BQ * PS;      // BQ
  float* rowli = rowm + BQ;         // BQ
  float* rowd = rowli + BQ;         // BQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // most keys first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int Sq = mk.Sq, Sk = mk.Sk;
  const size_t q_stride = (size_t)H * D, k_stride = (size_t)KV * D;
  const size_t q_off = ((size_t)b * Sq * H + h) * D;
  const size_t kv_off = ((size_t)b * Sk * KV + kvh) * D;

  stage<D, BQ>(Qs, q + q_off, q0, Sq, q_stride);
  stage<D, BQ>(dOs, dout + q_off, q0, Sq, q_stride);
  stage_rows<BQ>(rowm, rowli, rowd, m, l, delta, b, q0, h, Sq, H);

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // key tiles that hold a key visible to some row of this tile
  const int qlo = q0 + mk.q_offset;
  const int qhi = min(q0 + BQ, Sq) - 1 + mk.q_offset;
  int k_end = Sk;
  if (mk.causal) k_end = min(k_end, qhi + 1);
  const int k_begin = mk.window ? max(0, qlo - mk.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's Ks, Vs, dSs reads are done
    stage<D, BK>(Ks, k + kv_off, k0, Sk, k_stride);
    stage<D, BK>(Vs, v + kv_off, k0, Sk, k_stride);
    __syncthreads();
    scores<D>(Qs, dOs, Ks, Vs, rowm, rowli, rowd, Ps, dSs, q0, k0, mk);
    __syncthreads();
    // dq += dS K: rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = dSs[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const size_t off = q_off + (size_t)row * q_stride;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[off + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* m, const float* l, const float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KV, const Masks& mk,
           cudaStream_t stream) {
  using Plan = BwdPlan<D>;
  const int q_tiles = (mk.Sq + Plan::BQ - 1) / Plan::BQ;
  const int k_tiles = (mk.Sk + Plan::BK - 1) / Plan::BK;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Plan::SMEM);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  flash_bwd_dkdv_kernel<D, T>
      <<<dim3(k_tiles, KV, B), THREADS, Plan::SMEM, stream>>>(
          qt, kt, vt, gt, m, l, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), H, KV, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, T>
      <<<dim3(q_tiles, H, B), THREADS, Plan::SMEM, stream>>>(
          qt, kt, vt, gt, m, l, delta, static_cast<T*>(dq), H, KV, mk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v,
               const void* dout, const float* m, const float* l,
               const float* delta, void* dq, void* dk, void* dv, int B, int H,
               int KV, int D, const Masks& mk, cudaStream_t stream) {
#define BWD_CASE(DD)                                                        \
  case DD:                                                                  \
    return launch<DD, T>(q, k, v, dout, m, l, delta, dq, dk, dv, B, H, KV,  \
                         mk, stream);
  switch (D) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(48)
    BWD_CASE(64)
    BWD_CASE(128)
    BWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, KV, D); m, l and the
// scratch delta: (B, Sq, H) float32; all contiguous. dtype 0 = float32,
// 1 = bfloat16 (q, k, v, o, dout and the outputs). Launches the D pre-pass,
// then the dk / dv and the dq kernels, on ``stream``. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* m,
                                   const void* l, void* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Sk,
                                   int H, int KV, int D, int dtype,
                                   int causal, int window, float softcap,
                                   float scale, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)B * Sq * H;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bwd_delta_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      dout, o, static_cast<float*>(delta), (int)rows, D, dtype);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Masks mk{Sq, Sk, causal, window, q_offset, softcap, scale};
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  const float* df = static_cast<const float*>(delta);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, dout, mf, lf, df, dq, dk, dv, B, H, KV,
                             D, mk, s);
  return dispatch_d<bf16>(q, k, v, dout, mf, lf, df, dq, dk, dv, B, H, KV, D,
                          mk, s);
}

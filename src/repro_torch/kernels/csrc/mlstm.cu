// Chunkwise mLSTM forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/mlstm.py::mlstm_pallas (the Pallas TPU kernel
// _mlstm_kernel). Same function: the xLSTM matrix-memory cell from a fresh
// state, chunk by chunk. Within a chunk of c steps,
//   F = cumsum(lf), src = li - F, m_t = F + max(m_prev, cummax(src)),
//   w[t,u] = exp(F[t] + src[u] - m_t[t]) for u <= t (else 0),
//   num = exp(F + m_prev - m_t) * (q C) + (w o q k^T) v,
//   den = max(|exp(F + m_prev - m_t) * (q n) + rowsum(w o q k^T)|, exp(-m_t)),
//   h = num / den,
// then C, n and m move to the end of the chunk. q/k/v (B, S, H, D) in one
// dtype (float32 or bfloat16), lf/li (B, S, H) float32; outputs h
// (B, S, H, D), C (B, H, D, D) and n (B, H, D) in q's dtype, m (B, H) float32.
// All arithmetic is float32; the initial m and the causal mask use -1e30 as
// the TPU kernel does (with -inf, F + m_prev - m_t would be NaN).
//
// What bounds it on this card: operations. At the xlstm-350m training shape
// (B=8, S=2048, H=4, D=512, chunk 128) the chunk's two (c x c x D) and two
// (c x D x D) products come to ~86 GFLOP against ~285 MB of q/k/v/h/C, about
// 0.09 ms at the bf16 tensor-core rate either way. This first version runs
// its products in float32 on the CUDA cores out of shared memory (no wgmma,
// no TMA) and recomputes each chunk's (c x c) weights once per column tile,
// so it runs far from that bound; tensor-core tiles are later work.
//
// Design, and what it does about the TPU kernel's shape:
//  * The TPU kernel keeps the whole (D x D) state in VMEM and carries it
//    across a sequential grid axis over chunks. At head dim 512 the state is
//    1 MiB of float32, far above the 227 KB of shared memory a Hopper block
//    may use. The columns of C (the v dimension) are independent: column j
//    of num needs only column j of C, and the update of column j needs only
//    column j of v. So a block owns one (b, h, 32-column tile) and keeps
//    that 512 x 32 slice of C (64 KB) in shared memory while it walks the
//    chunks in order; blocks never exchange data. The training shape gives
//    B * H * D / 32 = 512 blocks on 132 SMs.
//  * Each block recomputes the chunk's weights w o (q k^T) over D in
//    32-wide slices of q and k, and q . n, redundantly across the column
//    tiles of one (b, h): simple, and the only cross-tile dependency.
//  * The (c x c) weight matrix (64 KB), the slices and the gate vectors
//    complete the block's ~169 KB of shared memory: one block of 256
//    threads (a 16 x 16 grid) per SM. Thread (ty, tx) owns rows ty + 16 i of
//    the chunk and columns tx + 16 j, so a row's owners are neighbouring
//    lanes of one warp and the row sum of w is a fixed butterfly of
//    shuffles. Row pitches are odd (33, 129 words): the lanes that read
//    different rows at one column hit different banks.
//  * Determinism: no atomics, and every sum has a fixed order, so two runs
//    on the same inputs give the same bits (a training restart is checked
//    bit for bit against an uninterrupted run).
//  * The cumulative sum of lf is a Hillis-Steele scan (log2 c rounds of
//    x[i] = x[i - k] + x[i]), the order the plain PyTorch version uses, and
//    the running max is exact, so m comes out bit-identical to the plain
//    version's; the products sum in another order than cuBLAS and agree
//    within float32 rounding. Adds and multiplies outside the products are
//    __fadd_rn / __fmul_rn, never contracted, as PyTorch rounds them.
//  * Any chunk up to 128 with S % chunk == 0, and head dims 16, 32, 64,
//    128, 256 and 512.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // 16 x 16
constexpr int CMAX = 128;        // largest chunk
constexpr int WP = CMAX + 1;     // pitch of the weight matrix (words)
constexpr int RI = CMAX / 16;    // chunk rows per thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
struct Tile {
  static constexpr int TW = D < 32 ? D : 32;  // v columns a block, d slice
  static constexpr int P = TW + 1;            // slice / tile pitch (words)
  static constexpr int JJ = TW / 16;          // columns per thread
  static constexpr int smem_floats =
      D * P + D + CMAX * WP + 2 * CMAX * P + 6 * CMAX + 1;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
mlstm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lf,
                 const float* __restrict__ li, T* __restrict__ h,
                 T* __restrict__ c_out, T* __restrict__ n_out,
                 float* __restrict__ m_out, int S, int H, int chunk,
                 float scale) {
  constexpr int TW = Tile<D>::TW;
  constexpr int P = Tile<D>::P;
  constexpr int JJ = Tile<D>::JJ;
  extern __shared__ float smem[];
  float* Cs = smem;                 // D x P: this block's columns of C
  float* ns = Cs + D * P;           // D: n
  float* Ws = ns + D;               // CMAX x WP: w o (q k^T)
  float* As = Ws + CMAX * WP;       // CMAX x P: q slice, then v tile
  float* Bs = As + CMAX * P;        // CMAX x P: k slice
  float* Fs = Bs + CMAX * P;        // F
  float* Ss = Fs + CMAX;            // li, then src
  float* Rs = Ss + CMAX;            // cummax(src)
  float* Ms = Rs + CMAX;            // m_t
  float* CCs = Ms + CMAX;           // carry coefficient exp(F + m_prev - m_t)
  float* SCs = CCs + CMAX;          // source coefficient exp(F_c + src - m_c)
  float* m_state = SCs + CMAX;      // m carried across chunks

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int j0 = blockIdx.x * TW;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row = (size_t)H * D;                  // one step of q/k/v/h
  const size_t base = ((size_t)b * S * H + hh) * D;  // (b, 0, hh, 0)
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base + j0;
  T* hb = h + base + j0;
  const float* lfb = lf + (size_t)b * S * H + hh;
  const float* lib = li + (size_t)b * S * H + hh;

  for (int e = tid; e < D * P; e += THREADS) Cs[e] = 0.f;
  for (int e = tid; e < D; e += THREADS) ns[e] = 0.f;
  if (tid == 0) m_state[0] = NEG;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += chunk) {
    // ---------------- gates: F, src, m_t and the coefficients
    if (tid < chunk) {
      Fs[tid] = lfb[(size_t)(s0 + tid) * H];
      Ss[tid] = lib[(size_t)(s0 + tid) * H];
    }
    __syncthreads();
    for (int off = 1; off < chunk; off <<= 1) {   // F = cumsum(lf)
      const bool act = tid < chunk && tid >= off;
      const float x = act ? Fs[tid - off] : 0.f;
      __syncthreads();
      if (act) Fs[tid] = __fadd_rn(x, Fs[tid]);
      __syncthreads();
    }
    if (tid < chunk) {
      const float sv = __fsub_rn(Ss[tid], Fs[tid]);
      Ss[tid] = sv;
      Rs[tid] = sv;
    }
    __syncthreads();
    for (int off = 1; off < chunk; off <<= 1) {   // running max of src
      const bool act = tid < chunk && tid >= off;
      const float x = act ? Rs[tid - off] : 0.f;
      __syncthreads();
      if (act) Rs[tid] = fmaxf(x, Rs[tid]);
      __syncthreads();
    }
    const float m_prev = m_state[0];
    if (tid < chunk) Ms[tid] = __fadd_rn(Fs[tid], fmaxf(m_prev, Rs[tid]));
    __syncthreads();
    const float m_last = Ms[chunk - 1];
    const float f_all = Fs[chunk - 1];
    if (tid < chunk) {
      CCs[tid] = expf(__fsub_rn(__fadd_rn(Fs[tid], m_prev), Ms[tid]));
      SCs[tid] = expf(__fsub_rn(__fadd_rn(f_all, Ss[tid]), m_last));
    }

    // ---------------- q k^T, q C (this block's columns) and q . n over D
    float sacc[RI][8], nacc[RI][JJ], dacc[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      dacc[i] = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) sacc[i][u] = 0.f;
#pragma unroll
      for (int j = 0; j < JJ; ++j) nacc[i][j] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += TW) {
      for (int e = tid; e < CMAX * TW; e += THREADS) {
        const int t = e / TW, dd = e % TW;
        float qv = 0.f, kv = 0.f;
        if (t < chunk) {
          const size_t off = (size_t)(s0 + t) * row + d0 + dd;
          qv = to_f32(qb[off]);
          kv = __fmul_rn(to_f32(kb[off]), scale);
        }
        As[t * P + dd] = qv;
        Bs[t * P + dd] = kv;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < TW; ++dd) {
        float qr[RI], kr[8], cr[JJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) qr[i] = As[(ty + 16 * i) * P + dd];
#pragma unroll
        for (int u = 0; u < 8; ++u) kr[u] = Bs[(tx + 16 * u) * P + dd];
#pragma unroll
        for (int j = 0; j < JJ; ++j) cr[j] = Cs[(d0 + dd) * P + tx + 16 * j];
        const float nd = ns[d0 + dd];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          dacc[i] = fmaf(qr[i], nd, dacc[i]);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            sacc[i][u] = fmaf(qr[i], kr[u], sacc[i][u]);
#pragma unroll
          for (int j = 0; j < JJ; ++j)
            nacc[i][j] = fmaf(qr[i], cr[j], nacc[i][j]);
        }
      }
      __syncthreads();
    }

    // ---------------- w o (q k^T), its row sums and the denominators
    float den[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int t = ty + 16 * i;
      const float ft = Fs[t], mt = Ms[t];   // read past the chunk: unused
      float rsum = 0.f;
#pragma unroll
      for (int u8 = 0; u8 < 8; ++u8) {
        const int u = tx + 16 * u8;
        float w = 0.f;
        if (t < chunk && u <= t)
          w = __fmul_rn(expf(__fsub_rn(__fadd_rn(ft, Ss[u]), mt)),
                        sacc[i][u8]);
        Ws[t * WP + u] = w;
        rsum = __fadd_rn(rsum, w);
      }
      // the 16 owners of row t are lanes of one half warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum = __fadd_rn(rsum, __shfl_xor_sync(0xffffffffu, rsum, o));
      den[i] = 1.f;
      if (t < chunk) {
        const float dsum = __fadd_rn(__fmul_rn(dacc[i], CCs[t]), rsum);
        den[i] = fmaxf(fabsf(dsum), expf(-Ms[t]));
      }
    }
    for (int e = tid; e < CMAX * TW; e += THREADS) {   // v tile
      const int t = e / TW, j = e % TW;
      As[t * P + j] = t < chunk ? to_f32(vb[(size_t)(s0 + t) * row + j]) : 0.f;
    }
    __syncthreads();

    // ---------------- h = (carry * q C + (w o q k^T) v) / den
    {
      float iacc[RI][JJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < JJ; ++j) iacc[i][j] = 0.f;
      for (int u = 0; u < chunk; ++u) {
        float wr[RI], vr[JJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) wr[i] = Ws[(ty + 16 * i) * WP + u];
#pragma unroll
        for (int j = 0; j < JJ; ++j) vr[j] = As[u * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < JJ; ++j)
            iacc[i][j] = fmaf(wr[i], vr[j], iacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int t = ty + 16 * i;
        if (t >= chunk) continue;
        const float cc = CCs[t];
#pragma unroll
        for (int j = 0; j < JJ; ++j) {
          const float num = __fadd_rn(__fmul_rn(nacc[i][j], cc), iacc[i][j]);
          store(&hb[(size_t)(s0 + t) * row + tx + 16 * j], num / den[i]);
        }
      }
    }

    // ---------------- C, n to the end of the chunk
    const float stc = expf(__fsub_rn(__fadd_rn(f_all, m_prev), m_last));
    for (int d0 = 0; d0 < D; d0 += TW) {
      for (int e = tid; e < CMAX * TW; e += THREADS) {   // (k * scale) * sc
        const int t = e / TW, dd = e % TW;
        Bs[t * P + dd] =
            t < chunk ? __fmul_rn(__fmul_rn(to_f32(kb[(size_t)(s0 + t) * row
                                                      + d0 + dd]), scale),
                                  SCs[t])
                      : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < TW / 16; ++a) {
        const int dr = ty + 16 * a;
#pragma unroll
        for (int j = 0; j < JJ; ++j) {
          float acc = 0.f;
          for (int u = 0; u < chunk; ++u)
            acc = fmaf(Bs[u * P + dr], As[u * P + tx + 16 * j], acc);
          float* c = &Cs[(d0 + dr) * P + tx + 16 * j];
          *c = __fadd_rn(__fmul_rn(*c, stc), acc);
        }
      }
      if (tid < TW) {
        float acc = 0.f;
        for (int u = 0; u < chunk; ++u) acc = __fadd_rn(acc, Bs[u * P + tid]);
        ns[d0 + tid] = __fadd_rn(__fmul_rn(ns[d0 + tid], stc), acc);
      }
      __syncthreads();
    }
    if (tid == 0) m_state[0] = m_last;
    __syncthreads();
  }

  // ---------------- final state
  const size_t bh = (size_t)b * H + hh;
  for (int e = tid; e < D * TW; e += THREADS) {
    const int d = e / TW, j = e % TW;
    store(&c_out[(bh * D + d) * D + j0 + j], Cs[d * P + j]);
  }
  if (blockIdx.x == 0) {
    for (int e = tid; e < D; e += THREADS) store(&n_out[bh * D + e], ns[e]);
    if (tid == 0) m_out[bh] = m_state[0];
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* lf,
           const float* li, void* h, void* c, void* n, float* m, int B,
           int S, int H, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Tile<D>::smem_floats;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(D / Tile<D>::TW, H, B);
  mlstm_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lf, li, static_cast<T*>(h),
      static_cast<T*>(c), static_cast<T*>(n), m, S, H, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const float* lf,
               const float* li, void* h, void* c, void* n, float* m, int B,
               int S, int H, int D, int chunk, float scale,
               cudaStream_t stream) {
#define MLSTM_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, lf, li, h, c, n, m, B, S, H, chunk, scale, \
                         stream);
  switch (D) {
    MLSTM_CASE(16)
    MLSTM_CASE(32)
    MLSTM_CASE(64)
    MLSTM_CASE(128)
    MLSTM_CASE(256)
    MLSTM_CASE(512)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MLSTM_CASE
}

}  // namespace

// q, k, v, h: (B, S, H, D); lf, li: (B, S, H) float32; c: (B, H, D, D);
// n: (B, H, D); m: (B, H) float32; all contiguous. dtype 0 = float32,
// 1 = bfloat16 (q, k, v, h, c, n). Needs 1 <= chunk <= 128 and
// S % chunk == 0. Returns a cudaError_t (0 = launched).
extern "C" int mlstm_fwd(const void* q, const void* k, const void* v,
                         const float* lf, const float* li, void* h, void* c,
                         void* n, float* m, int B, int S, int H, int D,
                         int chunk, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 || chunk <= 0 ||
      chunk > CMAX || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, lf, li, h, c, n, m, B, S, H, D, chunk,
                             scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, lf, li, h, c, n, m, B, S, H, D,
                                     chunk, scale, s);
  return (int)cudaErrorInvalidValue;
}

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
// The initial m and the causal mask use -1e30 as the TPU kernel does (with
// -inf, F + m_prev - m_t would be NaN).
//
// Two kernels, chosen by dtype:
//  * bfloat16 (xlstm-350m computes in bf16): mlstm_mma_kernel, its products
//    on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//  * float32: mlstm_simt_kernel, every product in f32 on the CUDA cores.
//    The reference's f32 tolerances (5e-4 / 1e-3) rule out bf16 products,
//    and no full-width path runs an f32 mLSTM.
//
// What bounds it on this card: bytes. At the xlstm-350m training shape
// (B=8, S=2048, H=4, D=512, chunk 128) q/k/v/h, the gates and the final
// C/n/m are 285.8 MB, 0.0853 ms at 3.35 TB/s; the chunk's products over the
// causal pairs are 77.4 GFLOP, 0.078 ms at 989 TFLOP/s.
//
// Shared by both kernels:
//  * The TPU kernel keeps the whole (D x D) state in VMEM and carries it
//    across a sequential grid axis over chunks. At head dim 512 the state is
//    1 MiB of float32, far above the 227 KB of shared memory a Hopper block
//    may use. The columns of C (the v dimension) are independent: column j
//    of num needs only column j of C, and the update of column j needs only
//    column j of v. So a block owns one (b, h, 32-column tile) and keeps
//    that 512 x 32 slice of C in f32 in shared memory while it walks the
//    chunks in order; blocks never exchange data. The training shape gives
//    B * H * D / 32 = 512 blocks on 132 SMs. Each block recomputes the
//    chunk's weights w o (q k^T) and q . n, redundantly across the 16 column
//    tiles of one (b, h): simple, and the only cross-tile dependency.
//  * The gates: the cumulative sum of lf is a Hillis-Steele scan (log2 c
//    rounds of x[i] = x[i - k] + x[i]), the order the plain PyTorch version
//    uses, and the running max is exact, so m comes out bit-identical to the
//    plain version's. Adds and multiplies outside the products are
//    __fadd_rn / __fmul_rn, never contracted, as PyTorch rounds them.
//  * Determinism: no atomics, and every sum has a fixed order, so two runs
//    on the same inputs give the same bits (a training restart is checked
//    bit for bit against an uninterrupted run).
//  * Any chunk up to 128 with S % chunk == 0, and head dims 16, 32, 64,
//    128, 256 and 512.
//
// The bf16 kernel (256 threads, 8 warps; warp w owns chunk rows 16w..16w+15
// of q k^T, q C, the weights, W V and h):
//  * q k^T and q C. q and k are staged as bf16 in 64-wide d slices through
//    a two-stage cp.async ring (rows past the chunk zero-filled); operands
//    come through ldmatrix, rows padded by 16 bytes (an odd number of
//    16-byte units a row, so conflict-free). q and k are exact in bf16, so
//    q k^T is one product; its 16 x 8 tiles above the diagonal are skipped,
//    and d^-0.5 is applied to the f32 result. C is f32 (one bf16 rounding
//    of it puts h past one bf16 ulp of the plain version), so its B
//    fragments are built from the f32 values as they are loaded, split as
//    hi = bf16(x), lo = bf16(x - hi), and q C = q C_hi + q C_lo in one f32
//    accumulator. q . n stays on the CUDA cores.
//  * Weights. w o (q k^T) is formed in f32 in the accumulator registers,
//    its row sums taken in f32 before any rounding (a thread's own columns
//    in order, then its quad of lanes), and it is split into hi / lo bf16 A
//    fragments in registers (two m16n8 accumulator tiles are one m16k16 A
//    fragment): W V = W_hi V + W_lo V, with V exact in bf16 (ldmatrix.trans).
//    h = (carry * q C + W V) / den leaves from the same registers.
//  * The C update. K' = (k * scale) * src_coeff is formed in f32 per 64-wide
//    d slice (into the ring's space) and split into hi / lo planes;
//    K'^T V = K'_hi^T V + K'_lo^T V (ldmatrix.trans for the transposed
//    operand), then C = state_coeff * C + acc in the same rounded order as
//    the f32 kernel. n = state_coeff * n + sum_u K' sums the f32 K' in order
//    on the CUDA cores, as the f32 kernel does.
//  * Chunks that are not a multiple of 16 are zero-padded to the 16-row
//    tile; the padded (t, u) weights are set to 0 and never exponentiated.
//  * Resources at D = 512: ring 2 stages x (q, k) x 128 rows x 144 bytes =
//    73,728; v tile 128 x 80 = 10,240; C 512 x 36 words = 73,728 (pitch 36:
//    the 4 x 8 lanes that load one B fragment hit 32 banks); n 2,048;
//    gates and q . n 3,600: 163,344 bytes, one block (8 warps) an SM, so
//    the 512 blocks run in 3.9 waves. Registers are capped at 255 by the
//    launch bounds (the warp of the last row tile holds 64 f32 of q k^T, 16
//    of q C and 16 of W V); `[ptxas mlstm]` in chip_smoke.py prints the
//    count and spills of each instance (PERF.md keeps them).
//  * What still holds it back: each of the 16 column tiles of a (b, h)
//    recomputes q k^T (about a third of its products), the hi / lo split
//    doubles the products with C, W and K', the f32 C fragments cost a
//    split at every load, the warps' causal work differs by 8 x (row tile
//    0 against 7), and one block an SM hides little latency.
//
// The f32 kernel: 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows
// ty + 16 i of the chunk and columns tx + 16 j, so a row's owners are
// neighbouring lanes of one warp and the row sum of w is a fixed butterfly
// of shuffles. q/k slices, v and w go through shared memory as f32 (odd row
// pitches, ~169 KB, one block an SM); products are f32 FMAs.
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
struct Tile {
  static constexpr int TW = D < 32 ? D : 32;  // v columns a block, d slice
  static constexpr int P = TW + 1;            // slice / tile pitch (words)
  static constexpr int JJ = TW / 16;          // columns per thread
  static constexpr int smem_floats =
      D * P + D + CMAX * WP + 2 * CMAX * P + 6 * CMAX + 1;
};

// ------------------------------------------------------------------ f32

template <int D>
__global__ void __launch_bounds__(THREADS)
mlstm_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ lf,
                  const float* __restrict__ li, float* __restrict__ h,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  float* __restrict__ m_out, int S, int H, int chunk,
                  float scale) {
  using T = float;
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

// ------------------------------------------------------------------ bf16

using bf16 = __nv_bfloat16;

template <int D>
struct MmaPlan {
  static constexpr int WARPS = THREADS / 32;
  static constexpr int TW = D < 32 ? D : 32;   // v columns a block
  static constexpr int KW = D < 64 ? D : 64;   // d slice (ring, update)
  static constexpr int NS = D / KW;            // d slices
  static constexpr int NT = TW / 8;            // 8-wide n tiles of v
  static constexpr int RP = KW + 8;            // bf16 pitch: ring, K' planes
  static constexpr int VP = TW + 8;            // bf16 pitch: v tile
  static constexpr int CP = TW + 4;            // f32 pitch: C
  static constexpr int RING = 2 * 2 * CMAX * RP;   // bf16: 2 stages x q, k
  static constexpr int SMEM = 2 * RING + 2 * CMAX * VP +
                              4 * (D * CP + D + 7 * CMAX + 4);
  // the update of one d slice: (KW / 16) x NT tiles of 16 x 8, UN n tiles
  // a warp
  static constexpr int UT = (KW / 16) * NT;
  static constexpr int UN = UT >= 2 * WARPS ? 2 : 1;
  static_assert(UT <= 2 * WARPS && UT % UN == 0, "update tiles");
  // K' of one slice in f32, then its hi and lo planes, in the ring's space
  static_assert(4 * CMAX * KW + 2 * 2 * CMAX * RP <= 2 * RING, "K' planes");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until waited for; zero-filled when
// !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and r[i] holds row lane / 4, columns 2 (lane % 4) + {0, 1}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, transposed: r[i] holds rows 2 (lane % 4) + {0, 1}, column
// lane / 4 of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// two matrices, transposed; lanes 0 .. 15 give the row addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) ~ hi + lo: hi = bf16(x), lo = bf16(x - hi), packed low half first
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y)));
}

// Fragment layouts (g = lane / 4, c = lane % 4): an m16n8 f32 tile holds
// rows g (regs 0, 1) and g + 8 (regs 2, 3) at columns 2c + {0, 1}; an A
// operand (16 x 16) holds rows g / g + 8 at columns 2c + {0, 1} (regs 0, 1)
// and 2c + 8 + {0, 1} (regs 2, 3); a B operand (16 x 8) holds column g at
// rows 2c + {0, 1} (reg 0) and 2c + 8 + {0, 1} (reg 1).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
mlstm_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ lf,
                 const float* __restrict__ li, bf16* __restrict__ h,
                 bf16* __restrict__ c_out, bf16* __restrict__ n_out,
                 float* __restrict__ m_out, int S, int H, int chunk,
                 float scale) {
  using Plan = MmaPlan<D>;
  constexpr int TW = Plan::TW, KW = Plan::KW, NS = Plan::NS, NT = Plan::NT;
  constexpr int RP = Plan::RP, VP = Plan::VP, CP = Plan::CP;
  constexpr int UN = Plan::UN;
  constexpr int CU = KW / 8;          // 16-byte units of a slice row
  constexpr int RT = CMAX / 16;       // row tiles of the largest chunk
  static_assert(D % KW == 0 && KW % 16 == 0 && TW % 16 == 0, "tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: q, then k
  bf16* Vs = ring + Plan::RING;                    // CMAX x VP: v tile
  float* Cs = reinterpret_cast<float*>(Vs + CMAX * VP);  // D x CP: C
  float* ns = Cs + D * CP;          // D: n
  float* Fs = ns + D;               // F
  float* Ss = Fs + CMAX;            // li, then src
  float* Rs = Ss + CMAX;            // cummax(src)
  float* Ms = Rs + CMAX;            // m_t
  float* CCs = Ms + CMAX;           // carry coefficient exp(F + m_prev - m_t)
  float* SCs = CCs + CMAX;          // source coefficient exp(F_c + src - m_c)
  float* Qn = SCs + CMAX;           // q . n
  float* m_state = Qn + CMAX;       // m carried across chunks
  // the update's K' slice, in the ring's space
  float* Kf = reinterpret_cast<float*>(ring);      // CMAX x KW
  bf16* Khi = reinterpret_cast<bf16*>(Kf + CMAX * KW);  // CMAX x RP
  bf16* Klo = Khi + CMAX * RP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int j0 = blockIdx.x * TW;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const size_t row = (size_t)H * D;                  // one step of q/k/v/h
  const size_t base = ((size_t)b * S * H + hh) * D;  // (b, 0, hh, 0)
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base + j0;
  bf16* hb = h + base + j0;
  const float* lfb = lf + (size_t)b * S * H + hh;
  const float* lib = li + (size_t)b * S * H + hh;
  const int c16 = (chunk + 15) & ~15;   // the chunk padded to 16 rows
  const int r0 = warp * 16;             // this warp's first row

  // ldmatrix lane offsets (bf16 elements): q as A (row lane % 16, column
  // 8 (lane / 16)); k as B of two 8-row n tiles (row lane % 8 +
  // 8 (lane / 16), column 8 (lane / 8 % 2)); v as B of two 8-wide n tiles
  // through .trans (row lane % 8 + 8 (lane / 8 % 2), column 8 (lane / 16));
  // K' as A through .trans, at the same offsets as k (u = lane % 8 +
  // 8 (lane / 16), d = 8 (lane / 8 % 2)); v as B of one n tile through
  // .trans (row lane % 16)
  const int q_lane = (r0 + (lane & 15)) * RP + (lane >> 4) * 8;
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * RP +
                     ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * VP +
                     (lane >> 4) * 8;
  const int v1_lane = (lane & 15) * VP;

  for (int e = tid; e < D * CP; e += THREADS) Cs[e] = 0.f;
  for (int e = tid; e < D; e += THREADS) ns[e] = 0.f;
  if (tid == 0) m_state[0] = NEG;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += chunk) {
    // q and k of d slice i into ring stage st (rows past the chunk zero)
    auto load_slice = [&](int i, int st) {
      bf16* Qs = ring + st * 2 * CMAX * RP;
      bf16* Ks = Qs + CMAX * RP;
      for (int e = tid; e < c16 * CU; e += THREADS) {
        const int t = e / CU, cu = e % CU;
        const bool ok = t < chunk;
        const size_t off = (size_t)(s0 + (ok ? t : 0)) * row + i * KW + cu * 8;
        cp_async16(smem_addr(Qs + t * RP + cu * 8), qb + off, ok);
        cp_async16(smem_addr(Ks + t * RP + cu * 8), kb + off, ok);
      }
    };
    // the v tile and the first slice in one group, in flight over the gates
    for (int e = tid; e < c16 * (TW / 8); e += THREADS) {
      const int t = e / (TW / 8), cu = e % (TW / 8);
      const bool ok = t < chunk;
      cp_async16(smem_addr(Vs + t * VP + cu * 8),
                 vb + (size_t)(s0 + (ok ? t : 0)) * row + cu * 8, ok);
    }
    load_slice(0, 0);
    cp_async_commit();

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

    // ---------------- q k^T, q C (tensor cores) and q . n over D
    const bool rows = r0 < c16;   // this warp has rows of the chunk
    float sacc[2 * RT][4], yacc[NT][4];
#pragma unroll
    for (int j = 0; j < 2 * RT; ++j)
      sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
    // q . n: thread (t = tid / 2, half) sums half of each slice's d
    const int qn_t = tid >> 1, qn_half = tid & 1;
    float dq = 0.f;
    for (int i = 0; i < NS; ++i) {
      // slice i has landed, and every warp is done with slice i - 1, so
      // slice i + 1 goes into the other stage while this one computes
      cp_async_wait<0>();
      __syncthreads();
      if (i + 1 < NS) load_slice(i + 1, (i + 1) & 1);
      cp_async_commit();
      const bf16* Qs = ring + (i & 1) * 2 * CMAX * RP;
      const bf16* Ks = Qs + CMAX * RP;
      const int d0 = i * KW;
      if (qn_t < c16) {
        const bf16* qr = Qs + qn_t * RP + qn_half * (KW / 2);
        const float* nr = ns + d0 + qn_half * (KW / 2);
#pragma unroll
        for (int dd = 0; dd < KW / 2; dd += 2) {
          const float2 qv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qr + dd));
          dq = fmaf(qv.x, nr[dd], dq);
          dq = fmaf(qv.y, nr[dd + 1], dq);
        }
      }
      if (rows) {
        const uint32_t q_addr = smem_addr(Qs + q_lane);
        const uint32_t k_addr = smem_addr(Ks + k_lane);
#pragma unroll
        for (int kk = 0; kk < KW / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, q_addr + kk * 32);
          // causal: n tiles 0 .. 2 warp + 1 (keys below this row tile's end)
#pragma unroll
          for (int np = 0; np < RT; ++np) {
            if (np > warp) break;
            uint32_t kf[4];
            ldmatrix_x4(kf, k_addr + (np * 16 * RP + kk * 16) * 2);
            mma_bf16(sacc[2 * np], a, kf[0], kf[1]);
            mma_bf16(sacc[2 * np + 1], a, kf[2], kf[3]);
          }
          // q C: B fragments of C split into hi and lo as they are loaded
          const float* cr = Cs + (d0 + kk * 16 + c2) * CP + g;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float* cp = cr + nt * 8;
            uint32_t bh0, bl0, bh1, bl1;
            split2(cp[0], cp[CP], bh0, bl0);
            split2(cp[8 * CP], cp[9 * CP], bh1, bl1);
            mma_bf16(yacc[nt], a, bh0, bh1);
            mma_bf16(yacc[nt], a, bl0, bl1);
          }
        }
      }
    }
    dq = __fadd_rn(dq, __shfl_xor_sync(0xffffffffu, dq, 1));
    if (qn_half == 0 && qn_t < CMAX) Qn[qn_t] = dq;
    __syncthreads();   // Qn, and the v tile has landed (waited above)

    // ---------------- weights, W V and h, in this warp's registers
    if (rows) {
      const int t0 = r0 + g, t1 = t0 + 8;
      const float ft0 = Fs[t0], mt0 = Ms[t0];   // past the chunk: unused
      const float ft1 = Fs[t1], mt1 = Ms[t1];
      float oacc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
      float rs0 = 0.f, rs1 = 0.f;
      const uint32_t v_addr = smem_addr(Vs + v_lane);
#pragma unroll
      for (int kk = 0; kk < RT; ++kk) {
        if (kk > warp) break;
        // w o (q k^T) of n tiles 2 kk, 2 kk + 1 in f32; padded rows and
        // keys past the chunk or above the diagonal are 0
        float w[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = e < 2 ? t0 : t1;
            const int u = (2 * kk + jj) * 8 + c2 + (e & 1);
            float x = 0.f;
            if (t < chunk && u <= t)
              x = __fmul_rn(
                  expf(__fsub_rn(__fadd_rn(e < 2 ? ft0 : ft1, Ss[u]),
                                 e < 2 ? mt0 : mt1)),
                  __fmul_rn(sacc[2 * kk + jj][e], scale));
            w[jj][e] = x;
            if (e < 2)
              rs0 = __fadd_rn(rs0, x);
            else
              rs1 = __fadd_rn(rs1, x);
          }
        uint32_t ahi[4], alo[4];
        split2(w[0][0], w[0][1], ahi[0], alo[0]);
        split2(w[0][2], w[0][3], ahi[1], alo[1]);
        split2(w[1][0], w[1][1], ahi[2], alo[2]);
        split2(w[1][2], w[1][3], ahi[3], alo[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_addr + (kk * 16 * VP + np * 16) * 2);
          mma_bf16(oacc[2 * np], ahi, vf[0], vf[1]);
          mma_bf16(oacc[2 * np], alo, vf[0], vf[1]);
          mma_bf16(oacc[2 * np + 1], ahi, vf[2], vf[3]);
          mma_bf16(oacc[2 * np + 1], alo, vf[2], vf[3]);
        }
      }
      // row sums over the quad of lanes that share a row
      rs0 = __fadd_rn(rs0, __shfl_xor_sync(0xffffffffu, rs0, 1));
      rs0 = __fadd_rn(rs0, __shfl_xor_sync(0xffffffffu, rs0, 2));
      rs1 = __fadd_rn(rs1, __shfl_xor_sync(0xffffffffu, rs1, 1));
      rs1 = __fadd_rn(rs1, __shfl_xor_sync(0xffffffffu, rs1, 2));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r == 0 ? t0 : t1;
        if (t >= chunk) continue;
        const float cc = CCs[t];
        const float dsum = __fadd_rn(__fmul_rn(Qn[t], cc), r == 0 ? rs0 : rs1);
        const float den = fmaxf(fabsf(dsum), expf(-Ms[t]));
        bf16* hr = hb + (size_t)(s0 + t) * row + c2;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float n0 =
              __fadd_rn(__fmul_rn(yacc[nt][2 * r], cc), oacc[nt][2 * r]);
          const float n1 = __fadd_rn(__fmul_rn(yacc[nt][2 * r + 1], cc),
                                     oacc[nt][2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(hr + nt * 8) =
              __floats2bfloat162_rn(n0 / den, n1 / den);
        }
      }
    }

    // ---------------- C, n to the end of the chunk, one d slice at a time
    const float stc = expf(__fsub_rn(__fadd_rn(f_all, m_prev), m_last));
    const int n16 = c16 / 16;
    for (int i = 0; i < NS; ++i) {
      const int d0 = i * KW;
      __syncthreads();   // the ring (slice i - 1's K') is free
      for (int e = tid; e < c16 * CU; e += THREADS) {   // (k * scale) * sc
        const int t = e / CU, cu = e % CU;
        float x[8];
        if (t < chunk) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              kb + (size_t)(s0 + t) * row + d0 + cu * 8);
          const __nv_bfloat162* p =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float sc = SCs[t];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(p[j]);
            x[2 * j] = __fmul_rn(__fmul_rn(f.x, scale), sc);
            x[2 * j + 1] = __fmul_rn(__fmul_rn(f.y, scale), sc);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) x[j] = 0.f;
        }
        float4* kf = reinterpret_cast<float4*>(Kf + t * KW + cu * 8);
        kf[0] = make_float4(x[0], x[1], x[2], x[3]);
        kf[1] = make_float4(x[4], x[5], x[6], x[7]);
        uint4 hi, lo;
        split2(x[0], x[1], hi.x, lo.x);
        split2(x[2], x[3], hi.y, lo.y);
        split2(x[4], x[5], hi.z, lo.z);
        split2(x[6], x[7], hi.w, lo.w);
        *reinterpret_cast<uint4*>(Khi + t * RP + cu * 8) = hi;
        *reinterpret_cast<uint4*>(Klo + t * RP + cu * 8) = lo;
      }
      __syncthreads();
      // K'^T v: this warp's (16-row d tile, UN n tiles) of the slice
      if (warp * UN < Plan::UT) {
        const int tile = warp * UN;
        const int mt = tile / NT, nt0 = tile % NT;
        float acc[UN][4];
#pragma unroll
        for (int e = 0; e < UN; ++e)
          acc[e][0] = acc[e][1] = acc[e][2] = acc[e][3] = 0.f;
        const uint32_t hi_addr = smem_addr(Khi + k_lane + mt * 16);
        const uint32_t lo_addr = smem_addr(Klo + k_lane + mt * 16);
        const uint32_t vb_addr = smem_addr(Vs + v1_lane + nt0 * 8);
        for (int kk = 0; kk < n16; ++kk) {
          uint32_t ahi[4], alo[4];
          ldmatrix_x4_trans(ahi, hi_addr + kk * 16 * RP * 2);
          ldmatrix_x4_trans(alo, lo_addr + kk * 16 * RP * 2);
#pragma unroll
          for (int e = 0; e < UN; ++e) {
            uint32_t bv[2];
            ldmatrix_x2_trans(bv, vb_addr + (kk * 16 * VP + e * 8) * 2);
            mma_bf16(acc[e], ahi, bv[0], bv[1]);
            mma_bf16(acc[e], alo, bv[0], bv[1]);
          }
        }
#pragma unroll
        for (int e = 0; e < UN; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2* cp = reinterpret_cast<float2*>(
                Cs + (d0 + mt * 16 + g + 8 * r) * CP + (nt0 + e) * 8 + c2);
            float2 cv = *cp;
            cv.x = __fadd_rn(__fmul_rn(cv.x, stc), acc[e][2 * r]);
            cv.y = __fadd_rn(__fmul_rn(cv.y, stc), acc[e][2 * r + 1]);
            *cp = cv;
          }
      }
      if (tid < KW) {
        float acc = 0.f;
        for (int u = 0; u < chunk; ++u) acc = __fadd_rn(acc, Kf[u * KW + tid]);
        ns[d0 + tid] = __fadd_rn(__fmul_rn(ns[d0 + tid], stc), acc);
      }
    }
    if (tid == 0) m_state[0] = m_last;
    __syncthreads();
  }

  // ---------------- final state
  const size_t bh = (size_t)b * H + hh;
  for (int e = tid; e < D * TW; e += THREADS) {
    const int d = e / TW, j = e % TW;
    c_out[(bh * D + d) * D + j0 + j] = __float2bfloat16_rn(Cs[d * CP + j]);
  }
  if (blockIdx.x == 0) {
    for (int e = tid; e < D; e += THREADS)
      n_out[bh * D + e] = __float2bfloat16_rn(ns[e]);
    if (tid == 0) m_out[bh] = m_state[0];
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_simt(const void* q, const void* k, const void* v, const float* lf,
                const float* li, void* h, void* c, void* n, float* m, int B,
                int S, int H, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Tile<D>::smem_floats;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(D / Tile<D>::TW, H, B);
  mlstm_simt_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lf, li, static_cast<float*>(h),
      static_cast<float*>(c), static_cast<float*>(n), m, S, H, chunk, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const float* lf,
               const float* li, void* h, void* c, void* n, float* m, int B,
               int S, int H, int chunk, float scale, cudaStream_t stream) {
  const int smem = MmaPlan<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(D / MmaPlan<D>::TW, H, B);
  mlstm_mma_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lf, li, static_cast<bf16*>(h),
      static_cast<bf16*>(c), static_cast<bf16*>(n), m, S, H, chunk, scale);
  return (int)cudaGetLastError();
}

int dispatch_d(const void* q, const void* k, const void* v, const float* lf,
               const float* li, void* h, void* c, void* n, float* m, int B,
               int S, int H, int D, int chunk, float scale, int dtype,
               cudaStream_t stream) {
#define MLSTM_CASE(DD)                                                       \
  case DD:                                                                   \
    return dtype == 0 ? launch_simt<DD>(q, k, v, lf, li, h, c, n, m, B, S, H, \
                                        chunk, scale, stream)                \
                      : launch_mma<DD>(q, k, v, lf, li, h, c, n, m, B, S, H,  \
                                       chunk, scale, stream);
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
// 1 = bfloat16 (q, k, v, h, c, n; 16-byte aligned). Needs 1 <= chunk <= 128
// and S % chunk == 0. Returns a cudaError_t (0 = launched).
extern "C" int mlstm_fwd(const void* q, const void* k, const void* v,
                         const float* lf, const float* li, void* h, void* c,
                         void* n, float* m, int B, int S, int H, int D,
                         int chunk, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 || chunk <= 0 ||
      chunk > CMAX || S % chunk != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                     (uintptr_t)h) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  return dispatch_d(q, k, v, lf, li, h, c, n, m, B, S, H, D, chunk, scale,
                    dtype, static_cast<cudaStream_t>(stream));
}

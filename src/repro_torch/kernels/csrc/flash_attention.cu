// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the Pallas TPU kernel _attn_kernel). Same function: online-softmax
// attention over KV tiles with GQA (kv head = h / group), causal and
// sliding-window masks, gemma-style logit softcap, q_offset and a ragged
// key length; f32 running max / sum / accumulator; masked scores are -1e30
// and the final denominator is max(l, 1e-30), as in the TPU kernel.
//
// Row statistics for the backward: when the m / l pointers are not null,
// each kernel also writes, per (b, row, head), m = the row max of the
// scaled, soft-capped, masked scores and l = sum exp(s - m), in f32 and in
// the natural-log convention of the reference's _flash_fwd (the bf16
// kernel keeps its running max in the log2 domain and converts it once, at
// the end). Writing them changes nothing of o: a launch with stats gives
// the same bits of o as one without.
//
// Two kernels, chosen by dtype:
//  * bfloat16 (every full-width path): flash_mma_kernel, both products on
//    the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//  * float32: flash_simt_kernel, both products in f32 on the CUDA cores.
//    The tensor cores would take f32 as TF32 (about three decimal digits),
//    which the reference's f32 tolerance of 2e-5 rules out; no full-width
//    path runs f32 attention.
//
// What bounds it on this card, at three serving prefill shapes:
//  * starcoder2-3b (B=4, S=512, H=24, KV=2, D=128, causal): q/k/v/o are
//    27.3 MB (8.1 us at 3.35 TB/s) and the two products over the causal
//    (q, k) pairs 6.46 GFLOP (6.5 us at 989 TFLOP/s): bytes, by a little.
//  * recurrentgemma-9b (B=4, S=3072, H=16, KV=1, D=256, causal, window
//    2048): 275 GFLOP over the 268.5 M visible pairs (0.278 ms) against
//    214 MB (0.064 ms): operations.
//  * deepseek-v3-671b (B=4, S=4096, H=KV=128, D=192, causal): 3.299 TFLOP
//    over the 4.30 G causal pairs (3.336 ms) against 3.22 GB (0.961 ms):
//    operations. A third of the P V product multiplies V's zero padding.
// All are far from the CUDA cores' f32 rate (67 TFLOP/s, and about 17
// reached out of shared memory), so the bf16 kernel's design is about
// feeding the tensor cores:
//  * Tiles. One block of 4 warps owns one (b, q head, 64-row q tile); each
//    warp owns 16 q rows and walks the KV tiles itself, with m, l and its
//    16 x D accumulator in registers. Q tiles launch in reverse order
//    (blockIdx.y = 0 is the last tile), so the blocks with the most causal
//    keys start first. KV tiles that the causal / window masks hide from
//    every row of the q tile are not visited (a fully masked tile would add
//    exp(-1e30 - m) = 0), and the masks are applied elementwise only on the
//    tiles that straddle the diagonal, the window edge or Sk.
//  * Shared memory. Q, K and V are staged as bf16 (half the bytes of f32),
//    K and V through a two-stage ring filled with cp.async (16 bytes a
//    thread, rows past Sk zero-filled): after the barrier that opens tile
//    t (its copies have landed, and every warp is done with tile t - 1),
//    tile t + 1 is issued into the other stage and is in flight while t
//    computes; one barrier a tile. Rows are padded by 16 bytes: a row of D
//    bf16 is then an odd number of 16-byte units (D / 8 + 1), so the 8 rows
//    one ldmatrix phase reads fall in 8 different bank groups.
//  * Products. S = Q K^T with Q as the A operand (ldmatrix) and K as the
//    col-major B operand (ldmatrix of K's rows); S is scaled by d^-0.5 *
//    log2(e) in f32 (scores live in the log2 domain and exp2f replaces
//    expf; q is not pre-scaled in bf16), then softcapped and masked. The
//    row max and row sum are over the row's quad of lanes (two shuffles).
//    P = exp2(S - m) is rounded to bf16 in registers and used directly as
//    the A operand of P V: the m16n8k16 accumulator layout of two 8-key
//    tiles is the A-fragment layout of one 16-key step, so P never touches
//    shared memory. V is the B operand through ldmatrix.trans. l sums the
//    f32 P.
//  * Output. Each row is scaled by one reciprocal of max(l, 1e-30) (2 D
//    IEEE divisions a thread were a visible part of a short block's time),
//    and the warp's 16 x D result goes through its own Q rows in shared
//    memory and leaves as 16-byte stores, whole rows at a time.
//  * Determinism. No atomics; every sum has a fixed order.
//  * Resources (128 threads a block; per-SM limits 227 KB, 64 K registers):
//      D = 128: BK = 32, (64 + 2 x 2 x 32) rows x 272 bytes = 52,224 bytes,
//               3 blocks (12 warps) an SM (launch bounds cap registers at
//               168); accumulator 64 f32 a thread, S 16.
//      D = 192: BK = 32, (64 + 2 x 2 x 32) rows x 400 bytes = 76,800 bytes,
//               2 blocks (8 warps) an SM; accumulator 96 f32 a thread, S
//               16; rows of 200 bf16 are 25 16-byte units (odd, as at
//               D = 80), 12 sixteen-wide k steps of S = Q K^T.
//               deepseek-v3-671b's MLA prefill: q / k head dim 128 + 64,
//               V zero-padded from 128 by the caller.
//      D = 256: BK = 32, (64 + 2 x 2 x 32) rows x 528 bytes = 101,376 bytes,
//               2 blocks (8 warps) an SM; accumulator 128 f32 a thread, S
//               16.
//      D = 16 .. 80: BK = 64, 15,360 to 56,320 bytes, 2 blocks an SM
//               (D = 80, h2o-danube-1.8b's head dim: rows of 88 bf16, 11
//               16-byte units, and 5 k steps of S = Q K^T, odd as at
//               D = 48; accumulator 40 f32 a thread, S 32).
//    Every instance reloads its Q fragments from shared memory at every k
//    step instead of holding them (at D = 192 and 256 they would take 48
//    and 64 more registers a thread).
//    Registers and spills per instance: `[ptxas flash_attention]` in
//    chip_smoke.py's output (PERF.md keeps them). At D = 128, BK = 32 with
//    3 blocks an SM beat BK = 64 with 2 on the card: S = 512 gives short
//    blocks (1 to 16 tiles), whose first load and epilogue the third block
//    hides.
//
// The f32 kernel: 256 threads as a 16 x 16
// grid; thread (ty, tx) owns q rows ty + 16 i (i < 4) and, per KV tile, key
// columns tx + 16 j (j < 4) of the score tile and output columns tx + 16 j
// (j < D / 16) of the accumulator. Q (pre-scaled by d^-0.5 in f32), K and V
// tiles are staged as f32 with a row pitch of D + 1 words (214,016 bytes at
// D = 256, one block an SM), P goes through shared memory, loads are
// synchronous. At D = 192: 4 x (64 x 193 + 2 x 64 x 193 + 64 x 65) =
// 164,864 bytes, one block an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ------------------------------------------------------------------ f32

constexpr int SIMT_BQ = 64;        // q rows per block
constexpr int SIMT_BK = 64;        // keys per KV tile
constexpr int SIMT_THREADS = 256;  // 16 x 16

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int Sq, int Sk, int H, int KV, int causal, int window,
                  float softcap, float scale, int q_offset) {
  constexpr int BQ = SIMT_BQ, BK = SIMT_BK, THREADS = SIMT_THREADS;
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
  const float* qb = q + ((size_t)b * Sq * H + h) * D;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * D;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * D;

  // stage the q tile, scaled in f32 (rows past Sq are zero, never stored)
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = q0 + r;
    Qs[r * P + d] = row < Sq ? qb[(size_t)row * q_row_stride + d] * scale
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
      Ks[r * P + d] = ok ? kb[(size_t)key * k_row_stride + d] : 0.f;
      Vs[r * P + d] = ok ? vb[(size_t)key * k_row_stride + d] : 0.f;
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

  float* ob = o + ((size_t)b * Sq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)row * q_row_stride + tx + 16 * j] = acc[i][j] / den;
    if (m_out != nullptr && tx == 0) {
      const size_t r = ((size_t)b * Sq + row) * H + h;
      m_out[r] = m[i];
      l_out[r] = l[i];
    }
  }
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* m_out, float* l_out, int B, int Sq, int Sk, int H,
                int KV, int causal, int window, float softcap, float scale,
                int q_offset, cudaStream_t stream) {
  constexpr int P = D + 1;
  const size_t smem = sizeof(float) * ((size_t)SIMT_BQ * P +
                                       2 * (size_t)SIMT_BK * P +
                                       (size_t)SIMT_BQ * (SIMT_BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_simt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + SIMT_BQ - 1) / SIMT_BQ, H, B);
  flash_simt_kernel<D><<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), m_out, l_out, Sq,
      Sk, H, KV, causal, window, softcap, scale, q_offset);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- bf16

typedef __nv_bfloat16 bf16;

template <int D>
struct MmaPlan {
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;                // q rows per block
  static constexpr int BK = D >= 128 ? 32 : 64;        // keys per KV tile
  static constexpr int BLOCKS_PER_SM = D == 128 ? 3 : 2;
  static constexpr int STAGES = 2;                     // ring of (K, V) tiles
  static constexpr int PITCH = D + 8;                  // bf16 per smem row
  static constexpr int SMEM =
      (int)sizeof(bf16) * (BQ + STAGES * 2 * BK) * PITCH;
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

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Fragment layouts (g = lane / 4, c = lane % 4): an m16n8 f32 tile holds
// rows g (regs 0, 1) and g + 8 (regs 2, 3) at columns 2c + {0, 1}; an A
// operand (16 x 16) holds rows g / g + 8 at columns 2c + {0, 1} (regs 0, 1)
// and 2c + 8 + {0, 1} (regs 2, 3); a B operand (16 x 8) holds column g at
// rows 2c + {0, 1} (reg 0) and 2c + 8 + {0, 1} (reg 1).
template <int D>
__global__ void __launch_bounds__(MmaPlan<D>::THREADS,
                                  MmaPlan<D>::BLOCKS_PER_SM)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int Sq,
                 int Sk, int H, int KV, int causal, int window, float softcap,
                 float scale, int q_offset) {
  using Plan = MmaPlan<D>;
  constexpr int THREADS = Plan::THREADS, BQ = Plan::BQ, BK = Plan::BK;
  constexpr int PITCH = Plan::PITCH;
  constexpr int CH = D / 8;    // 16-byte chunks of a row = 8-wide d tiles
  constexpr int NT = BK / 8;   // 8-key tiles of S
  static_assert(D % 16 == 0 && BK % 16 == 0, "16-wide k steps");
  static_assert((BQ * CH) % THREADS == 0 && (BK * CH) % THREADS == 0,
                "whole 16-byte chunks per thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x PITCH
  bf16* KVs = Qs + BQ * PITCH;  // stage s: K, then V, BK x PITCH each

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tile first
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kvh = h / (H / KV);

  const size_t q_row_stride = (size_t)H * D;
  const size_t k_row_stride = (size_t)KV * D;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * KV + kvh) * D;
  const bf16* vb = v + ((size_t)b * Sk * KV + kvh) * D;

  // KV tiles that hold at least one key visible to some row of this tile
  const int qlo = q0 + q_offset;
  const int qhi = min(q0 + BQ, Sq) - 1 + q_offset;
  int k_end = Sk;
  if (causal) k_end = min(k_end, qhi + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, qlo - window + 1);
  const int t_begin = k_begin / BK;
  const int n_tiles = k_end > k_begin ? (k_end + BK - 1) / BK - t_begin : 0;

  auto load_kv = [&](int t, int stage) {
    bf16* Ks = KVs + stage * 2 * BK * PITCH;
    bf16* Vs = Ks + BK * PITCH;
#pragma unroll
    for (int i = 0; i < BK * CH / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / CH, c = e % CH;
      const int key = t * BK + r;
      const bool ok = key < Sk;
      const size_t off = (size_t)(ok ? key : 0) * k_row_stride + c * 8;
      cp_async16(smem_addr(Ks + r * PITCH + c * 8), kb + off, ok);
      cp_async16(smem_addr(Vs + r * PITCH + c * 8), vb + off, ok);
    }
  };

  // the q tile (rows past Sq zero-filled, never stored) and the first KV
  // tile in one group
#pragma unroll
  for (int i = 0; i < BQ * CH / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / CH, c = e % CH;
    const int row = q0 + r;
    const bool ok = row < Sq;
    cp_async16(smem_addr(Qs + r * PITCH + c * 8),
               qb + (size_t)(ok ? row : 0) * q_row_stride + c * 8, ok);
  }
  if (n_tiles > 0) load_kv(t_begin, 0);
  cp_async_commit();

  // this thread's rows of the warp's 16 and their absolute positions
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int qpos0 = q0 + warp * 16 + g + q_offset, qpos1 = qpos0 + 8;
  // ldmatrix row addresses: Q as A (row lane % 16, column 8 (lane / 16));
  // K as B of two 8-key tiles (key lane % 8 + 8 (lane / 16), column
  // 8 (lane / 8 % 2)); V as B of two 8-wide d tiles through .trans (key
  // lane % 8 + 8 (lane / 8 % 2), column 8 (lane / 16))
  const uint32_t q_addr =
      smem_addr(Qs + (warp * 16 + (lane & 15)) * PITCH + (lane >> 4) * 8);
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * PITCH +
                     ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * PITCH +
                     (lane >> 4) * 8;
  const float scale_log2 = scale * LOG2E;

  float acc[CH][4];
#pragma unroll
  for (int j = 0; j < CH; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_begin + i) * BK;
    const int stage = i & 1;
    // this tile has landed, and every warp is done with the previous one,
    // so the next tile goes into the other stage while this one computes
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_tiles) load_kv(t_begin + i + 1, stage ^ 1);
    cp_async_commit();
    const bf16* Ks = KVs + stage * 2 * BK * PITCH;
    const uint32_t k_addr = smem_addr(Ks + k_lane);
    const uint32_t v_addr = smem_addr(Ks + BK * PITCH + v_lane);

    // S = Q K^T (16 x BK per warp)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, k_addr + (np * 16 * PITCH + kk * 16) * 2);
        mma_bf16(s[2 * np], a, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // scale (and softcap) in f32, into the log2 domain
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = softcap != 0.f
                      ? tanhf(s[j][e] * scale / softcap) * softcap * LOG2E
                      : s[j][e] * scale_log2;
    // masks, only on tiles that straddle Sk, the diagonal or the window
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qlo) ||
                      (window && k0 <= qhi - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + c2 + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool keep = kpos < Sk;
          if (causal) keep = keep && kpos <= qpos;
          if (window) keep = keep && kpos > qpos - window;
          if (!keep) s[j][e] = NEG_INF;
        }
    }

    // online softmax; a row's 16 x BK scores sit in its quad of lanes
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // l is this lane's part of the row sum; the quad adds its parts once,
    // at the end (alpha is the same in all four lanes)
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }
    // P in bf16 as A fragments: 16-key step kk is S tiles 2 kk, 2 kk + 1
    uint32_t p[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2f(s[j][0] - mx0), p1 = exp2f(s[j][1] - mx0);
      const float p2 = exp2f(s[j][2] - mx1), p3 = exp2f(s[j][3] - mx1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      p[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      p[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // acc += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_addr + (kk * 16 * PITCH + dp * 16) * 2);
        mma_bf16(acc[2 * dp], p[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], p[kk], vf[2], vf[3]);
      }
  }

  cp_async_wait<0>();  // no copy into Qs is still in flight (with no KV
  __syncthreads();     // tile, the q tile's copies were never waited for)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // one reciprocal a row instead of 2 D IEEE divisions a thread
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (m_out != nullptr && (lane & 3) == 0) {
    // the quad's lanes hold the same m and l; natural-log m, f32
    const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
    const size_t r0 = ((size_t)b * Sq + row0) * H + h;
    const size_t r1 = ((size_t)b * Sq + row1) * H + h;
    if (row0 < Sq) {
      m_out[r0] = m0 * LN2;
      l_out[r0] = l0;
    }
    if (row1 < Sq) {
      m_out[r1] = m1 * LN2;
      l_out[r1] = l1;
    }
  }

  // the warp's 16 rows through its own rows of Qs (only this warp reads
  // them), then whole rows as 16-byte stores
  __syncwarp();
  bf16* Os = Qs + warp * 16 * PITCH;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    *reinterpret_cast<uint32_t*>(Os + g * PITCH + j * 8 + c2) =
        pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * PITCH + j * 8 + c2) =
        pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  __syncwarp();
  bf16* ob = o + ((size_t)b * Sq * H + h) * D;
#pragma unroll
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    const int row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(ob + (size_t)row * q_row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(Os + r * PITCH + c * 8);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* m_out, float* l_out, int B, int Sq, int Sk, int H,
               int KV, int causal, int window, float softcap, float scale,
               int q_offset, cudaStream_t stream) {
  using Plan = MmaPlan<D>;
  const int q_tiles = (Sq + Plan::BQ - 1) / Plan::BQ;
  if (q_tiles > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Plan::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_mma_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, q_tiles);
  flash_mma_kernel<D><<<grid, Plan::THREADS, Plan::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), m_out, l_out, Sq,
      Sk, H, KV, causal, window, softcap, scale, q_offset);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* m_out, float* l_out, int B, int Sq, int Sk, int H,
               int KV, int D, int causal, int window, float softcap,
               float scale, int q_offset, cudaStream_t stream) {
#define FLASH_CASE(DD)                                                       \
  case DD:                                                                   \
    return BF16 ? launch_mma<DD>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, \
                                 causal, window, softcap, scale, q_offset,   \
                                 stream)                                     \
                : launch_simt<DD>(q, k, v, o, m_out, l_out, B, Sq, Sk, H,    \
                                  KV, causal, window, softcap, scale,        \
                                  q_offset, stream);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(128)
    FLASH_CASE(192)
    FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Sk, KV, D), o: (B, Sq, H, D), all contiguous
// (bf16: 16-byte aligned), dtype 0 = float32, 1 = bfloat16; m / l: null,
// or both (B, Sq, H) float32 for the row statistics. Returns a cudaError_t
// (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* m, void* l,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int D, int dtype, int causal, int window,
                                   float softcap, float scale, int q_offset,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (m == nullptr) != (l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m_out = static_cast<float*>(m);
  float* l_out = static_cast<float*>(l);
  if (dtype == 0)
    return dispatch_d<false>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, D,
                             causal, window, softcap, scale, q_offset, s);
  if (dtype == 1)
    return dispatch_d<true>(q, k, v, o, m_out, l_out, B, Sq, Sk, H, KV, D,
                            causal, window, softcap, scale, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

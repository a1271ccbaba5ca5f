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
// Three launches, no atomics: a D pre-pass (flash_bwd_delta_kernel, one
// warp a row), then a dk / dv kernel with one block per (key tile, kv head,
// b) that walks the H / KV query heads of its group and, per head, the q
// tiles whose rows can see a key of the tile (causal and window bounds),
// and a dq kernel with one block per (q tile, head, b) that walks the
// visible key tiles. Both recompute S and dP, which is what keeps dk, dv
// and dq free of atomics: dk and dv stay in registers and are written once,
// as dq is. Every sum runs in a fixed order, so two launches on the same
// inputs give the same bits (the training restart is checked bit for bit).
// Outputs are rounded once to the input type, as the reference casts them.
//
// Which kernels take what, chosen in the C entry point:
//  * bfloat16 at every D, {16, 32, 48, 64, 80, 128, 192, 256} (every
//    training path; the starcoder2-3b and deepseek-coder-33b shapes are
//    D = 128, h2o-danube-1.8b's D = 80, deepseek-v3-671b's MLA 192 (q / k
//    128 + 64, V zero-padded from 128), recurrentgemma-9b's and gemma3-4b's
//    256): flash_bwd_mma_dkdv_kernel<D> and flash_bwd_mma_dq_kernel<D>,
//    every tile product on the tensor cores (mma.sync m16n8k16, bf16 in,
//    f32 accumulate), below. At D = 192 and 256 a dk / dv block
//    accumulates dk or dv, not both (SPLIT).
//  * float32 at every D: flash_bwd_dkdv_kernel<D> and
//    flash_bwd_dq_kernel<D>, every product in f32 on the CUDA
//    cores. The tensor cores would take f32 as TF32, which the reference's
//    f32 tolerance of 2e-5 rules out.
//
// What bounds it on this card, at the training shape of starcoder2-3b
// (B = 8, S = 2048, H = 24, KV = 2, D = 128, bf16, causal): the five
// products over the 50.4 M causal (q, k) pairs of each (b, h) are 515 GFLOP
// (0.52 ms at the 989 TFLOP/s of the bf16 tensor cores) against 0.44 GB of
// inputs and outputs (0.13 ms at 3.35 TB/s): operations. The tensor-core
// kernels do about twice that work (S and dP in both kernels, and P and dS
// each enter their products as two bf16 operands); their time is in
// PERF.md.
//
// The tensor-core kernels (128 threads, 4 warps, 16 rows of the output a
// warp; the bf16 forward in csrc/flash_attention.cu solves the same feeding
// problem and the two share their fragment layouts):
//  * Numerics. S and dP are exact products of bf16 inputs summed in f32.
//    P and dS are f32 values that must become bf16 A operands; one rounding
//    of P moves dv by more than one bf16 ulp (dv sums over every query of a
//    12-head group), so each is split, x = bf16(x) + bf16(x - bf16(x)), and
//    enters its product twice (hi, then lo, into one f32 accumulator), as
//    mlstm.cu splits its f32 operands. tests/test_torch_flash_bwd.py
//    emulates these roundings on the CPU. p, dp - D, the softcap factor and
//    the scale are applied in f32 in the reference's order of operations;
//    the exp is 2^(x log2 e - m log2 e) on ex2.approx (m log2 e formed once
//    a row), since the library's expf (a range reduction around the same
//    instruction) made the pair 11% slower at the training shape, and its
//    error (a few f32 ulp of p) is far below one bf16 ulp of the outputs.
//  * dk / dv (flash_bwd_mma_dkdv_kernel): a block owns 64 keys of one kv
//    head, a warp 16 of them, and computes the transposed tiles S^T = K Q^T
//    and dP^T = V dO^T, so keys are the accumulator's rows and a warp needs
//    no other warp's scores. K and V are the A operands (ldmatrix), Q and
//    dO rows the B operands (ldmatrix of their rows). m, 1 / max(l, 1e-30)
//    and D are per column there, read from row vectors staged per q step.
//    P^T and dS^T are formed and split in registers: two adjacent 8-column
//    accumulator tiles are one 16-wide A fragment (the forward's trick for
//    P), so dv += P^T dO and dk += dS^T Q take dO and Q as B operands
//    through ldmatrix.trans and P, dS never touch shared memory. Q and dO
//    (and the row vectors) come through a two-stage ring: the step after
//    the current one is in flight while it computes. Key tiles launch in
//    order of their causal work, tile 0 (every q tile sees it) of every
//    (kv head, b) first.
//  * dq (flash_bwd_mma_dq_kernel): a block owns 64 q rows of one head, Q
//    and dO resident, K and V through a two-stage ring; S = Q K^T and
//    dP = dO V^T as in the forward, dS formed and split in registers and
//    dq += dS K with K through ldmatrix.trans. The last q tile (the most
//    causal keys) of every (b, head) launches first.
//  * Staging. bf16 rows padded by 16 bytes (PITCH = D + 8: a row is an odd
//    number of 16-byte units, so the 8 rows one ldmatrix phase reads fall
//    in 8 different bank groups), filled by 16-byte cp.async with rows past
//    Sq or Sk zero-filled; the wrapper refuses pointers that are not 16-byte
//    aligned, and the entry point returns an error for them.
//  * Masks. Tiles the masks hide from every pair of a block are not
//    visited; a warp whose 16 rows see no column of a tile skips its
//    products; causal, window, q_offset, Sq and Sk are applied elementwise
//    only where a warp's tile straddles one of those edges.
//  * Resources (per-SM limits 227 KB shared memory, 64 K registers), at
//    D = 128: dk / dv walks q steps of 64 rows: K and V 2 x 64 x 272 bytes,
//    the (Q, dO) ring 2 x 2 x 64 x 272, row vectors 2 x 3 x 64 x 4: 105,984
//    bytes, 2 blocks an SM (launch bounds cap registers at 255). dk and dv
//    take 128 f32 accumulators a thread, so a step's scores are formed 16
//    queries at a time (the sum runs over the same 16-query k steps in the
//    same order): all 64 at once spilled, 32-row steps were 2% slower.
//    dq uses 32-key tiles: Q and dO 2 x 64 x 272, the (K, V) ring 2 x 2 x
//    32 x 272: 69,632 bytes, 3 blocks an SM (registers capped at 168; 2
//    blocks, or 64-key tiles, were 18% slower). At D <= 80 dk / dv forms
//    the scores of a whole 64-row step at once (D = 80: 244 registers, no
//    spill, 9% faster than 16 queries at a time), 2 blocks an SM; dq at
//    D = 80 takes D = 128's 32-key tiles at 3 blocks an SM (158 registers;
//    64-key tiles at 2 blocks were 18% slower), at D <= 64 64-key tiles at
//    2 blocks. D = 80 rows are 88 bf16, 11 16-byte units: dk / dv 69,120
//    bytes, dq 45,056 bytes a block.
//  * D = 256. A warp's 16 keys of both dk and dv would be 2 x 16 x 256 f32,
//    256 accumulators a thread (255 registers at most), so the dk / dv
//    launch holds two blocks a key tile (SPLIT): a dv block forms S^T and
//    P^T and adds P^T dO, a dk block forms S^T, dP^T and dS^T and adds
//    dS^T Q; each holds 128 accumulators, as D = 128 does. That costs one
//    more S product (11 tile products where D <= 128 does 10) and a second
//    read of Q and dO, and doubles the blocks: B x KV x Sk / 64 is 256 at
//    recurrentgemma-9b's KV = 1, about one block an SM of a 132-SM card,
//    and the heaviest (key tile 0, every q row of 16 heads) then set the
//    time. Rows are 264 bf16 (528 bytes, 33 16-byte units). dk / dv: K, V
//    2 x 64 x 528 bytes, (Q, dO) ring 2 x 2 x 16 x 528 (q steps of 16
//    rows), row vectors 2 x 3 x 16 x 4: 101,760 bytes, 2 blocks an SM (a
//    64-row ring would be 204,288 bytes, 1 block). dq: Q and dO 2 x 64 x
//    528, the (K, V) ring 2 x 2 x 16 x 528 (16-key tiles): 101,376 bytes,
//    2 blocks an SM; dq takes 128 accumulators a thread.
//  * D = 192 takes D = 256's plan: dk and dv in blocks of their own (96
//    accumulators a thread each), q steps of 16 rows, dq over 16-key
//    tiles. Rows are 200 bf16 (400 bytes, 25 16-byte units, so ldmatrix
//    stays conflict-free). dk / dv: 2 x 64 x 400 + 2 x 2 x 16 x 400 +
//    2 x 3 x 16 x 4 = 77,184 bytes, dq: 2 x 64 x 400 + 2 x 2 x 16 x 400 =
//    76,800 bytes, 2 blocks an SM each (a third dk / dv block would pass
//    the SM's 228 KB with its 1 KB reserve).
//    Registers and spills per instance: `[ptxas flash_attention_bwd]` in
//    chip_smoke.py's output (PERF.md keeps them); the tile and exp
//    variants: `python -m repro_torch.kernels.tune_flash_bwd`.
//
// The CUDA-core kernels (f32 only): 256 threads as a 16 x 16 grid (ty, tx).
// In a tile product a thread owns rows ty + 16 i and columns tx + 16 j, so
// a warp reads two rows of one operand (a broadcast) and 16 rows of the
// other at a row pitch of D + 1 words (16 banks). Tiles of 64 q rows x 64
// keys for D <= 128, 32 x 32 for D = 192 and 256; shared memory a block
// (f32 staging, four (rows x (D + 1)) tiles, two (BQ x (BK + 1)) score
// tiles, three row vectors): D = 128 166,144 bytes, D = 192 107,648 bytes,
// D = 256 140,416 bytes, so one block an SM (two at D = 192). P and dS go
// through shared memory and loads are synchronous.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

typedef __nv_bfloat16 bf16;

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

// rows [r0, r0 + ROWS) of a (rows, stride) f32 matrix, columns [0, D),
// into a tile of pitch D + 1; rows past n are zero
template <int D, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int n, size_t stride) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] = row < n ? src[(size_t)row * stride + d] : 0.f;
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
      g = __bfloat162float(static_cast<const bf16*>(dout)[base + d]);
      x = __bfloat162float(static_cast<const bf16*>(o)[base + d]);
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ m,
                      const float* __restrict__ l,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int H,
                      int KV, Masks mk) {
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
      dk[off + tx + 16 * j] = adk[i][j];
      dv[off + tx + 16 * j] = adv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ delta, float* __restrict__ dq,
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
    for (int j = 0; j < DJ; ++j) dq[off + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* m, const float* l, const float* delta, void* dq,
           void* dk, void* dv, int B, int H, int KV, const Masks& mk,
           cudaStream_t stream) {
  using Plan = BwdPlan<D>;
  const int q_tiles = (mk.Sq + Plan::BQ - 1) / Plan::BQ;
  const int k_tiles = (mk.Sk + Plan::BK - 1) / Plan::BK;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Plan::SMEM);
  if (err != cudaSuccess) return (int)err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  flash_bwd_dkdv_kernel<D>
      <<<dim3(k_tiles, KV, B), THREADS, Plan::SMEM, stream>>>(
          qt, kt, vt, gt, m, l, delta, static_cast<float*>(dk),
          static_cast<float*>(dv), H, KV, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D>
      <<<dim3(q_tiles, H, B), THREADS, Plan::SMEM, stream>>>(
          qt, kt, vt, gt, m, l, delta, static_cast<float*>(dq), H, KV, mk);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16 on the tensor cores

template <int D>
struct MmaBwdPlan {
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int PITCH = D + 8;  // bf16 per smem row
  // dk / dv: 16 keys a warp; q steps of KV_BQ rows through a 2-stage
  // ring, their scores formed KV_QS queries at a time. SPLIT: dk and dv
  // in blocks of their own (a warp's 16 keys of both would take 2 D f32
  // accumulators a thread, 512 at D = 256)
  static constexpr bool SPLIT = D > 128;
  static constexpr int KV_BK = 16 * WARPS;
  static constexpr int KV_BQ = D > 128 ? 16 : 64;
  static constexpr int KV_QS = D == 128 ? 16 : KV_BQ;
  static constexpr int KV_SMEM =
      (int)sizeof(bf16) * (2 * KV_BK + 2 * 2 * KV_BQ) * PITCH +
      (int)sizeof(float) * 2 * 3 * KV_BQ;
  // dq: 16 q rows a warp; key tiles of Q_BK through a 2-stage ring
  static constexpr int Q_BQ = 16 * WARPS;
  static constexpr int Q_BK = D > 128 ? 16 : D >= 80 ? 32 : 64;
  static constexpr int Q_BLOCKS = D > 128 ? 2 : D >= 80 ? 3 : 2;
  static constexpr int Q_SMEM =
      (int)sizeof(bf16) * (2 * Q_BQ + 2 * 2 * Q_BK) * PITCH;
  static_assert(D % 16 == 0 && (D <= 128 || D == 192 || D == 256),
                "16-wide k steps, D <= 128, 192 or 256");
  static_assert(KV_BQ % KV_QS == 0, "whole sub-steps in a q step");
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

// (x0, x1) = hi + lo as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in f32)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// rows [r0, r0 + ROWS) of a (n, stride) bf16 matrix, columns [0, D), into
// a tile of pitch D + 8 by 16-byte cp.async; rows past n are zero-filled
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n, size_t stride) {
  constexpr int CH = D / 8, N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (N % THREADS != 0 && e >= N) break;
    const int r = e / CH, c = e % CH;
    const int row = r0 + r;
    const bool ok = row < n;
    cp_async16(smem_addr(dst + r * (D + 8) + c * 8),
               src + (size_t)(ok ? row : 0) * stride + c * 8, ok);
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx.ftz, about 2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = exp(sc - m) l^-1 and ds = p (dp - D) [(1 - (sc/cap)^2)] d^-0.5 of one
// element from its raw score s and dp, in the reference's order (the
// CUDA-core kernels' scores<D>), the exp taken as 2^(sc log2 e - rm) with
// rm = m log2 e; keep = false gives 0 and 0
__device__ __forceinline__ void p_ds(float s, float dp, float rm, float rli,
                                     float rd, bool keep, const Masks& mk,
                                     float& p, float& ds) {
  float x = s * mk.scale;
  float dcap = 1.f;
  if (mk.softcap != 0.f) {
    x = tanhf(x / mk.softcap) * mk.softcap;
    const float t = x / mk.softcap;
    dcap = 1.f - t * t;
  }
  p = keep ? ex2(fmaf(x, LOG2E, -rm)) * rli : 0.f;
  ds = p * (dp - rd);
  if (mk.softcap != 0.f) ds = ds * dcap;
  ds = ds * mk.scale;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, const Masks& mk) {
  bool keep = kpos < mk.Sk;
  if (mk.causal) keep = keep && kpos <= qpos;
  if (mk.window) keep = keep && kpos > qpos - mk.window;
  return keep;
}

// Fragment layouts (g = lane / 4, c = lane % 4): an m16n8 f32 tile holds
// rows g (regs 0, 1) and g + 8 (regs 2, 3) at columns 2c + {0, 1}; an A
// operand (16 x 16) holds rows g / g + 8 at columns 2c + {0, 1} (regs 0, 1)
// and 2c + 8 + {0, 1} (regs 2, 3); a B operand (16 x 8) holds column g at
// rows 2c + {0, 1} (reg 0) and 2c + 8 + {0, 1} (reg 1).
//
// One block of the dk / dv kernel, its 64 keys from blockIdx. DV: it
// accumulates dv += P^T dO, DK: dk += dS^T Q. Both at D <= 128; under
// SPLIT (D = 256) a block does one of them, and a dv block forms neither
// dP^T nor dS^T nor reads V or D. P comes from p_ds in both, so a dv block
// and a dk block use the same bits of P. (mk by value: by reference, the
// D = 128 instance compiled to another, slower schedule.)
template <int D, bool DV, bool DK>
__device__ __forceinline__ void mma_dkdv_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ m, const float* __restrict__ l,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int KV, Masks mk) {
  using Plan = MmaBwdPlan<D>;
  constexpr int THREADS = Plan::THREADS, BK = Plan::KV_BK, BQ = Plan::KV_BQ;
  constexpr int PITCH = Plan::PITCH;
  constexpr int QS = Plan::KV_QS;
  constexpr int NT = QS / 8;  // 8-query tiles of S^T
  constexpr int DT = D / 8;   // 8-wide d tiles of dk, dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BK x PITCH
  bf16* Vs = Ks + BK * PITCH;                    // BK x PITCH
  bf16* QGs = Vs + BK * PITCH;  // stage s: Q, then dO, BQ x PITCH each
  // stage s: m log2 e, 1 / max(l, 1e-30), D of the step's BQ rows
  float* rowv = reinterpret_cast<float*>(QGs + 2 * 2 * BQ * PITCH);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.y * BK;  // key tile 0 of every (kv head, b) first
  // under SPLIT blockIdx.x is 2 (b KV + kv head), + 1 for the dv block: a
  // tile's dk block (three products to dv's two) launches before its dv
  const unsigned kb = Plan::SPLIT ? blockIdx.x >> 1 : blockIdx.x;
  const int kvh = kb % KV;
  const int b = kb / KV;
  const int G = H / KV;
  const int Sq = mk.Sq, Sk = mk.Sk;
  const size_t q_stride = (size_t)H * D, k_stride = (size_t)KV * D;
  const size_t kv_off = ((size_t)b * Sk * KV + kvh) * D;

  // q rows that see at least one key of [k0, kmax]: causal needs
  // qpos >= k0, the window qpos < kmax + window; steps walk (head, q tile)
  const int kmax = min(k0 + BK, Sk) - 1;
  const int q_lo = mk.causal ? max(0, k0 - mk.q_offset) : 0;
  const int q_hi = mk.window ? min(Sq, kmax + mk.window - mk.q_offset) : Sq;
  const int t_begin = q_lo / BQ;
  const int n_t = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - t_begin : 0;
  const int n_steps = G * n_t;

  auto load_step = [&](int i, int stage) {
    const int h = kvh * G + i / n_t, q0 = (t_begin + i % n_t) * BQ;
    const size_t q_off = ((size_t)b * Sq * H + h) * D;
    bf16* Qs = QGs + stage * 2 * BQ * PITCH;
    load_tile<D, BQ, THREADS>(Qs, q + q_off, q0, Sq, q_stride);
    load_tile<D, BQ, THREADS>(Qs + BQ * PITCH, dout + q_off, q0, Sq,
                              q_stride);
  };
  // the row statistics go through registers: thread r < BQ loads row r of
  // the next step while this one computes and stores it after
  float nm = 0.f, nl = 0.f, nd = 0.f;
  bool nok = false;
  auto fetch_rows = [&](int i) {
    if (tid < BQ) {
      const int h = kvh * G + i / n_t;
      const int row = (t_begin + i % n_t) * BQ + tid;
      nok = row < Sq;
      if (nok) {
        const size_t r = ((size_t)b * Sq + row) * H + h;
        nm = m[r];
        nl = l[r];
        if constexpr (DK) nd = delta[r];
      }
    }
  };
  auto store_rows = [&](int stage) {
    if (tid < BQ) {
      float* rv = rowv + stage * 3 * BQ;
      rv[tid] = nok ? nm * LOG2E : 0.f;
      rv[BQ + tid] = nok ? 1.f / fmaxf(nl, 1e-30f) : 0.f;
      rv[2 * BQ + tid] = nok ? nd : 0.f;
    }
  };

  // K, V and the first step in one group
  load_tile<D, BK, THREADS>(Ks, k + kv_off, k0, Sk, k_stride);
  if constexpr (DK)
    load_tile<D, BK, THREADS>(Vs, v + kv_off, k0, Sk, k_stride);
  if (n_steps > 0) {
    load_step(0, 0);
    fetch_rows(0);
    store_rows(0);
  }
  cp_async_commit();

  const int g = lane >> 2, c2 = (lane & 3) * 2;
  // this warp's keys, and this thread's two of them (rows g, g + 8)
  const int kw = k0 + warp * 16;
  const int kpos0 = kw + g, kpos1 = kpos0 + 8;
  // ldmatrix addresses: K, V as A (row lane % 16, column 8 (lane / 16));
  // Q, dO rows as B of two 8-query tiles (query lane % 8 + 8 (lane / 16),
  // column 8 (lane / 8 % 2)); dO, Q as B of two 8-wide d tiles through
  // .trans (query lane % 8 + 8 (lane / 8 % 2), column 8 (lane / 16))
  const int a_lane = (warp * 16 + (lane & 15)) * PITCH + (lane >> 4) * 8;
  const uint32_t k_addr = smem_addr(Ks + a_lane);
  const uint32_t v_addr = smem_addr(Vs + a_lane);
  const int b_lane = ((lane & 7) + ((lane >> 4) << 3)) * PITCH +
                     ((lane >> 3) & 1) * 8;
  const int t_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * PITCH +
                     (lane >> 4) * 8;

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int stage = i & 1;
    const int q0 = (t_begin + i % n_t) * BQ;
    // this step has landed, and every warp is done with the previous one,
    // so the next step goes into the other stage while this one computes
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_steps) {
      load_step(i + 1, stage ^ 1);
      fetch_rows(i + 1);
    }
    cp_async_commit();

    const bf16* Qs = QGs + stage * 2 * BQ * PITCH;
    const bf16* Gs = Qs + BQ * PITCH;
    const float* rm = rowv + stage * 3 * BQ;
    const float* rli = rm + BQ;
    const float* rd = rli + BQ;
    // the step in sub-steps of QS queries, one after the other (not
    // unrolled: their scores need not be live at once)
#pragma unroll 1
    for (int qs = 0; qs < BQ; qs += QS) {
      const int qpos_lo = q0 + qs + mk.q_offset;
      const int qpos_hi = min(q0 + qs + QS, Sq) - 1 + mk.q_offset;
      // a warp whose 16 keys no row of the sub-step sees adds nothing
      bool live = kw < Sk && q0 + qs < Sq;
      if (mk.causal) live = live && kw <= qpos_hi;
      if (mk.window) live = live && kw + 15 > qpos_lo - mk.window;
      if (!live) continue;
      const uint32_t q_b = smem_addr(Qs + qs * PITCH + b_lane);
      const uint32_t g_b = smem_addr(Gs + qs * PITCH + b_lane);

      // S^T = K Q^T, dP^T = V dO^T (16 keys x QS queries a warp; a dv
      // block leaves dP^T at 0)
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, k_addr + kk * 32);
        if constexpr (DK) ldmatrix_x4(va, v_addr + kk * 32);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const uint32_t off = (np * 16 * PITCH + kk * 16) * 2;
          uint32_t bf[4];
          ldmatrix_x4(bf, q_b + off);
          mma_bf16(s[2 * np], ka, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], ka, bf[2], bf[3]);
          if constexpr (DK) {
            ldmatrix_x4(bf, g_b + off);
            mma_bf16(dp[2 * np], va, bf[0], bf[1]);
            mma_bf16(dp[2 * np + 1], va, bf[2], bf[3]);
          }
        }
      }

      // P^T and dS^T in f32, split hi / lo into A fragments: 16-query step
      // kk is S^T tiles 2 kk, 2 kk + 1; masks only where the warp's tile
      // straddles Sq, Sk, the diagonal or the window edge
      const bool edge = q0 + qs + QS > Sq || kw + 16 > Sk ||
                        (mk.causal && kw + 15 > qpos_lo) ||
                        (mk.window && kw <= qpos_hi - mk.window);
      uint32_t ph[NT / 2][4], pl[NT / 2][4], sh[NT / 2][4], sl[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = qs + j * 8 + c2;
        const float2 mj = *reinterpret_cast<const float2*>(rm + col);
        const float2 lj = *reinterpret_cast<const float2*>(rli + col);
        const float2 dj = *reinterpret_cast<const float2*>(rd + col);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = e & 1;
          bool keep = true;
          if (edge) {
            const int row = q0 + col + cc;
            keep = row < Sq && visible(row + mk.q_offset,
                                       e < 2 ? kpos0 : kpos1, mk);
          }
          p_ds(s[j][e], dp[j][e], cc ? mj.y : mj.x, cc ? lj.y : lj.x,
               cc ? dj.y : dj.x, keep, mk, p[e], ds[e]);
        }
        const int r = (j & 1) * 2;
        if constexpr (DV) {
          split_bf16(p[0], p[1], ph[j / 2][r], pl[j / 2][r]);
          split_bf16(p[2], p[3], ph[j / 2][r + 1], pl[j / 2][r + 1]);
        }
        if constexpr (DK) {
          split_bf16(ds[0], ds[1], sh[j / 2][r], sl[j / 2][r]);
          split_bf16(ds[2], ds[3], sh[j / 2][r + 1], sl[j / 2][r + 1]);
        }
      }

      // dv += P^T dO, dk += dS^T Q (16 keys x D), hi then lo
      const uint32_t q_t = smem_addr(Qs + qs * PITCH + t_lane);
      const uint32_t g_t = smem_addr(Gs + qs * PITCH + t_lane);
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk)
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          const uint32_t off = (kk * 16 * PITCH + dp2 * 16) * 2;
          uint32_t bf[4];
          if constexpr (DV) {
            ldmatrix_x4_trans(bf, g_t + off);
            mma_bf16(adv[2 * dp2], ph[kk], bf[0], bf[1]);
            mma_bf16(adv[2 * dp2], pl[kk], bf[0], bf[1]);
            mma_bf16(adv[2 * dp2 + 1], ph[kk], bf[2], bf[3]);
            mma_bf16(adv[2 * dp2 + 1], pl[kk], bf[2], bf[3]);
          }
          if constexpr (DK) {
            ldmatrix_x4_trans(bf, q_t + off);
            mma_bf16(adk[2 * dp2], sh[kk], bf[0], bf[1]);
            mma_bf16(adk[2 * dp2], sl[kk], bf[0], bf[1]);
            mma_bf16(adk[2 * dp2 + 1], sh[kk], bf[2], bf[3]);
            mma_bf16(adk[2 * dp2 + 1], sl[kk], bf[2], bf[3]);
          }
        }
    }
    // the next step's row statistics into the other stage (every warp is
    // done with it: it passed this step's barrier)
    if (i + 1 < n_steps) store_rows(stage ^ 1);
  }
  cp_async_wait<0>();  // no copy is in flight when the block exits

#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + c2;
    if (kpos0 < Sk) {
      const size_t off = kv_off + (size_t)kpos0 * k_stride + col;
      if constexpr (DK)
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(adk[j][0], adk[j][1]);
      if constexpr (DV)
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(adv[j][0], adv[j][1]);
    }
    if (kpos1 < Sk) {
      const size_t off = kv_off + (size_t)kpos1 * k_stride + col;
      if constexpr (DK)
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(adk[j][2], adk[j][3]);
      if constexpr (DV)
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(adv[j][2], adv[j][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MmaBwdPlan<D>::THREADS, 2)
flash_bwd_mma_dkdv_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                          int KV, Masks mk) {
  if constexpr (!MmaBwdPlan<D>::SPLIT)
    mma_dkdv_block<D, true, true>(q, k, v, dout, m, l, delta, dk, dv, H, KV,
                                  mk);
  else if (blockIdx.x & 1)
    mma_dkdv_block<D, true, false>(q, k, v, dout, m, l, delta, dk, dv, H,
                                   KV, mk);
  else
    mma_dkdv_block<D, false, true>(q, k, v, dout, m, l, delta, dk, dv, H,
                                   KV, mk);
}

template <int D>
__global__ void __launch_bounds__(MmaBwdPlan<D>::THREADS,
                                  MmaBwdPlan<D>::Q_BLOCKS)
flash_bwd_mma_dq_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int KV, Masks mk) {
  using Plan = MmaBwdPlan<D>;
  constexpr int THREADS = Plan::THREADS, BQ = Plan::Q_BQ, BK = Plan::Q_BK;
  constexpr int PITCH = Plan::PITCH;
  constexpr int NT = BK / 8;  // 8-key tiles of S
  constexpr int DT = D / 8;   // 8-wide d tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x PITCH
  bf16* Gs = Qs + BQ * PITCH;                    // dO, BQ x PITCH
  bf16* KVs = Gs + BQ * PITCH;  // stage s: K, then V, BK x PITCH each

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // most keys first
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const int Sq = mk.Sq, Sk = mk.Sk;
  const size_t q_stride = (size_t)H * D, k_stride = (size_t)KV * D;
  const size_t q_off = ((size_t)b * Sq * H + h) * D;
  const size_t kv_off = ((size_t)b * Sk * KV + kvh) * D;

  // key tiles that hold a key visible to some row of this tile
  const int qlo = q0 + mk.q_offset;
  const int qhi = min(q0 + BQ, Sq) - 1 + mk.q_offset;
  int k_end = Sk;
  if (mk.causal) k_end = min(k_end, qhi + 1);
  const int k_begin = mk.window ? max(0, qlo - mk.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int n_tiles = k_end > k_begin ? (k_end + BK - 1) / BK - t_begin : 0;

  auto load_kv = [&](int t, int stage) {
    bf16* Ks = KVs + stage * 2 * BK * PITCH;
    load_tile<D, BK, THREADS>(Ks, k + kv_off, t * BK, Sk, k_stride);
    load_tile<D, BK, THREADS>(Ks + BK * PITCH, v + kv_off, t * BK, Sk,
                              k_stride);
  };
  // Q, dO (rows past Sq zero-filled, never stored) and the first K, V tile
  // in one group
  load_tile<D, BQ, THREADS>(Qs, q + q_off, q0, Sq, q_stride);
  load_tile<D, BQ, THREADS>(Gs, dout + q_off, q0, Sq, q_stride);
  if (n_tiles > 0) load_kv(t_begin, 0);
  cp_async_commit();

  const int g = lane >> 2, c2 = (lane & 3) * 2;
  // this warp's rows, and this thread's two of them with their statistics
  const int qw = q0 + warp * 16;
  const int row0 = qw + g, row1 = row0 + 8;
  float rm[2] = {0.f, 0.f}, rli[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = u ? row1 : row0;
    if (row < Sq) {
      const size_t r = ((size_t)b * Sq + row) * H + h;
      rm[u] = m[r] * LOG2E;
      rli[u] = 1.f / fmaxf(l[r], 1e-30f);
      rd[u] = delta[r];
    }
  }
  const int qwpos_lo = qw + mk.q_offset;
  const int qwpos_hi = min(qw + 16, Sq) - 1 + mk.q_offset;
  // ldmatrix addresses: Q, dO as A; K, V rows as B of two 8-key tiles; K
  // as B of two 8-wide d tiles through .trans (as in the forward)
  const int a_lane = (warp * 16 + (lane & 15)) * PITCH + (lane >> 4) * 8;
  const uint32_t q_addr = smem_addr(Qs + a_lane);
  const uint32_t g_addr = smem_addr(Gs + a_lane);
  const int b_lane = ((lane & 7) + ((lane >> 4) << 3)) * PITCH +
                     ((lane >> 3) & 1) * 8;
  const int t_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * PITCH +
                     (lane >> 4) * 8;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_begin + i) * BK;
    const int stage = i & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_tiles) load_kv(t_begin + i + 1, stage ^ 1);
    cp_async_commit();

    // a warp whose 16 rows see no key of the tile adds nothing
    bool live = qw < Sq;
    if (mk.causal) live = live && k0 <= qwpos_hi;
    if (mk.window) live = live && k0 + BK - 1 > qwpos_lo - mk.window;
    if (!live) continue;
    const bf16* Ks = KVs + stage * 2 * BK * PITCH;
    const uint32_t k_b = smem_addr(Ks + b_lane);
    const uint32_t v_b = smem_addr(Ks + BK * PITCH + b_lane);
    const uint32_t k_t = smem_addr(Ks + t_lane);

    // S = Q K^T, dP = dO V^T (16 rows x BK keys a warp)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      ldmatrix_x4(qa, q_addr + kk * 32);
      ldmatrix_x4(ga, g_addr + kk * 32);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const uint32_t off = (np * 16 * PITCH + kk * 16) * 2;
        uint32_t bf[4];
        ldmatrix_x4(bf, k_b + off);
        mma_bf16(s[2 * np], qa, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
        ldmatrix_x4(bf, v_b + off);
        mma_bf16(dp[2 * np], ga, bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], ga, bf[2], bf[3]);
      }
    }

    // dS in f32, split hi / lo into A fragments (16-key step kk is S tiles
    // 2 kk, 2 kk + 1); masks only on tiles that straddle an edge
    const bool edge = k0 + BK > Sk || qw + 16 > Sq ||
                      (mk.causal && k0 + BK - 1 > qwpos_lo) ||
                      (mk.window && k0 <= qwpos_hi - mk.window);
    uint32_t sh[NT / 2][4], sl[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1;
        bool keep = true;
        if (edge)
          keep = (u ? row1 : row0) < Sq &&
                 visible((u ? row1 : row0) + mk.q_offset,
                         k0 + j * 8 + c2 + (e & 1), mk);
        float p;
        p_ds(s[j][e], dp[j][e], rm[u], rli[u], rd[u], keep, mk, p, ds[e]);
      }
      const int r = (j & 1) * 2;
      split_bf16(ds[0], ds[1], sh[j / 2][r], sl[j / 2][r]);
      split_bf16(ds[2], ds[3], sh[j / 2][r + 1], sl[j / 2][r + 1]);
    }

    // dq += dS K (16 rows x D), hi then lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, k_t + (kk * 16 * PITCH + dp2 * 16) * 2);
        mma_bf16(acc[2 * dp2], sh[kk], bf[0], bf[1]);
        mma_bf16(acc[2 * dp2], sl[kk], bf[0], bf[1]);
        mma_bf16(acc[2 * dp2 + 1], sh[kk], bf[2], bf[3]);
        mma_bf16(acc[2 * dp2 + 1], sl[kk], bf[2], bf[3]);
      }
  }
  cp_async_wait<0>();  // no copy is in flight when the block exits

#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + c2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + q_off + (size_t)row0 * q_stride +
                                   col) = pack_bf16(acc[j][0], acc[j][1]);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + q_off + (size_t)row1 * q_stride +
                                   col) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* m, const float* l, const float* delta, void* dq,
               void* dk, void* dv, int B, int H, int KV, const Masks& mk,
               cudaStream_t stream) {
  using Plan = MmaBwdPlan<D>;
  const int q_tiles = (mk.Sq + Plan::Q_BQ - 1) / Plan::Q_BQ;
  const int k_tiles = (mk.Sk + Plan::KV_BK - 1) / Plan::KV_BK;
  if (q_tiles > 65535 || k_tiles > 65535 ||
      (long long)B * H * (Plan::SPLIT ? 2 : 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
      16)
    return (int)cudaErrorInvalidValue;  // 16-byte cp.async
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_mma_dkdv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::KV_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_mma_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Plan::Q_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_mma_dkdv_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_mma_dq_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  flash_bwd_mma_dkdv_kernel<D>
      <<<dim3((Plan::SPLIT ? 2 : 1) * B * KV, k_tiles), Plan::THREADS,
          Plan::KV_SMEM, stream>>>(
          qt, kt, vt, gt, m, l, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), H, KV, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_mma_dq_kernel<D>
      <<<dim3(B * H, q_tiles), Plan::THREADS, Plan::Q_SMEM, stream>>>(
          qt, kt, vt, gt, m, l, delta, static_cast<bf16*>(dq), H, KV, mk);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v,
                 const void* dout, const float* m, const float* l,
                 const float* delta, void* dq, void* dk, void* dv, int B,
                 int H, int KV, int D, const Masks& mk, cudaStream_t stream) {
#define BWD_CASE(DD)                                                          \
  case DD:                                                                    \
    return launch<DD>(q, k, v, dout, m, l, delta, dq, dk, dv, B, H, KV, mk,   \
                      stream);
  switch (D) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(48)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(128)
    BWD_CASE(192)
    BWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

// bf16: the tensor-core kernels at every head dim
int dispatch_bf16(const void* q, const void* k, const void* v,
                  const void* dout, const float* m, const float* l,
                  const float* delta, void* dq, void* dk, void* dv, int B,
                  int H, int KV, int D, const Masks& mk,
                  cudaStream_t stream) {
#define BWD_CASE(DD)                                                         \
  case DD:                                                                   \
    return launch_mma<DD>(q, k, v, dout, m, l, delta, dq, dk, dv, B, H, KV,  \
                          mk, stream);
  switch (D) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(48)
    BWD_CASE(64)
    BWD_CASE(80)
    BWD_CASE(128)
    BWD_CASE(192)
    BWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

}  // namespace

// q, o, dout, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, KV, D); m, l and the
// scratch delta: (B, Sq, H) float32; all contiguous (bf16 q, k, v, dout:
// 16-byte aligned). dtype 0 = float32, 1 = bfloat16 (q, k, v, o, dout and
// the outputs). Launches the D pre-pass, then the dk / dv and the dq
// kernels of the dtype and D (see the header), on ``stream``. Returns a
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
    return dispatch_f32(q, k, v, dout, mf, lf, df, dq, dk, dv, B, H, KV, D,
                        mk, s);
  return dispatch_bf16(q, k, v, dout, mf, lf, df, dq, dk, dv, B, H, KV, D,
                       mk, s);
}

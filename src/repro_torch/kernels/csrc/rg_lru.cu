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
// the bound is the 3.35 TB/s of device memory: 302 MB, 0.09017 ms, at the
// serving prefill shape (B=4, S=3072, D=4096, bf16). At decode (S=1) the
// work is a few hundred KB and the launch itself sets the time.
//
// Two kernels. The wrapper's launch plan (kernels/rg_lru.py::launch_plan)
// picks one by shape and passes its tiles here, where they are checked
// against the compiled instances:
//  * rg_lru_ring_kernel: S >= TILE_S, the prefill (below).
//  * rg_lru_step_kernel: S < TILE_S, the decode step (S = 1) and short
//    sequences. One thread per (b, channel), 256 channels a block, the next
//    U = 8 timesteps loaded into registers ahead of the chain.
//
// Why the ring. Device memory runs at full rate only with about 3.35 TB/s x
// ~1 us = 3 to 4 MB of loads in flight across the card. The step kernel
// keeps 2 x 8 bf16 per thread in flight: 16 x 2 B x 16,384 threads = 512
// KB at the serving shape, which sustains 0.58 TB/s (0.5230 ms measured),
// and its 64 blocks leave 68 of 132 SMs idle. The ring kernel gives a block
// one batch row and one 128-byte row segment of channels (64 bf16, 32 f32)
// and walks all of S: 256 blocks at the serving shape, all resident (4 an
// SM fit). Its threads copy time tiles of TILE_S = 32 steps of a and gx
// (8 KB) into a ring of STAGES = 3 tiles in dynamic shared memory with
// cp.async, 16 bytes a copy, two tiles ahead of the chain: 16 KB in flight
// a block, 4 MB on the card. (Tiles of 16 to 128 steps and rings of 2 to 8
// tiles were timed on an H100 at the serving shape; 32 x 3 was fastest.)
// The chain stays one thread per (b, channel) with the carry
// in a register and reads a and gx from shared memory (a warp reads one
// row: two bf16 channels share a bank word, a broadcast, no conflict). h is
// stored from registers, one element a thread a step: a warp's store is one
// coalesced 64- or 128-byte segment, and staging h through shared memory
// would add a pass and a barrier a tile for no fewer device-memory bytes.
// h_last is written once. The dependent chain costs S steps of ~8 cycles
// (~13 us at S = 3072), far below the bound: the ring adds bytes in flight,
// not parallelism over S, so the arithmetic stays in time order.
//
// Ragged edges, no restriction on the shape: a tail time tile is partial
// (its rows past S are neither copied nor read); copies that hold none of
// the block's channels are skipped, and threads past D do not compute. Rows
// that do not start on a 16-byte boundary (D not a multiple of 8 bf16 or 4
// f32, or an input pointer off a 16-byte boundary) take the other instance
// (ALIGNED = false): each row is copied as the 16-byte-aligned window that
// holds it, one 16-byte copy more a row, and each thread reads at the row's
// shift in its window (the shift moves by D mod 8 or 4 from row to row), so
// those shapes keep the ring's 16-byte asynchronous copies too. A copy is
// made only if it holds one of the block's elements, so no copy reads
// outside the 16-byte granules that hold the inputs.
//
// Rounding: each step is __fmul_rn then __fadd_rn, never a contracted FMA,
// in time order per channel, because the plain PyTorch version rounds the
// product before the add; both kernels are then bit-identical to it.
//
// Under autograd both forward kernels also write the f32 carry h32 (B, S,
// D) when given a pointer to it (bf16 inputs; in f32, h is the carry): the
// backward's da_t = g_t h_{t-1} needs h in f32, as the reference's VJP
// differentiates its f32 scan, and the bf16 h would put da off by up to
// 2^-8 relative. Without the pointer (prefill, decode) each kernel runs an
// instance compiled without the carry (CARRY = false), the code it ran
// before the backward came.
//
// The backward: the VJP of the scan by a reverse one, g_t = dh_t + a_{t+1}
// g_{t+1} (g_{S-1} = dh_{S-1} + dh_last), dgx_t = g_t, da_t = g_t h_{t-1}
// (h_{-1} = h0, or 0), dh0 = a_0 g_0. Every product and sum is rounded on
// its own (__fmul_rn, __fadd_rn), in reverse time order per channel, one
// thread a (b, channel) with g in a register, so the backward kernel is
// bit for bit the plain version (kernels/ref.py::rg_lru_bwd) and
// bit-identical across launches. It moves 12 bytes an element in bf16 (a,
// dh read, the f32 carry h32 read, da and dgx written): at
// recurrentgemma-9b's training shape (2, 4096, 4096) 403 MB, 0.1202 ms at
// 3.35 TB/s. The chain is S dependent add / multiply pairs, ~8 cycles a
// step (~18 us at S = 4096), far below that: bytes bound it.
// rg_lru_bwd_ring_kernel, at every S: the forward's ring run from the end.
// A block owns one batch row and one 128-byte segment of channels (64 bf16,
// 32 f32) and walks all of S, time tile by time tile in reverse, through a
// ring of BWD_STAGES stages in dynamic shared memory; a sequence shorter
// than one tile is one partial tile. A stage holds a tile's rows of a and
// dh and of the carry one step back (the stage's row r is h32's row t0 + r
// - 1, so a step reads its three inputs from one stage row; at t = 0 the
// walk takes h0). The block has two threads a channel, in two warp roles:
// the consumers, one a channel, run the chain from the stages with g in a
// register and store da and dgx (a coalesced 128-byte row segment a step
// across the block); the producers fill the stages with 16-byte cp.async
// copies (copy_rows, which the forward's copy_tile also calls) and signal
// each stage's "full" mbarrier when their copies land
// (cp.async.mbarrier.arrive.noinc); the consumers release it on its
// "empty" mbarrier. With one block of two consumer warps on each SM (8,192
// chains at the training shape), the chain's warps execute every
// instruction of a step themselves, so the copies' address arithmetic goes
// to warps of their own. The fill runs up to BWD_STAGES tiles ahead: at 32
// steps and 3 stages 48 KB a block, 6 MB over the 128 blocks of the
// training shape, where a register walk (one thread a chain, 16 steps in
// registers, 64 chains a block) keeps ~1 MB and ran 2.5 x the bound.
// tune_rg_lru --bwd times tiles of 16 to 64 steps in rings of 3 to 6
// stages. On an H100 at the training shape 32 x 3 was the fastest (0.1393
// ms, 0.86 of the bound). Hopper's bulk copies (cp.async.bulk, one a row
// and array, the bytes expected on the full mbarrier) were timed there too
// and were slower at every tile and depth (0.198 to 0.482 ms: a producer's
// bulk copies of a row's 128 or 256 bytes leave one after another, so the
// fewer rows a tile has, the fewer producers copy at once), so the kernel
// keeps cp.async alone. A 2-D TMA box would need row pitches that are
// multiples of 16 bytes (bf16 D = 4100 has 8,200).
// Rows that do not start on a 16-byte boundary take the ALIGNED = false
// instance, as the forward: each of the three arrays is copied as the
// 16-byte-aligned windows that hold its rows and read at its own shift (a
// and dh share a dtype, h32 does not, and their pointers may sit apart);
// the consumers track each shift from row to row.
#include <atomic>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// the step kernel
constexpr int STEP_THREADS = 256;
constexpr int U = 8;  // timesteps held in registers per chunk
// the ring kernel: a block owns ROW_BYTES of channels, one thread each
constexpr int ROW_BYTES = 128;
constexpr int TILE_S = 32;  // timesteps a tile
constexpr int STAGES = 3;   // tiles in the ring
// the backward's ring kernel: ROW_BYTES of channels a block, as the forward
constexpr int BWD_TILE_S = 32;  // timesteps a tile
constexpr int BWD_STAGES = 3;   // tiles in the ring
constexpr int MAX_DEVICES = 64;

enum Kernel { KERNEL_STEP = 0, KERNEL_RING = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float step(float a, float carry, float gx) {
  return __fadd_rn(__fmul_rn(a, carry), gx);
}

// ------------------------------------------------------------ step kernel

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

// CARRY: also write the f32 carry to h32, as the ring kernel's CARRY
template <typename T, bool CARRY>
__global__ void __launch_bounds__(STEP_THREADS)
rg_lru_step_kernel(const T* __restrict__ a, const T* __restrict__ gx,
                   const T* __restrict__ h0, T* __restrict__ h,
                   T* __restrict__ h_last, float* __restrict__ h32, int S,
                   int D) {
  const int c = blockIdx.x * STEP_THREADS + threadIdx.x;
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
        carry = step(ac[u], carry, gc[u]);
        store(&h[base + (size_t)t * D], carry);
        if (CARRY) h32[base + (size_t)t * D] = carry;
      }
    }
  }
  store(&h_last[(size_t)b * D + c], carry);
}

// ------------------------------------------------------------ ring kernel

// ALIGNED: every row segment starts on a 16-byte boundary, so a row is
// CHUNKS 16-byte copies. Otherwise a row is copied as the 16-byte-aligned
// window that holds it (one copy more) and read at its shift in the window.
template <typename T, bool ALIGNED, int TS, int ST>
struct Ring {
  static constexpr int DC = ROW_BYTES / (int)sizeof(T);  // channels, threads
  static constexpr int VEC = 16 / (int)sizeof(T);        // elements a copy
  static constexpr int CHUNKS = ROW_BYTES / 16 + (ALIGNED ? 0 : 1);
  static constexpr int PITCH = CHUNKS * VEC;  // elements a row in a stage
  static constexpr int TILE = TS * PITCH;     // elements of one array
  static constexpr int SMEM = ST * 2 * TILE * (int)sizeof(T);
  static constexpr int COPIES = (TS * CHUNKS + DC - 1) / DC;  // a thread
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until waited for
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
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

// elements between p and the 16-byte boundary at or before it
template <bool ALIGNED, typename T>
__device__ __forceinline__ int shift_of(const T* p) {
  return ALIGNED ? 0
                 : (int)(reinterpret_cast<uintptr_t>(p) % 16 / sizeof(T));
}

// rows [r0, rows) of one array into a stage's part at dst (rows ROW bytes
// apart), stage row r from src + (r - lag) D (src: that array's element
// (b, t0, c0)), n channels: 16-byte cp.async copies spread over THREADS
// threads (this one: p), ROW / 16 consecutive ones a row, a copy only
// where it holds one of the row's n elements (so none reads outside the
// 16-byte granules that hold the inputs)
template <bool ALIGNED, int TS, int ROW, int THREADS, typename E>
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const E* __restrict__ src, int lag,
                                          int r0, int rows, int n, int D,
                                          int p) {
  constexpr int CHUNKS = ROW / 16, VEC = 16 / (int)sizeof(E);
#pragma unroll
  for (int k = 0; k < (TS * CHUNKS + THREADS - 1) / THREADS; ++k) {
    const int i = k * THREADS + p;
    const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
    if (i < TS * CHUNKS && r >= r0 && r < rows) {
      const E* q = src + (ptrdiff_t)(r - lag) * D;
      const int s = shift_of<ALIGNED>(q);
      if (c - s < n)
        cp_async16(smem_addr(dst + r * ROW + c * (int)sizeof(E)), q - s + c);
    }
  }
}

// rows [0, rows) of a and gx from element `first` (= (b, t0, c0)), n
// channels, into one stage: a at dst, gx at dst + TILE, row-major
// (TS, PITCH), by the block's DC threads
template <typename T, bool ALIGNED, int TS, int ST>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ a,
                                          const T* __restrict__ gx,
                                          size_t first, int rows, int n,
                                          int D) {
  using R = Ring<T, ALIGNED, TS, ST>;
  constexpr int ROW = R::PITCH * (int)sizeof(T);
  unsigned char* d = reinterpret_cast<unsigned char*>(dst);
  copy_rows<ALIGNED, TS, ROW, R::DC>(d, a + first, 0, 0, rows, n, D,
                                     threadIdx.x);
  copy_rows<ALIGNED, TS, ROW, R::DC>(d + R::TILE * (int)sizeof(T),
                                     gx + first, 0, 0, rows, n, D,
                                     threadIdx.x);
}

// CARRY: also write the f32 carry to h32 (under autograd); the instance
// without it is the serving path's, with no store or test of h32 a step
template <typename T, bool ALIGNED, int TS, int ST, bool CARRY>
__global__ void __launch_bounds__(Ring<T, ALIGNED, TS, ST>::DC)
rg_lru_ring_kernel(const T* __restrict__ a, const T* __restrict__ gx,
                   const T* __restrict__ h0, T* __restrict__ h,
                   T* __restrict__ h_last, float* __restrict__ h32, int S,
                   int D) {
  using R = Ring<T, ALIGNED, TS, ST>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // (ST, 2, TS, PITCH)
  const int c0 = blockIdx.x * R::DC;
  const int n = min(R::DC, D - c0);  // channels of this block
  const int b = blockIdx.y;
  const size_t first = (size_t)b * S * D + c0;  // element (b, 0, c0)
  const int tiles = (S + TS - 1) / TS;

  // tiles 0 .. ST - 2 in flight; one commit group a tile (empty past the
  // last), so that "tile k has landed" is always "ST - 2 groups pending"
#pragma unroll
  for (int k = 0; k < ST - 1; ++k) {
    if (k < tiles)
      copy_tile<T, ALIGNED, TS, ST>(ring + k * 2 * R::TILE, a, gx,
                                    first + (size_t)k * TS * D,
                                    min(TS, S - k * TS), n, D);
    cp_async_commit();
  }
  const bool live = (int)threadIdx.x < n;
  float carry = (live && h0) ? to_f32(h0[(size_t)b * D + c0 + threadIdx.x])
                             : 0.f;
  T* hp = h + first + threadIdx.x;  // h[b, t, c], t = 0
  float* cp = CARRY ? h32 + first + threadIdx.x : nullptr;
  // row t's shift in its window; each row moves it by D mod VEC
  int sa = shift_of<ALIGNED>(a + first), sg = shift_of<ALIGNED>(gx + first);
  const int dv = D % R::VEC;
  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<ST - 2>();  // this thread's copies of tile k have landed
    __syncthreads();  // everyone's have, and no thread still reads tile k - 1
    const int kn = k + ST - 1;  // refill tile k - 1's slot
    if (kn < tiles)
      copy_tile<T, ALIGNED, TS, ST>(ring + (kn % ST) * 2 * R::TILE, a, gx,
                                    first + (size_t)kn * TS * D,
                                    min(TS, S - kn * TS), n, D);
    cp_async_commit();
    if (!live) continue;
    const T* as = ring + (k % ST) * 2 * R::TILE + threadIdx.x;
    const T* gs = as + R::TILE;
    const int rows = min(TS, S - k * TS);
    auto row = [&](int r) {
      carry = step(to_f32(as[r * R::PITCH + sa]), carry,
                   to_f32(gs[r * R::PITCH + sg]));
      store(hp, carry);
      hp += D;
      if (CARRY) {
        *cp = carry;
        cp += D;
      }
      if (!ALIGNED) {
        sa = (sa + dv) & (R::VEC - 1);
        sg = (sg + dv) & (R::VEC - 1);
      }
    };
    if (rows == TS) {
#pragma unroll 16
      for (int r = 0; r < TS; ++r) row(r);
    } else {
      for (int r = 0; r < rows; ++r) row(r);
    }
  }
  if (live) store(&h_last[(size_t)b * D + c0 + threadIdx.x], carry);
}

// ------------------------------------------------- backward, ring kernel

// A stage of the backward's ring: TS rows of a and of dh (in T) and of the
// f32 carry one step back, each row a 128-byte channel segment (DC
// channels) and, when rows are read at a shift (ALIGNED false), the 16
// bytes more of its aligned window. The stages' mbarriers follow them: a
// "full" and an "empty" one a stage.
template <typename T, bool ALIGNED, int TS, int ST>
struct BwdRing {
  static constexpr int DC = ROW_BYTES / (int)sizeof(T);  // channels
  static constexpr int THREADS = 2 * DC;  // DC consumers, DC producers
  static constexpr int PAD = ALIGNED ? 0 : 16;
  static constexpr int ROW_T = ROW_BYTES + PAD;  // bytes a row of a or dh
  static constexpr int ROW_F = DC * 4 + PAD;     // bytes a row of h32
  static constexpr int STAGE = TS * (2 * ROW_T + ROW_F);
  static constexpr int SMEM = ST * (STAGE + 16);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised mbarriers visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// an arrival on `bar` once this thread's cp.async copies so far have
// landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Producer p's share of one tile of the reverse walk into a stage: time
// steps [t0, t0 + rows) of a and dh, and the carry's steps [t0 - 1, t0 +
// rows - 1) (from stage row 1 at t0 = 0, where h_{-1} is h0). `at`:
// element (b, t0, c0). It arrives once on the stage's full barrier, after
// its copies have landed.
template <typename T, bool ALIGNED, int TS, int ST>
__device__ __forceinline__ void fill_bwd_tile(
    unsigned char* st, uint32_t full, const T* __restrict__ a,
    const float* __restrict__ h32, const T* __restrict__ dh, size_t at,
    int t0, int rows, int n, int D, int p) {
  using R = BwdRing<T, ALIGNED, TS, ST>;
  constexpr int P = R::DC;  // producers
  unsigned char* sd = st + TS * R::ROW_T;
  unsigned char* sh = st + 2 * TS * R::ROW_T;
  copy_rows<ALIGNED, TS, R::ROW_T, P>(st, a + at, 0, 0, rows, n, D, p);
  if (dh)
    copy_rows<ALIGNED, TS, R::ROW_T, P>(sd, dh + at, 0, 0, rows, n, D, p);
  copy_rows<ALIGNED, TS, R::ROW_F, P>(sh, h32 + at, 1, t0 == 0 ? 1 : 0, rows,
                                      n, D, p);
  cp_async_arrive(full);
}

// One block a (b, 128-byte channel segment), walking S from the end
// through a ring of ST stages of TS steps (see the notes at the top): the
// first DC threads are the chain's, one a channel; the other DC fill the
// stages. Walk tile i (time tile tiles - 1 - i) sits in stage i % ST; its
// full barrier completes its phase i / ST when the tile has landed, its
// empty barrier when every consumer has read it.
template <typename T, bool ALIGNED, int TS, int ST>
__global__ void __launch_bounds__(BwdRing<T, ALIGNED, TS, ST>::THREADS)
rg_lru_bwd_ring_kernel(const T* __restrict__ a, const float* __restrict__ h32,
                       const T* __restrict__ h0, const T* __restrict__ dh,
                       const T* __restrict__ dh_last, T* __restrict__ da,
                       T* __restrict__ dgx, T* __restrict__ dh0, int S,
                       int D) {
  using R = BwdRing<T, ALIGNED, TS, ST>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c0 = blockIdx.x * R::DC;
  const int n = min(R::DC, D - c0);  // channels of this block
  const int b = blockIdx.y;
  const size_t first = (size_t)b * S * D + c0;  // element (b, 0, c0)
  const int tiles = (S + TS - 1) / TS;
  const uint32_t full = smem_addr(smem_raw + ST * R::STAGE);
  const uint32_t empty = full + 8 * ST;
  if (threadIdx.x == 0) {
    for (int j = 0; j < ST; ++j) {
      mbar_init(full + 8 * j, R::DC);
      mbar_init(empty + 8 * j, R::DC);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if ((int)threadIdx.x >= R::DC) {  // a producer
    const int p = threadIdx.x - R::DC;
    for (int i = 0; i < tiles; ++i) {
      const int j = i % ST;
      if (i >= ST) mbar_wait(empty + 8 * j, (i / ST - 1) & 1);
      const int t0 = (tiles - 1 - i) * TS;
      fill_bwd_tile<T, ALIGNED, TS, ST>(
          smem_raw + j * R::STAGE, full + 8 * j, a, h32, dh,
          first + (size_t)t0 * D, t0, min(TS, S - t0), n, D, p);
    }
    cp_async_commit();  // leave no copy of this thread in flight
    cp_async_wait<0>();
    return;
  }
  const bool live = (int)threadIdx.x < n;
  const bool has_dh = dh != nullptr;
  const size_t row = (size_t)b * D + c0 + threadIdx.x;
  const float h_init = (live && h0) ? to_f32(h0[row]) : 0.f;
  // a_{t+1} g_{t+1}, what step t adds to dh_t; dh_last at t = S - 1
  float g_in = (live && dh_last) ? to_f32(dh_last[row]) : 0.f;
  for (int i = 0; i < tiles; ++i) {
    const int j = i % ST;
    mbar_wait(full + 8 * j, (i / ST) & 1);
    const int t0 = (tiles - 1 - i) * TS, rows = min(TS, S - t0);
    if (live) {
      const unsigned char* st = smem_raw + j * R::STAGE;
      const T* as = reinterpret_cast<const T*>(st) + threadIdx.x;
      const T* ds =
          reinterpret_cast<const T*>(st + TS * R::ROW_T) + threadIdx.x;
      const float* hs =
          reinterpret_cast<const float*>(st + 2 * TS * R::ROW_T) +
          threadIdx.x;
      const size_t base = first + (size_t)t0 * D;
      // each row's shift in its window, from the tile's last row down:
      // row t - 1 sits D mod VEC elements before row t (the carry's row is
      // one step back, so its shift trails a's by D mod 4)
      constexpr int VT = 16 / (int)sizeof(T);
      const size_t last = base + (size_t)(rows - 1) * D;
      int sa = shift_of<ALIGNED>(a + last);
      int sd = has_dh ? shift_of<ALIGNED>(dh + last) : 0;
      int sh = (shift_of<ALIGNED>(h32 + last) - D % 4) & 3;
      auto back = [&](int r) {
        const size_t at = base + (size_t)r * D + threadIdx.x;  // t0 + r
        const float g =
            has_dh
                ? __fadd_rn(to_f32(ds[r * (R::ROW_T / (int)sizeof(T)) + sd]),
                            g_in)
                : g_in;
        const float h_prev =
            t0 + r > 0 ? hs[r * (R::ROW_F / 4) + sh] : h_init;
        store(&dgx[at], g);
        store(&da[at], __fmul_rn(g, h_prev));
        g_in =
            __fmul_rn(to_f32(as[r * (R::ROW_T / (int)sizeof(T)) + sa]), g);
        if (!ALIGNED) {
          sa = (sa - D % VT) & (VT - 1);
          sd = (sd - D % VT) & (VT - 1);
          sh = (sh - D % 4) & 3;
        }
      };
      if (rows == TS) {
#pragma unroll 16
        for (int r = TS - 1; r >= 0; --r) back(r);
      } else {
        for (int r = rows - 1; r >= 0; --r) back(r);
      }
    }
    mbar_arrive(empty + 8 * j);  // this thread is done with the stage
  }
  if (live && dh0) store(&dh0[row], g_in);
}

// ------------------------------------------------------------------ launch

template <typename T, bool CARRY>
int launch_step_instance(const void* a, const void* gx, const void* h0,
                         void* h, void* h_last, void* h32, int B, int S,
                         int D, cudaStream_t stream) {
  dim3 grid((D + STEP_THREADS - 1) / STEP_THREADS, B);
  rg_lru_step_kernel<T, CARRY><<<grid, STEP_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(gx),
      static_cast<const T*>(h0), static_cast<T*>(h), static_cast<T*>(h_last),
      static_cast<float*>(h32), S, D);
  return (int)cudaGetLastError();
}

// the instance with the carry when h32 is given
template <typename T>
int launch_step(const void* a, const void* gx, const void* h0, void* h,
                void* h_last, void* h32, int B, int S, int D,
                cudaStream_t stream) {
  return h32 ? launch_step_instance<T, true>(a, gx, h0, h, h_last, h32, B,
                                             S, D, stream)
             : launch_step_instance<T, false>(a, gx, h0, h, h_last, h32, B,
                                              S, D, stream);
}

// a ring's dynamic shared memory may pass 48 KB; the attribute is set once
// a device for each kernel instance (`done`: that instance's flags), not at
// every launch
template <typename F>
cudaError_t allow_smem(std::atomic<bool> (&done)[MAX_DEVICES], F kernel,
                       int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev].load()) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev].store(true);
  }
  return cudaSuccess;
}

template <typename T, bool ALIGNED, int TS, int ST, bool CARRY>
int launch_ring_instance(const void* a, const void* gx, const void* h0,
                         void* h, void* h_last, void* h32, int B, int S,
                         int D, cudaStream_t stream) {
  using R = Ring<T, ALIGNED, TS, ST>;
  static std::atomic<bool> done[MAX_DEVICES];
  cudaError_t err = allow_smem(
      done, rg_lru_ring_kernel<T, ALIGNED, TS, ST, CARRY>, R::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + R::DC - 1) / R::DC, B);
  rg_lru_ring_kernel<T, ALIGNED, TS, ST, CARRY>
      <<<grid, R::DC, R::SMEM, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(gx),
      static_cast<const T*>(h0), static_cast<T*>(h), static_cast<T*>(h_last),
      static_cast<float*>(h32), S, D);
  return (int)cudaGetLastError();
}

// the instance with the carry when h32 is given
template <typename T, bool ALIGNED, int TS, int ST>
int launch_ring(const void* a, const void* gx, const void* h0, void* h,
                void* h_last, void* h32, int B, int S, int D,
                cudaStream_t stream) {
  return h32 ? launch_ring_instance<T, ALIGNED, TS, ST, true>(
                   a, gx, h0, h, h_last, h32, B, S, D, stream)
             : launch_ring_instance<T, ALIGNED, TS, ST, false>(
                   a, gx, h0, h, h_last, h32, B, S, D, stream);
}

// the plan against this dtype's compiled instances, then the launch
template <typename T>
int plan_and_launch(const void* a, const void* gx, const void* h0, void* h,
                    void* h_last, void* h32, int B, int S, int D, int kernel,
                    int tile_s, int tile_d, int stages, int aligned,
                    int grid_x, int smem, cudaStream_t stream) {
  if (tile_d <= 0 || grid_x != (D + tile_d - 1) / tile_d)
    return (int)cudaErrorInvalidValue;
  if (kernel == KERNEL_STEP) {
    if (tile_s != U || tile_d != STEP_THREADS || stages != 0 || smem != 0)
      return (int)cudaErrorInvalidValue;
    return launch_step<T>(a, gx, h0, h, h_last, h32, B, S, D, stream);
  }
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(gx);
  if (kernel != KERNEL_RING || tile_s != TILE_S ||
      tile_d != ROW_BYTES / (int)sizeof(T) || stages != STAGES ||
      ptrs % sizeof(T) != 0)
    return (int)cudaErrorInvalidValue;
  if (aligned) {
    if (smem != Ring<T, true, TILE_S, STAGES>::SMEM ||
        (size_t)D * sizeof(T) % 16 != 0 || ptrs % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_ring<T, true, TILE_S, STAGES>(a, gx, h0, h, h_last, h32, B,
                                                S, D, stream);
  }
  if (smem != Ring<T, false, TILE_S, STAGES>::SMEM)
    return (int)cudaErrorInvalidValue;
  return launch_ring<T, false, TILE_S, STAGES>(a, gx, h0, h, h_last, h32, B,
                                               S, D, stream);
}

template <typename T, bool ALIGNED, int TS = BWD_TILE_S, int ST = BWD_STAGES>
int launch_bwd_ring(const void* a, const void* h32, const void* h0,
                    const void* dh, const void* dh_last, void* da, void* dgx,
                    void* dh0, int B, int S, int D, cudaStream_t stream) {
  using R = BwdRing<T, ALIGNED, TS, ST>;
  static std::atomic<bool> done[MAX_DEVICES];
  cudaError_t err = allow_smem(
      done, rg_lru_bwd_ring_kernel<T, ALIGNED, TS, ST>, R::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + R::DC - 1) / R::DC, B);
  rg_lru_bwd_ring_kernel<T, ALIGNED, TS, ST>
      <<<grid, R::THREADS, R::SMEM, stream>>>(
          static_cast<const T*>(a), static_cast<const float*>(h32),
          static_cast<const T*>(h0), static_cast<const T*>(dh),
          static_cast<const T*>(dh_last), static_cast<T*>(da),
          static_cast<T*>(dgx), static_cast<T*>(dh0), S, D);
  return (int)cudaGetLastError();
}

// the backward's plan against this dtype's compiled instances, then the
// launch
template <typename T>
int bwd_plan_and_launch(const void* a, const void* h32, const void* h0,
                        const void* dh, const void* dh_last, void* da,
                        void* dgx, void* dh0, int B, int S, int D, int kernel,
                        int tile_s, int tile_d, int stages, int aligned,
                        int grid_x, int smem, cudaStream_t stream) {
  if (tile_d <= 0 || grid_x != (D + tile_d - 1) / tile_d)
    return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(dh);
  const uintptr_t carry = reinterpret_cast<uintptr_t>(h32);
  if (kernel != KERNEL_RING || tile_s != BWD_TILE_S ||
      tile_d != ROW_BYTES / (int)sizeof(T) || stages != BWD_STAGES ||
      ptrs % sizeof(T) != 0 || carry % sizeof(float) != 0)
    return (int)cudaErrorInvalidValue;
  if (aligned) {
    if (smem != BwdRing<T, true, BWD_TILE_S, BWD_STAGES>::SMEM ||
        (size_t)D * sizeof(T) % 16 != 0 ||
        (size_t)D * sizeof(float) % 16 != 0 || (ptrs | carry) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return launch_bwd_ring<T, true>(a, h32, h0, dh, dh_last, da, dgx, dh0, B,
                                    S, D, stream);
  }
  if (smem != BwdRing<T, false, BWD_TILE_S, BWD_STAGES>::SMEM)
    return (int)cudaErrorInvalidValue;
  return launch_bwd_ring<T, false>(a, h32, h0, dh, dh_last, da, dgx, dh0, B,
                                   S, D, stream);
}

}  // namespace

// a, gx, h: (B, S, D); h0 (may be null: zeros), h_last: (B, D); h32 (may be
// null: not written): the f32 carry (B, S, D); all contiguous, dtype 0 =
// float32, 1 = bfloat16. The launch plan (kernel 0 =
// step, 1 = ring; tile_s, tile_d, stages, aligned, grid_x, smem) comes from
// kernels/rg_lru.py::launch_plan and must match a compiled instance.
// Returns a cudaError_t (0 = launched).
extern "C" int rg_lru_fwd(const void* a, const void* gx, const void* h0,
                          void* h, void* h_last, void* h32, int B, int S,
                          int D,
                          int dtype, int kernel, int tile_s, int tile_d,
                          int stages, int aligned, int grid_x, int smem,
                          void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return plan_and_launch<float>(a, gx, h0, h, h_last, h32, B, S, D, kernel,
                                  tile_s, tile_d, stages, aligned, grid_x,
                                  smem, s);
  if (dtype == 1)
    return plan_and_launch<bf16>(a, gx, h0, h, h_last, h32, B, S, D, kernel,
                                 tile_s, tile_d, stages, aligned, grid_x,
                                 smem, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: a (B, S, D), h32 the forward's f32 carry (B, S, D); h0
// (null: zeros), dh (null: zeros), dh_last (null: zeros) -> da, dgx (B, S,
// D) and dh0 (B, D; null: not written), all in a's dtype (0 = float32, 1 =
// bfloat16) but h32, contiguous. The launch plan (kernel 1 = ring, the
// only one; tile_s, tile_d, stages, aligned, grid_x, smem) comes from
// kernels/rg_lru.py::bwd_launch_plan and must match a compiled instance.
// Returns a cudaError_t (0 = launched).
extern "C" int rg_lru_bwd(const void* a, const void* h32, const void* h0,
                          const void* dh, const void* dh_last, void* da,
                          void* dgx, void* dh0, int B, int S, int D,
                          int dtype, int kernel, int tile_s, int tile_d,
                          int stages, int aligned, int grid_x, int smem,
                          void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_plan_and_launch<float>(a, h32, h0, dh, dh_last, da, dgx, dh0,
                                      B, S, D, kernel, tile_s, tile_d, stages,
                                      aligned, grid_x, smem, s);
  if (dtype == 1)
    return bwd_plan_and_launch<bf16>(a, h32, h0, dh, dh_last, da, dgx, dh0, B,
                                     S, D, kernel, tile_s, tile_d, stages,
                                     aligned, grid_x, smem, s);
  return (int)cudaErrorInvalidValue;
}

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
// The backward, rg_lru_bwd_kernel: the VJP of the scan by a reverse one,
// g_t = dh_t + a_{t+1} g_{t+1} (g_{S-1} = dh_{S-1} + dh_last), dgx_t = g_t,
// da_t = g_t h_{t-1} (h_{-1} = h0, or 0), dh0 = a_0 g_0. One thread per
// (b, channel) walks S from the end with g in a register, 64 channels a
// block, the next UB = 16 steps of a, dh and h32 loaded into registers
// ahead of the chain (all of a chunk's loads in flight at once, see
// load_bwd_chunk); every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn), in reverse time order per channel, so it is bit
// for bit the plain version (kernels/ref.py::rg_lru_bwd) and bit-identical
// across launches. It moves 12 bytes an element in bf16 (a, dh read, h32
// read in f32, da and dgx written): at recurrentgemma-9b's training shape
// (2, 4096, 4096) 403 MB, 0.120 ms at 3.35 TB/s. Its 8,192 chains keep
// about 1 MB of loads in flight, a third of what the card needs at full
// rate: 0.2995 ms on an H100 (tune_rg_lru --bwd; 32 to 256 channels a
// block and 8 to 32 steps ahead were timed, 64 x 16 was among the
// fastest). The forward's cp.async ring run backwards is the next step.
#include <atomic>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
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
// the backward kernel
constexpr int BWD_THREADS = 64;
constexpr int UB = 16;  // timesteps held in registers per chunk
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

// rows [0, rows) of a and gx from element `first` (= (b, t0, c0)), n
// channels, into one stage: a at dst, gx at dst + TILE, row-major
// (TS, PITCH). A copy is made only if it holds one of the rows' elements,
// so it never reads outside the 16-byte granules that hold the inputs.
template <typename T, bool ALIGNED, int TS, int ST>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ a,
                                          const T* __restrict__ gx,
                                          size_t first, int rows, int n,
                                          int D) {
  using R = Ring<T, ALIGNED, TS, ST>;
  // CHUNKS consecutive threads copy one row segment
#pragma unroll
  for (int k = 0; k < R::COPIES; ++k) {
    const int i = k * R::DC + threadIdx.x;
    const int r = i / R::CHUNKS, c = (i % R::CHUNKS) * R::VEC;
    if (i < TS * R::CHUNKS && r < rows) {
      const T* pa = a + first + (size_t)r * D;
      const T* pg = gx + first + (size_t)r * D;
      const int sa = shift_of<ALIGNED>(pa), sg = shift_of<ALIGNED>(pg);
      if (c - sa < n)
        cp_async16(smem_addr(dst + r * R::PITCH + c), pa - sa + c);
      if (c - sg < n)
        cp_async16(smem_addr(dst + R::TILE + r * R::PITCH + c), pg - sg + c);
    }
  }
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

// -------------------------------------------------------- backward kernel

// steps t = t_hi, t_hi - 1, .., t_hi - UN + 1 of the reverse walk, as
// loaded: a_t and dh_t in their dtype and h_{t-1}, the f32 carry a step
// back. Every load is made, none behind a branch, and nothing is converted
// here: a step past 0 (the last chunk of a ragged S) or the carry before
// step 0 reads step 0 again, and the walk does not use it. So the chunk's
// loads all leave before the first of them is waited for (converting a
// load where it is made, or branching around it, waits for each in turn:
// a memory latency a step).
template <typename T, int UN>
__device__ __forceinline__ void load_bwd_chunk(
    const T* __restrict__ a, const float* __restrict__ h32,
    const T* __restrict__ dh, size_t base, int t_hi, int D, T (&ar)[UN],
    float (&hr)[UN], T (&dr)[UN]) {
#pragma unroll
  for (int u = 0; u < UN; ++u) {
    const int t = max(t_hi - u, 0);
    ar[u] = a[base + (size_t)t * D];
    dr[u] = dh[base + (size_t)t * D];
    hr[u] = h32[base + (size_t)max(t - 1, 0) * D];
  }
}

// THREADS channels a block, UN steps in registers ahead of the chain (the
// compiled instance: BWD_THREADS, UB; tune_rg_lru --bwd times others)
template <typename T, int THREADS, int UN>
__global__ void __launch_bounds__(THREADS)
rg_lru_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h32,
                  const T* __restrict__ h0, const T* __restrict__ dh,
                  const T* __restrict__ dh_last, T* __restrict__ da,
                  T* __restrict__ dgx, T* __restrict__ dh0, int S, int D) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= D) return;
  const size_t base = (size_t)b * S * D + c;
  const size_t row = (size_t)b * D + c;
  const float h_init = h0 ? to_f32(h0[row]) : 0.f;
  // without dh the loads read a in its place, and the walk adds zeros
  const bool has_dh = dh != nullptr;
  const T* __restrict__ dh_src = has_dh ? dh : a;
  // a_{t+1} g_{t+1}, what step t adds to dh_t; dh_last at t = S - 1
  float g_in = dh_last ? to_f32(dh_last[row]) : 0.f;
  T an[UN], dn[UN];
  float hn[UN];
  load_bwd_chunk<T, UN>(a, h32, dh_src, base, S - 1, D, an, hn, dn);
  for (int t0 = S - 1; t0 >= 0; t0 -= UN) {
    T ac[UN], dc[UN];
    float hc[UN];
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      ac[u] = an[u];
      hc[u] = hn[u];
      dc[u] = dn[u];
    }
    if (t0 - UN >= 0)
      load_bwd_chunk<T, UN>(a, h32, dh_src, base, t0 - UN, D, an, hn, dn);
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float g =
            __fadd_rn(has_dh ? to_f32(dc[u]) : 0.f, g_in);
        const size_t i = base + (size_t)t * D;
        store(&dgx[i], g);
        store(&da[i], __fmul_rn(g, t > 0 ? hc[u] : h_init));
        g_in = __fmul_rn(to_f32(ac[u]), g);
      }
    }
  }
  if (dh0) store(&dh0[row], g_in);
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

// the ring's dynamic shared memory may pass 48 KB; the attribute is set once
// a device, not at every launch
template <typename T, bool ALIGNED, int TS, int ST, bool CARRY>
cudaError_t allow_smem() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev].load()) {
    err = cudaFuncSetAttribute(rg_lru_ring_kernel<T, ALIGNED, TS, ST, CARRY>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ring<T, ALIGNED, TS, ST>::SMEM);
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
  cudaError_t err = allow_smem<T, ALIGNED, TS, ST, CARRY>();
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

template <typename T, int THREADS = BWD_THREADS, int UN = UB>
int launch_bwd(const void* a, const void* h32, const void* h0, const void* dh,
               const void* dh_last, void* da, void* dgx, void* dh0, int B,
               int S, int D, cudaStream_t stream) {
  dim3 grid((D + THREADS - 1) / THREADS, B);
  rg_lru_bwd_kernel<T, THREADS, UN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const float*>(h32),
      static_cast<const T*>(h0), static_cast<const T*>(dh),
      static_cast<const T*>(dh_last), static_cast<T*>(da),
      static_cast<T*>(dgx), static_cast<T*>(dh0), S, D);
  return (int)cudaGetLastError();
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
// bfloat16) but h32, contiguous. The plan (tile_d channels a block, unroll
// steps in registers, grid_x blocks over D) comes from
// kernels/rg_lru.py::bwd_launch_plan and must match the compiled instance.
// Returns a cudaError_t (0 = launched).
extern "C" int rg_lru_bwd(const void* a, const void* h32, const void* h0,
                          const void* dh, const void* dh_last, void* da,
                          void* dgx, void* dh0, int B, int S, int D,
                          int dtype, int tile_d, int unroll, int grid_x,
                          void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535 || tile_d != BWD_THREADS ||
      unroll != UB || grid_x != (D + BWD_THREADS - 1) / BWD_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(a, h32, h0, dh, dh_last, da, dgx, dh0, B, S, D,
                             s);
  if (dtype == 1)
    return launch_bwd<bf16>(a, h32, h0, dh, dh_last, da, dgx, dh0, B, S, D,
                            s);
  return (int)cudaErrorInvalidValue;
}

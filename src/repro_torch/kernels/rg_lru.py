"""RG-LRU linear recurrence: the wrappers of the CUDA kernels in
``csrc/rg_lru.cu`` (the forward, the Hopper port of the Pallas TPU kernel
``repro/kernels/rg_lru.py::rg_lru_pallas``, and the backward, the port of
the VJP the reference takes of ``repro/kernels/ops.py::_rg_lru_assoc`` by
autodiff).

``h_t = a_t * h_{t-1} + gx_t`` elementwise over channels, f32 carry, each
step's product rounded before the add, in time order: both kernels are bit
for bit the plain sequential version in ``kernels/ref.py``.

``launch_plan`` picks the kernel by shape, and the C entry point checks the
plan against its compiled instances:

- ``ring`` (S >= one time tile, the prefill): a block owns one batch row and
  one 128-byte row segment of channels (64 bf16, 32 f32), one thread each,
  and walks all of S, reading ``a`` and ``gx`` from a ring of time tiles in
  shared memory that ``cp.async`` fills several tiles ahead of the chain
  (a row that does not start on a 16-byte boundary is copied as the
  aligned window that holds it and read at its shift);
- ``step`` (S < one time tile, the decode step S = 1): 256 channels a
  block, the next 8 timesteps loaded into registers ahead of the chain.

Gradient: inputs that need a gradient go through ``_RGLRUFunction``. Its
forward launches the forward kernel, which then also writes the f32 carry
h32 (B, S, D) (bf16 inputs; in f32 the carry is h itself), and saves
(a, h32, h0): the backward's da_t = g_t h_{t-1} needs h in f32, as the
reference differentiates its f32 scan. The carry is stored, not recomputed
(134 MB a layer at recurrentgemma-9b's 2 x 4096 tokens). Its backward
launches ``rg_lru_bwd``: one thread per (b, channel) walks S from the end,
g_t = dh_t + a_{t+1} g_{t+1}, dgx_t = g_t, da_t = g_t h_{t-1}, dh0 = a_0 g_0,
each product rounded before its add, so it is bit for bit the plain
``ref.rg_lru_bwd`` and bit-identical across launches. Its one kernel, a
``ring`` at every S (``bwd_launch_plan``), has the forward ring's blocks
and reads a, dh and the carry one step back from a ring of time tiles
filled in reverse order, several tiles ahead of the chain; a sequence
shorter than one tile is one partial tile. Without a gradient (prefill,
decode) the forward writes no carry.

The wrappers take CUDA tensors only and raise on anything the kernels do
not take (before any build); ``kernels/ops.py`` sends CPU tensors to the
plain versions.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {"step": 0, "ring": 1}
_lib = None
_bwd_lib = None

# the compiled instances of csrc/rg_lru.cu (its constants of the same names)
STEP_THREADS, U = 256, 8
ROW_BYTES, TILE_S, STAGES = 128, 32, 3
BWD_TILE_S, BWD_STAGES = 32, 3
# the C entry points' arguments: pointers, then ints, then the stream
FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
# an H100 SM: shared memory, of which 1 KB is reserved for each block;
# resident threads and blocks; registers, at most 255 a thread
SM_SMEM, SMEM_RESERVED = 233_472, 1024
SM_THREADS, SM_BLOCKS, SM_REGISTERS, MAX_REGISTERS = 2048, 32, 65_536, 255


class LaunchPlan(NamedTuple):
    kernel: str          # "ring" or "step"
    tile_s: int          # timesteps a ring tile, or held in registers (step)
    tile_d: int          # channels a block, one thread each
    stages: int          # tiles in the shared-memory ring (step: 0)
    aligned: bool        # ring rows start on 16-byte boundaries; else each
    #                      row is copied as its aligned window, 16 B more
    grid: Tuple[int, int]  # (channel tiles, B); every block walks all of S
    smem: int            # dynamic shared memory a block, bytes
    blocks_per_sm: int   # blocks an SM holds at least, by threads, shared
    #                      memory and registers (even at 255 a thread)


def launch_plan(b: int, s: int, d: int, dtype: torch.dtype,
                aligned: bool = True) -> LaunchPlan:
    """The kernel and tiles for (B, S, D) in ``dtype``; ``aligned``: both
    inputs start on a 16-byte boundary."""
    size = dtype.itemsize
    if s < TILE_S:
        kernel, tile_s, tile_d, stages, aligned, smem = \
            "step", U, STEP_THREADS, 0, True, 0
    else:
        kernel, tile_s, tile_d, stages = \
            "ring", TILE_S, ROW_BYTES // size, STAGES
        aligned = aligned and d * size % 16 == 0
        smem = stages * 2 * tile_s * (ROW_BYTES + (0 if aligned else 16))
    blocks = min(SM_THREADS // tile_d, SM_BLOCKS,
                 SM_REGISTERS // (tile_d * MAX_REGISTERS),
                 SM_SMEM // (smem + SMEM_RESERVED))
    return LaunchPlan(kernel, tile_s, tile_d, stages, aligned,
                      (-(-d // tile_d), b), smem, blocks)


def bwd_launch_plan(b: int, s: int, d: int, dtype: torch.dtype,
                    aligned: bool = True) -> LaunchPlan:
    """The backward's ring and tiles for (B, S, D) in ``dtype``, at every
    S (below one tile, one partial tile); ``aligned``: a, dh and the carry
    start on a 16-byte boundary. Its blocks have two threads a channel (a
    consumer, which runs the chain, and a producer, which fills the
    stages); a stage holds ``tile_s`` rows of a and dh (128 bytes of
    channels a row) and of the f32 carry (4 bytes a channel), each row 16
    bytes wider when rows are read at a shift, and two mbarriers (16
    bytes)."""
    del s  # every S walks the same tiles
    size = dtype.itemsize
    tile_s, tile_d, stages = BWD_TILE_S, ROW_BYTES // size, BWD_STAGES
    aligned = aligned and d * size % 16 == 0 and d * 4 % 16 == 0
    pad = 0 if aligned else 16
    smem = stages * (tile_s * (2 * (ROW_BYTES + pad) + tile_d * 4 + pad)
                     + 16)
    threads = 2 * tile_d
    blocks = min(SM_THREADS // threads, SM_BLOCKS,
                 SM_REGISTERS // (threads * MAX_REGISTERS),
                 SM_SMEM // (smem + SMEM_RESERVED))
    return LaunchPlan("ring", tile_s, tile_d, stages, aligned,
                      (-(-d // tile_d), b), smem, blocks)


def _kernel():
    global _lib
    if _lib is None:
        fn = build.library("rg_lru").rg_lru_fwd
        fn.argtypes = FWD_ARGTYPES
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _bwd_kernel():
    global _bwd_lib
    if _bwd_lib is None:
        fn = build.library("rg_lru").rg_lru_bwd
        fn.argtypes = BWD_ARGTYPES
        fn.restype = ctypes.c_int
        _bwd_lib = fn
    return _bwd_lib


def _check(what, a, *, like_a=(), rows=()):
    """a (B, S, D) float32 or bfloat16; the tensors ``like_a`` of a's shape
    and dtype, ``rows`` (B, D) of a's dtype (None: absent); contiguous, on
    one CUDA device."""
    tensors = [t for t in (a, *like_a, *rows) if t is not None]
    build.local_only(what, *tensors)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError(f"{what}: inputs must be on one CUDA device")
    if a.dtype not in _DTYPES or any(t.dtype != a.dtype for t in tensors):
        raise ValueError(f"{what}: dtypes {[t.dtype for t in tensors]}; "
                         f"needs one of float32, bfloat16 for all")
    if a.dim() != 3 or 0 in a.shape or a.shape[0] > 65535 \
            or any(t is not None and t.shape != a.shape for t in like_a):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}"
                         f"; needs equal non-empty (B, S, D), B <= 65535")
    b, _, d = a.shape
    if any(t is not None and t.shape != (b, d) for t in rows):
        raise ValueError(f"{what}: {[tuple(t.shape) for t in tensors]} for "
                         f"(B, D) = {(b, d)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")


def _launch_fwd(a, gx, h0, carry):
    """(h, h_last, h32): with ``carry`` the f32 carry (h itself in f32),
    else None."""
    b, s, d = a.shape
    plan = launch_plan(b, s, d, a.dtype, aligned=(
        a.data_ptr() % 16 == 0 and gx.data_ptr() % 16 == 0))
    fn = _kernel()
    h = torch.empty_like(a)
    h_last = torch.empty((b, d), dtype=a.dtype, device=a.device)
    h32 = (torch.empty(a.shape, dtype=torch.float32, device=a.device)
           if carry and a.dtype != torch.float32 else None)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), gx.data_ptr(),
                 None if h0 is None else h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), None if h32 is None else h32.data_ptr(),
                 b, s, d, _DTYPES[a.dtype], _KERNELS[plan.kernel],
                 plan.tile_s, plan.tile_d, plan.stages, int(plan.aligned),
                 plan.grid[0], plan.smem, build.stream_ptr(a))
    build.check(err, "rg_lru_fwd")
    rg_lru.launches += 1
    if carry and h32 is None:      # f32: h is the carry
        h32 = h
    return h, h_last, h32


class _RGLRUFunction(torch.autograd.Function):
    """The forward kernel with its f32 carry; the backward kernel."""

    @staticmethod
    def forward(ctx, a, gx, h0):
        ctx.set_materialize_grads(False)
        h, h_last, h32 = _launch_fwd(a, gx, h0, carry=True)
        ctx.save_for_backward(a, h32, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        if dh is None and dh_last is None:
            return None, None, None
        a, h32, h0 = ctx.saved_tensors
        da, dgx, dh0 = rg_lru_bwd(
            a, h32, None if dh is None else dh.contiguous(),
            None if dh_last is None else dh_last.contiguous(), h0)
        return tuple(g if need else None for g, need in
                     zip((da, dgx, dh0), ctx.needs_input_grad))


def rg_lru(a, gx, h0=None, return_carry=False):
    """a, gx: (B, S, D) contiguous CUDA tensors, both float32 or both
    bfloat16; h0: (B, D) of the same dtype, or None for zeros ->
    (h (B, S, D), h_last (B, D)) in a's dtype; differentiable in a, gx, h0.
    ``return_carry`` (no gradient): (h, h_last, h32) with the f32 carry h32
    (B, S, D) the backward reads."""
    _check("rg_lru kernel", a, like_a=(gx,), rows=(h0,))
    grad = torch.is_grad_enabled() and (a.requires_grad or gx.requires_grad
                                        or (h0 is not None
                                            and h0.requires_grad))
    if grad and return_carry:
        raise ValueError("rg_lru kernel: return_carry is for inputs that "
                         "need no gradient")
    if grad:
        return _RGLRUFunction.apply(a, gx, h0)
    h, h_last, h32 = _launch_fwd(a, gx, h0, carry=return_carry)
    return (h, h_last, h32) if return_carry else (h, h_last)


def rg_lru_bwd(a, h32, dh, dh_last=None, h0=None):
    """The backward kernel: (da, dgx (B, S, D), dh0 (B, D), or None without
    h0) in a's dtype from the forward's a, its f32 carry ``h32`` (B, S, D),
    the output gradients ``dh`` (B, S, D) and ``dh_last`` (B, D) (either
    None: zero) and ``h0`` (None: zeros); all contiguous on one CUDA
    device."""
    _check("rg_lru_bwd kernel", a, like_a=(dh,), rows=(dh_last, h0))
    if not (h32.dtype == torch.float32 and h32.shape == a.shape
            and h32.is_contiguous() and h32.device == a.device):
        raise ValueError(f"rg_lru_bwd kernel: the carry must be contiguous "
                         f"float32 of a's shape {tuple(a.shape)} on its "
                         f"device, not {h32.dtype} {tuple(h32.shape)}")
    b, s, d = a.shape
    plan = bwd_launch_plan(b, s, d, a.dtype, aligned=all(
        t.data_ptr() % 16 == 0 for t in (a, h32, dh) if t is not None))
    fn = _bwd_kernel()
    da, dgx = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), h32.data_ptr(), ptr(h0), ptr(dh),
                 ptr(dh_last), da.data_ptr(), dgx.data_ptr(), ptr(dh0), b, s,
                 d, _DTYPES[a.dtype], _KERNELS[plan.kernel], plan.tile_s,
                 plan.tile_d, plan.stages, int(plan.aligned), plan.grid[0],
                 plan.smem, build.stream_ptr(a))
    build.check(err, "rg_lru_bwd")
    rg_lru_bwd.launches += 1
    return da, dgx, dh0


rg_lru.launches = 0
rg_lru_bwd.launches = 0

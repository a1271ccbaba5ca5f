"""RG-LRU linear recurrence: the wrapper of the CUDA kernels in
``csrc/rg_lru.cu`` (the Hopper port of the Pallas TPU kernel
``repro/kernels/rg_lru.py::rg_lru_pallas``).

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

The wrapper takes CUDA tensors only and raises on anything the kernels do
not take; ``kernels/ops.py`` sends CPU tensors to the plain version.
Forward only, as the TPU kernel is.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNELS = {"step": 0, "ring": 1}
_lib = None

# the compiled instances of csrc/rg_lru.cu (its constants of the same names)
STEP_THREADS, U = 256, 8
ROW_BYTES, TILE_S, STAGES = 128, 32, 3
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


def _kernel():
    global _lib
    if _lib is None:
        fn = build.library("rg_lru").rg_lru_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def rg_lru(a, gx, h0=None):
    """a, gx: (B, S, D) contiguous CUDA tensors, both float32 or both
    bfloat16; h0: (B, D) of the same dtype, or None for zeros ->
    (h (B, S, D), h_last (B, D)) in a's dtype."""
    if not (a.is_cuda and gx.device == a.device
            and (h0 is None or h0.device == a.device)):
        raise ValueError("rg_lru kernel: a, gx, h0 must be on one CUDA "
                         "device")
    if a.dtype not in _DTYPES or gx.dtype != a.dtype \
            or (h0 is not None and h0.dtype != a.dtype):
        raise ValueError(f"rg_lru kernel: dtypes {a.dtype}, {gx.dtype}, "
                         f"{None if h0 is None else h0.dtype}; needs one of "
                         f"float32, bfloat16 for all")
    if a.dim() != 3 or gx.shape != a.shape or 0 in a.shape \
            or a.shape[0] > 65535:
        raise ValueError(f"rg_lru kernel: shapes a {tuple(a.shape)} gx "
                         f"{tuple(gx.shape)}; needs equal non-empty "
                         f"(B, S, D), B <= 65535")
    b, s, d = a.shape
    if h0 is not None and h0.shape != (b, d):
        raise ValueError(f"rg_lru kernel: h0 {tuple(h0.shape)} for "
                         f"(B, D) = {(b, d)}")
    if not (a.is_contiguous() and gx.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("rg_lru kernel: inputs must be contiguous")
    if torch.is_grad_enabled() and (a.requires_grad or gx.requires_grad or (
            h0 is not None and h0.requires_grad)):
        raise NotImplementedError("rg_lru kernel is forward-only")
    plan = launch_plan(b, s, d, a.dtype, aligned=(
        a.data_ptr() % 16 == 0 and gx.data_ptr() % 16 == 0))
    fn = _kernel()
    h = torch.empty_like(a)
    h_last = torch.empty((b, d), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), gx.data_ptr(),
                 None if h0 is None else h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), b, s, d, _DTYPES[a.dtype],
                 _KERNELS[plan.kernel], plan.tile_s, plan.tile_d,
                 plan.stages, int(plan.aligned), plan.grid[0], plan.smem,
                 build.stream_ptr(a))
    build.check(err, "rg_lru_fwd")
    rg_lru.launches += 1
    return h, h_last


rg_lru.launches = 0

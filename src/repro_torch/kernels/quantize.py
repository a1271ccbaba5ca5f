"""Blockwise symmetric int8 quantization: the wrappers of the CUDA kernels
in ``csrc/quantize.cu`` (the Hopper port of the Pallas TPU kernels
``repro/kernels/quantize.py::quantize_blockwise_pallas`` and
``::dequantize_blockwise_pallas``).

Used by the burst-buffer checkpoint path: optimizer moments are quantized
*on the card* (f32 -> int8 + an f32 scale per 2048-element block) before
the device-to-host copy, so only the int8 payload and the scales cross the
host link; restore dequantizes on the card. The wrappers take CUDA tensors
only; ``kernels/ops.py`` sends CPU tensors to the plain versions in
``kernels/ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def _kernel(name, argtypes):
    if name not in _fns:
        fn = getattr(build.library("quantize"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check_block(n: int, block: int):
    if block <= 0 or block % 4 or n % block or n == 0:
        raise ValueError(f"blockwise int8: {n} elements in blocks of {block}"
                         f" (need a positive multiple of a block, block % 4 "
                         f"== 0)")


def quantize_blockwise(x, *, block=2048):
    """x: flat contiguous float32 (N,) on CUDA, N % block == 0 ->
    (q int8 (N,), scales float32 (N / block,))."""
    build.local_only("quantize_blockwise kernel", x)
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 1 \
            or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("quantize_blockwise kernel: needs a flat, "
                         "contiguous, 16-byte aligned float32 CUDA tensor; "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    n = x.shape[0]
    _check_block(n, block)
    fn = _kernel("quantize_blockwise",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p])
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(n // block, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), n // block,
                 block, build.stream_ptr(x))
    build.check(err, "quantize_blockwise")
    quantize_blockwise.launches += 1
    return q, scales


def dequantize_blockwise(q, scale, *, block=2048, out_dtype=torch.float32):
    """q: int8 (N,), scale: float32 (N / block,) on one CUDA device ->
    (N,) in ``out_dtype`` (float32 or bfloat16)."""
    build.local_only("dequantize_blockwise kernel", q, scale)
    if not (q.is_cuda and scale.device == q.device):
        raise ValueError("dequantize_blockwise kernel: q and scale must be "
                         "on one CUDA device")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or q.dim() != 1 or not q.is_contiguous() \
            or not scale.is_contiguous() or q.data_ptr() % 4:
        raise ValueError("dequantize_blockwise kernel: needs flat contiguous "
                         "int8 q and float32 scales")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"dequantize_blockwise kernel: out_dtype {out_dtype}"
                         f" not in {tuple(_OUT_DTYPES)}")
    n = q.shape[0]
    _check_block(n, block)
    if scale.shape != (n // block,):
        raise ValueError(f"dequantize_blockwise kernel: {tuple(scale.shape)} "
                         f"scales for {n // block} blocks")
    fn = _kernel("dequantize_blockwise",
                 [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p])
    out = torch.empty(n, dtype=out_dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), scale.data_ptr(), out.data_ptr(), n, block,
                 _OUT_DTYPES[out_dtype], build.stream_ptr(q))
    build.check(err, "dequantize_blockwise")
    dequantize_blockwise.launches += 1
    return out


quantize_blockwise.launches = 0
dequantize_blockwise.launches = 0

"""RG-LRU linear recurrence: the wrapper of the CUDA kernel
``csrc/rg_lru.cu`` (the Hopper port of the Pallas TPU kernel
``repro/kernels/rg_lru.py::rg_lru_pallas``).

``h_t = a_t * h_{t-1} + gx_t`` elementwise over channels, f32 carry. The
wrapper takes CUDA tensors only and raises on anything the kernel does not
take; ``kernels/ops.py`` sends CPU tensors to the plain sequential version
in ``kernels/ref.py``. Forward only, as the TPU kernel is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        fn = build.library("rg_lru").rg_lru_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
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
    fn = _kernel()
    h = torch.empty_like(a)
    h_last = torch.empty((b, d), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), gx.data_ptr(),
                 None if h0 is None else h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), b, s, d, _DTYPES[a.dtype],
                 build.stream_ptr(a))
    build.check(err, "rg_lru_fwd")
    rg_lru.launches += 1
    return h, h_last


rg_lru.launches = 0

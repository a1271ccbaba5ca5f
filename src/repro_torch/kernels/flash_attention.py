"""Flash attention forward: the wrapper of the CUDA kernel
``csrc/flash_attention.cu`` (the Hopper port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``).

bfloat16 inputs go to the tensor-core kernel (``mma.sync``, bf16 products
with f32 accumulation), float32 inputs to the f32 kernel on the CUDA cores
(the reference's f32 tolerance rules out TF32). The wrapper takes CUDA
tensors only and raises on anything the kernel for their dtype does not
take; it never routes an input to the other kernel or to the plain version.
``kernels/ops.py`` sends CPU tensors to the plain chunked version.
The kernel is forward-only: it refuses inputs that require a gradient
(the backward kernel comes with the training path).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 48, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.library("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) on one CUDA device, contiguous,
    all float32 or all bfloat16 -> (B, Sq, H, D) in q's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must be on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}; needs float32 or bfloat16")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel: inputs must be contiguous")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: bf16 inputs must start at "
                         "16-byte aligned addresses (16-byte async copies)")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError("flash_attention kernel is forward-only")
    fn = _kernel()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 b, sq, sk, h, kvh, d, _DTYPES[q.dtype], int(bool(causal)),
                 int(window), float(softcap), float(d ** -0.5), int(q_offset),
                 build.stream_ptr(q))
    build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

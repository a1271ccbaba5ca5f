"""Chunkwise mLSTM forward: the wrapper of the CUDA kernels ``csrc/mlstm.cu``
(the Hopper port of the Pallas TPU kernel
``repro/kernels/mlstm.py::mlstm_pallas``): bfloat16 inputs run on
``mlstm_mma_kernel`` (products on the tensor cores), float32 inputs on
``mlstm_simt_kernel`` (f32 on the CUDA cores).

The wrapper takes CUDA tensors only and raises on anything the kernel does
not take; ``kernels/ops.py`` sends CPU tensors, and calls that carry a
state, to the plain chunked version ``ops.mlstm_chunked``.

Gradient: the TPU kernel has no backward, and the reference trains through
autodiff of its plain chunked form (``repro/kernels/ops.py::
_mlstm_chunked_jnp``). So does the port: ``_MLSTMFunction`` runs the kernel
forward, saves its inputs, and its backward recomputes ``mlstm_chunked`` in
plain PyTorch under autograd and returns that recomputation's gradients.
The ``h`` the loss sees is the kernel's. A hand-written backward kernel is
later work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256, 512)
MAX_CHUNK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        fn = build.library("mlstm").mlstm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = fn
    return _lib


def _check(q, k, v, log_f, log_i, chunk):
    tensors = (q, k, v, log_f, log_i)
    build.local_only("mlstm kernel", *tensors)
    b, s, h, d = q.shape
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("mlstm kernel: q, k, v, log_f, log_i must be on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype \
            or log_f.dtype != torch.float32 or log_i.dtype != torch.float32:
        raise ValueError(f"mlstm kernel: dtypes {[t.dtype for t in tensors]}"
                         f"; needs q, k, v all float32 or all bfloat16 and "
                         f"float32 gates")
    if d not in HEAD_DIMS:
        raise ValueError(f"mlstm kernel: head dim {d} not in {HEAD_DIMS}")
    if k.shape != q.shape or v.shape != q.shape \
            or log_f.shape != (b, s, h) or log_i.shape != (b, s, h) \
            or 0 in q.shape or b > 65535 or h > 65535:
        raise ValueError(f"mlstm kernel: shapes q/k/v {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}, gates "
                         f"{tuple(log_f.shape)} {tuple(log_i.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"mlstm kernel: sequence {s} is not a multiple of "
                         f"chunk {chunk} (1 <= chunk <= {MAX_CHUNK})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlstm kernel: inputs must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("mlstm kernel: bfloat16 q, k, v must be 16-byte "
                         "aligned (the kernel copies 16-byte units)")


def _launch(q, k, v, log_f, log_i, chunk):
    b, s, h, d = q.shape
    fn = _kernel()
    out = torch.empty_like(q)
    c = torch.empty((b, h, d, d), dtype=q.dtype, device=q.device)
    n = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                 log_i.data_ptr(), out.data_ptr(), c.data_ptr(), n.data_ptr(),
                 m.data_ptr(), b, s, h, d, chunk, float(d ** -0.5),
                 _DTYPES[q.dtype], build.stream_ptr(q))
    build.check(err, "mlstm_fwd")
    mlstm.launches += 1
    return out, c, n, m


class _MLSTMFunction(torch.autograd.Function):
    """Kernel forward; backward by autograd through a plain recomputation."""

    @staticmethod
    def forward(ctx, q, k, v, log_f, log_i, chunk):
        ctx.save_for_backward(q, k, v, log_f, log_i)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        out, c, n, m = _launch(q, k, v, log_f, log_i, chunk)
        return out, c, n, m

    @staticmethod
    def backward(ctx, g_out, g_c, g_n, g_m):
        from repro_torch.kernels.ops import mlstm_chunked
        need = ctx.needs_input_grad[:5]
        inputs = [x.detach().requires_grad_(r)
                  for x, r in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out, (c, n, m) = mlstm_chunked(*inputs, chunk=ctx.chunk)
        pairs = [(y, g) for y, g in zip((out, c, n, m), (g_out, g_c, g_n, g_m))
                 if g is not None]
        wanted = [x for x, r in zip(inputs, need) if r]
        grads = iter(torch.autograd.grad([y for y, _ in pairs],
                                         wanted, [g for _, g in pairs],
                                         allow_unused=True)
                     if pairs and wanted else ())
        return (*(next(grads) if r else None for r in need), None)


def mlstm(q, k, v, log_f, log_i, *, chunk=128):
    """q/k/v: (B, S, H, D) contiguous CUDA tensors, all float32 or all
    bfloat16; log_f/log_i: (B, S, H) float32. From a fresh state, chunk
    ``min(chunk, S)``, which must divide S. Returns (h (B,S,H,D), (C
    (B,H,D,D), n (B,H,D)) in q's dtype, m (B,H) float32)."""
    chunk = min(chunk, q.shape[1])
    _check(q, k, v, log_f, log_i, chunk)
    out, c, n, m = _MLSTMFunction.apply(q, k, v, log_f, log_i, chunk)
    return out, (c, n, m)


mlstm.launches = 0

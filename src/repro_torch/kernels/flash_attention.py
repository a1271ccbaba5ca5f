"""Flash attention: the wrappers of the CUDA kernels
``csrc/flash_attention.cu`` (the forward, the Hopper port of the Pallas TPU
kernel ``repro/kernels/flash_attention.py::flash_attention_pallas``) and
``csrc/flash_attention_bwd.cu`` (the backward, the port of the reference's
plain-jnp ``repro/kernels/ops.py::_flash_bwd``).

Head dims: ``HEAD_DIMS`` (16, 32, 48, 64, 80, 128, 192, 256), each a
compiled instance of both forward and both backward kernels; 80 is
h2o-danube-1.8b's (2560 / 32), 128 starcoder2-3b's and
deepseek-coder-33b's, 192 deepseek-v3-671b's MLA, in its training and its
prefill (q/k head dim 128 + 64, V zero-padded from 128), 256 the gemma
family's.

Forward: bfloat16 inputs go to the tensor-core kernel (``mma.sync``, bf16
products with f32 accumulation), float32 inputs to the f32 kernel on the
CUDA cores (the reference's f32 tolerance rules out TF32). Either also
writes the f32 row statistics (m, l) when asked. Backward, deterministic
(no atomics): bfloat16 at every head dim on the tensor cores (P and dS
split into two bf16 operands each; at D = 128 the dk / dv kernel forms its
scores 16 queries at a time, below it a whole 64-query step at once; at
D = 80 and 128 the dq kernel walks 32-key tiles at 3 blocks an SM, below
64-key tiles at 2; at D = 192 and 256 the dk / dv launch gives dk and dv
blocks of their own on each 64-key tile (96 and 128 accumulators a thread
each) and walks q steps of 16 rows, and dq walks 16-key tiles, at about 77
and 100 KB of shared memory a block and 2 blocks an SM: the plans that keep
their accumulators in registers, chosen from ``ptxas -v`` and
``tune_flash_bwd``), float32 on the CUDA cores.

Gradient: a tensor that needs a gradient goes through ``_FlashFunction``,
the counterpart of the reference's custom VJP: its forward launches the
forward kernel with row statistics and saves (q, k, v, o, m, l) as
``_flash_fwd`` does; its backward launches the backward kernel. Without a
gradient (``no_grad``, ``inference_mode``) the forward runs without
statistics.

The wrappers take CUDA tensors only and raise on anything the kernels do
not take (dtype, head dim, shape and contiguity are checked before the
device, and all of it before any build); they never route an input to
another kernel or to the plain version. ``kernels/ops.py`` sends CPU
tensors to the plain chunked versions.

Each wrapper counts its launches (``launches``) and, beside them, its
launches by call shape (``shapes``: (B, Sq, Sk, H, KV, D, causal) ->
count), so that a path that calls a kernel at several shapes can say how
often it ran at each.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 48, 64, 80, 128, 192, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fwd = None
_bwd = None


def _fwd_kernel():
    global _fwd
    if _fwd is None:
        fn = build.library("flash_attention").flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def _bwd_kernel():
    global _bwd
    if _bwd is None:
        fn = build.library("flash_attention_bwd").flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd = fn
    return _bwd


def _check(what, q, k, v, *, like_q=(), stats=()):
    """Shapes, dtypes, head dim (one of ``HEAD_DIMS``) and contiguity of q
    (B, Sq, H, D), k / v (B, Sk, KV, D), the tensors ``like_q`` (q's shape
    and dtype) and the f32 row statistics ``stats`` (B, Sq, H); bf16 q, k,
    v and ``like_q`` 16-byte aligned; then one CUDA device."""
    build.local_only(what, q, k, v, *like_q, *stats)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    tensors = (q, k, v, *like_q)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors) \
            or any(t.dtype != torch.float32 for t in stats):
        raise ValueError(f"{what}: dtypes {[t.dtype for t in tensors]}, "
                         f"stats {[t.dtype for t in stats]}; needs all "
                         f"float32 or all bfloat16, stats float32")
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape or h % kvh \
            or any(t.shape != q.shape for t in like_q) \
            or any(t.shape != (b, sq, h) for t in stats):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}, "
                         f"{[tuple(t.shape) for t in (*like_q, *stats)]}")
    if not all(t.is_contiguous() for t in (*tensors, *stats)):
        raise ValueError(f"{what}: inputs must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: bf16 inputs must start at 16-byte "
                         f"aligned addresses (16-byte async copies)")
    if not all(t.is_cuda and t.device == q.device
               for t in (*tensors, *stats)):
        raise ValueError(f"{what}: inputs must be on one CUDA device")


def _launch_fwd(q, k, v, *, causal, window, softcap, q_offset, stats):
    """o, and with ``stats`` the row statistics m, l (else None, None)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    fn = _fwd_kernel()
    o = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 m.data_ptr() if stats else None,
                 l.data_ptr() if stats else None,
                 b, sq, sk, h, kvh, d, _DTYPES[q.dtype], int(bool(causal)),
                 int(window), float(softcap), float(d ** -0.5), int(q_offset),
                 build.stream_ptr(q))
    build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    flash_attention.shapes[(b, sq, sk, h, kvh, d, bool(causal))] += 1
    return o, m, l


class _FlashFunction(torch.autograd.Function):
    """Forward kernel with row statistics; backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset)
        o, m, l = _launch_fwd(q, k, v, stats=True, **opts)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        grads = flash_attention_bwd(*ctx.saved_tensors, do.contiguous(),
                                    **ctx.opts)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, return_stats=False):
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) on one CUDA device, contiguous,
    all float32 or all bfloat16 (bf16: 16-byte aligned) -> (B, Sq, H, D) in
    q's dtype; differentiable in q, k, v. ``return_stats`` (no gradient):
    (o, m, l) with the f32 row statistics m, l of shape (B, Sq, H)."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    _check("flash_attention kernel", q, k, v)
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)
    if grad and return_stats:
        raise ValueError("flash_attention kernel: return_stats is for "
                         "inputs that need no gradient")
    if grad:
        return _FlashFunction.apply(q, k, v, causal, window, softcap,
                                    q_offset)
    o, m, l = _launch_fwd(q, k, v, stats=return_stats, **opts)
    return (o, m, l) if return_stats else o


def flash_attention_bwd(q, k, v, o, m, l, do, *, causal=True, window=0,
                        softcap=0.0, q_offset=0):
    """The backward kernel: (dq, dk, dv) in q's dtype from the forward's
    q, k, v, o, its f32 row statistics m, l (B, Sq, H) and the output
    gradient ``do``; all contiguous on one CUDA device (bf16: 16-byte
    aligned)."""
    _check("flash_attention_bwd kernel", q, k, v, like_q=(o, do),
           stats=(m, l))
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    fn = _bwd_kernel()
    delta = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h,
                 kvh, d, _DTYPES[q.dtype], int(bool(causal)), int(window),
                 float(softcap), float(d ** -0.5), int(q_offset),
                 build.stream_ptr(q))
    build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.shapes[(b, sq, sk, h, kvh, d, bool(causal))] += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention.shapes = collections.Counter()
flash_attention_bwd.shapes = collections.Counter()

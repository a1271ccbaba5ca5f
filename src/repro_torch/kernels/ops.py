"""Public kernel API, dispatched by the device of the tensors:

- CUDA tensors go to the hand-written Hopper kernels
  (``flash_attention.py``, ``rg_lru.py``, ``quantize.py``); if the kernel
  cannot take the input, the wrapper raises. There is no fallback on the
  card.
- CPU tensors go to plain PyTorch with the reference's structure:
  attention is an online softmax over KV chunks (the counterpart of
  ``repro/kernels/ops.py::_flash_chunked_jnp``), so it never holds the
  S x S score matrix; the RG-LRU scan and quantization are ``ref.py``.

Counterpart of ``repro/kernels/ops.py`` for the four kernels the serving
paths run (flash attention forward, the RG-LRU scan, blockwise int8
quantize / dequantize).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import rg_lru as _rg_lru
from repro_torch.kernels import ref

NEG_INF = ref.NEG_INF


# ---------------------------------------------------------------------------
# flash attention


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, chunk=512):
    """q: (B,Sq,H,D); k/v: (B,Sk,KV,D) -> (B,Sq,H,D)."""
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
    return flash_chunked(q, k, v, causal=causal, window=window,
                         softcap=softcap, q_offset=q_offset, chunk=chunk)


def flash_chunked(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0,
                  chunk=512):
    """Online softmax over KV chunks of ``chunk`` keys, f32 statistics and
    accumulator; the plain version of the flash kernel."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(chunk, sk)
    qg = (q.float() * (d ** -0.5)).reshape(b, sq, kvh, g, d)
    qpos = (torch.arange(sq, device=q.device) + q_offset)[:, None]  # (sq,1)

    m = torch.full((b, sq, kvh, g), NEG_INF, device=q.device)
    l = torch.zeros((b, sq, kvh, g), device=q.device)
    acc = torch.zeros((b, sq, kvh, g, d), device=q.device)
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        kpos = torch.arange(c0, c0 + kb.shape[1], device=q.device)[None, :]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = torch.ones((sq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence


def rg_lru(a, gx, h0=None):
    """h_t = a_t * h_{t-1} + gx_t. a/gx: (B,S,D) -> (h, h_last)."""
    if a.is_cuda:
        return _rg_lru.rg_lru(a, gx, h0)
    return ref.rg_lru(a, gx, h0)


# ---------------------------------------------------------------------------
# checkpoint quantization


def quantize_blockwise(x, *, block=2048):
    if x.is_cuda:
        return _quant.quantize_blockwise(x, block=block)
    return ref.quantize_blockwise(x, block)


def dequantize_blockwise(q, scale, *, block=2048, out_dtype=torch.float32):
    if q.is_cuda:
        return _quant.dequantize_blockwise(q, scale, block=block,
                                           out_dtype=out_dtype)
    return ref.dequantize_blockwise(q, scale, block).to(out_dtype)

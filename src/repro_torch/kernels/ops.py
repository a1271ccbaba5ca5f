"""Public kernel API, dispatched by the device of the tensors:

- CUDA tensors go to the hand-written Hopper kernels
  (``flash_attention.py``, ``rg_lru.py``, ``mlstm.py``, ``quantize.py``);
  if the kernel cannot take the input, the wrapper raises. There is no
  fallback on the card.
- CPU tensors go to plain PyTorch with the reference's structure:
  attention is an online softmax over KV chunks (the counterpart of
  ``repro/kernels/ops.py::_flash_chunked_jnp``), so it never holds the
  S x S score matrix; the mLSTM is the chunkwise form ``mlstm_chunked``
  (the counterpart of ``_mlstm_chunked_jnp``); the RG-LRU scan and
  quantization are ``ref.py``.
- An mLSTM call that carries a state (decode) is plain PyTorch on either
  device, as in the reference, which bypasses its kernel there.

Counterpart of ``repro/kernels/ops.py`` for its five kernels (flash
attention forward, the RG-LRU scan, the chunkwise mLSTM forward, blockwise
int8 quantize / dequantize).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm as _mlstm
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
# mLSTM


def mlstm(q, k, v, log_f, log_i, state=None, chunk=128):
    """Chunkwise mLSTM. state: optional (C, n, m) carry (decode path)."""
    if state is None and q.is_cuda:
        return _mlstm.mlstm(q.contiguous(), k.contiguous(), v.contiguous(),
                            log_f.contiguous(), log_i.contiguous(),
                            chunk=chunk)
    s = q.shape[1]
    if s > 1 and s % min(chunk, s) == 0:
        return mlstm_chunked(q, k, v, log_f, log_i, state,
                             chunk=min(chunk, s))
    if state is None:
        return ref.mlstm(q, k, v, log_f, log_i)
    return ref.mlstm(q, k, v, log_f, log_i, *state)


def _cumsum(x):
    """Inclusive prefix sum over the last dim as a Hillis-Steele scan:
    log2(n) rounds of ``x[i] = x[i - k] + x[i]``. The CUDA kernel adds in
    the same order, so both get the same bits; ``torch.cumsum`` has no
    deterministic implementation for floats on CUDA."""
    n, k = x.shape[-1], 1
    while k < n:
        x = torch.cat([x[..., :k], x[..., :-k] + x[..., k:]], dim=-1)
        k *= 2
    return x


def mlstm_chunked(q, k, v, log_f, log_i, state=None, chunk=128):
    """Chunkwise-parallel mLSTM (the kernel's math; the plain version of the
    mLSTM kernel): within a chunk the in-chunk contribution is a masked
    attention-like product, and the (d x d) state carries across chunks in
    a Python loop. f32 throughout; S must be a multiple of ``chunk``.
    Returns (h in q's dtype, (C, n) in q's dtype, m f32)."""
    b, s, h, d = q.shape
    nc = s // chunk
    scale = d ** -0.5

    def chunks(x):                       # (B,S,H,...) -> (B,H,nc,chunk,...)
        x = x.float().transpose(1, 2)
        return x.reshape((b, h, nc, chunk) + x.shape[3:])

    qf, kf, vf = chunks(q), chunks(k) * scale, chunks(v)
    lf, li = chunks(log_f), chunks(log_i)
    if state is None:
        C = torch.zeros((b, h, d, d), device=q.device)
        n = torch.zeros((b, h, d), device=q.device)
        m = torch.full((b, h), NEG_INF, device=q.device)
    else:
        C, n, m = (x.float() for x in state)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()

    hs = []
    for i in range(nc):
        qc, kc, vc = qf[:, :, i], kf[:, :, i], vf[:, :, i]   # (b,h,c,d)
        F = _cumsum(lf[:, :, i])                             # (b,h,c)
        src = li[:, :, i] - F
        run_src = torch.cummax(src, dim=-1).values
        m_t = F + torch.maximum(m[..., None], run_src)

        d_mat = F[..., :, None] + src[..., None, :] - m_t[..., :, None]
        w = torch.exp(torch.where(causal, d_mat, NEG_INF))   # (b,h,c,c)
        ws = w * torch.einsum("bhtd,bhud->bhtu", qc, kc)
        intra_num = torch.einsum("bhtu,bhud->bhtd", ws, vc)
        intra_den = ws.sum(dim=-1)

        carry_coeff = torch.exp(F + m[..., None] - m_t)
        inter_num = torch.einsum("bhtd,bhdk->bhtk", qc, C)
        inter_den = torch.einsum("bhtd,bhd->bht", qc, n)
        num = inter_num * carry_coeff[..., None] + intra_num
        den = inter_den * carry_coeff + intra_den
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])

        m_last = m_t[..., -1]
        f_all = F[..., -1]
        state_coeff = torch.exp(f_all + m - m_last)
        src_coeff = torch.exp(f_all[..., None] + src - m_last[..., None])
        kc_s = kc * src_coeff[..., None]
        C = C * state_coeff[..., None, None] \
            + torch.einsum("bhud,bhuk->bhdk", kc_s, vc)
        n = n * state_coeff[..., None] + kc_s.sum(dim=-2)
        m = m_last
    out = torch.stack(hs, dim=2).reshape(b, h, s, d).transpose(1, 2)
    return out.to(q.dtype), (C.to(q.dtype), n.to(q.dtype), m)


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

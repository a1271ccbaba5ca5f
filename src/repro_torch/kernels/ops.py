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
- DTensors (the SPMD step, ``launch/sharding.py``) go through
  ``local_map``: each argument is redistributed to placements read off the
  active rule set, and every rank runs the same call on its local shards
  (the kernel on the card, the plain version on the CPU, under autograd on
  both). Attention shards q's heads over the model axis when the rule set
  does (k / v follow their heads, repeated to q's when their count does not
  divide the axis), else q's sequence when it divides the axis (context
  parallelism: each rank's block of queries scans the whole k / v, its
  masks at absolute positions ``q_offset``), else only the batch. The
  RG-LRU scan shards batch and width, the mLSTM batch and heads.

Counterpart of ``repro/kernels/ops.py`` for its five kernels (flash
attention forward, the RG-LRU scan, the chunkwise mLSTM forward, blockwise
int8 quantize / dequantize) and for the flash backward of its custom VJP
(``_flash_vjp``): a tensor that needs a gradient goes through an autograd
Function whose forward saves (q, k, v, o, m, l) and whose backward
recomputes the probabilities chunk by chunk (the kernels on the card,
``flash_bwd_chunked`` on the CPU), so training never keeps a chunk's
probabilities for autograd. Likewise the RG-LRU scan, which the reference
differentiates by autodiff of ``_rg_lru_assoc``: its Function saves (a,
the f32 carry, h0) and its backward is a reverse scan (the kernel on the
card, ``ref.rg_lru_bwd`` on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm as _mlstm
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import rg_lru as _rg_lru
from repro_torch.kernels import ref
from repro_torch.launch import sharding

NEG_INF = ref.NEG_INF


def _rules():
    """The active rule set, which a DTensor's placements are read off."""
    rules = sharding.active_rules()
    if rules is None:
        raise RuntimeError("a DTensor reached a kernel outside use_rules: "
                           "its placements come from the active rule set")
    return rules


def shard_map(fn, args, axes, outs, partial_grads=()):
    """``fn`` over the local shards of DTensor ``args`` (None entries pass
    through): arg i redistributed to the placements of logical axes
    ``axes[i]`` at its global shape, and output j placed by ``outs[j]``,
    (logical axes, global shape). ``partial_grads`` names (arg index, mesh
    axis) pairs: an arg replicated over that axis whose ranks each give
    only a part of its gradient (summed by DTensor's ``Partial``)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    rules = _rules()

    def placements(a, shape):
        return tuple(rules.sharding(a, tuple(shape))[1])

    in_pl = [None if x is None else placements(a, x.shape)
             for x, a in zip(args, axes)]
    grad_pl = list(in_pl)
    names = list(rules.sizes)
    for i, axis in partial_grads:
        pl = list(grad_pl[i])
        pl[names.index(axis)] = Partial()
        grad_pl[i] = tuple(pl)
    moved = [None if x is None else x.redistribute(rules.mesh, pl)
             for x, pl in zip(args, in_pl)]
    out_pl = tuple(placements(a, shape) for a, shape in outs)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=rules.mesh)(*moved)


# ---------------------------------------------------------------------------
# flash attention


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0, chunk=512):
    """q: (B,Sq,H,D); k: (B,Sk,KV,D); v: (B,Sk,KV,Dv), Dv <= D ->
    (B,Sq,H,Dv). A v narrower than q / k (MLA's) is zero-padded to D for
    the kernel and the output sliced back (on DTensors, on each rank's
    local tensors)."""
    if sharding.is_dtensor(q):
        return _flash_sharded(q, k, v, causal=causal, window=window,
                              softcap=softcap, q_offset=q_offset, chunk=chunk)
    dv = v.shape[-1]
    if dv < q.shape[-1]:
        v = torch.nn.functional.pad(v, (0, q.shape[-1] - dv))
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset,
                               chunk=chunk)[..., :dv]
    if q.is_cuda:
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, softcap=softcap,
                                   q_offset=q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _PlainFlashFunction.apply(q, k, v, causal, window, softcap,
                                         q_offset, chunk)
    return flash_chunked(q, k, v, causal=causal, window=window,
                         softcap=softcap, q_offset=q_offset, chunk=chunk)


def _flash_sharded(q, k, v, *, q_offset, **opts):
    """The SPMD flash attention over DTensors (plans in the module
    docstring)."""
    rules = _rules()
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    heads = ("batch", None, "heads", None)
    cp = ("batch", "seq", None, None)
    q_axes = kv_axes = ("batch", None, None, None)
    partial = ()
    head_axis = rules.spec(heads, q.shape)[2]
    seq_axis = rules.spec(cp, q.shape)[1]
    if head_axis is not None:
        q_axes = kv_axes = heads
        if rules.spec(heads, k.shape)[2] != head_axis:
            # each rank's q heads need their own group's k / v heads
            g = h // kvh
            k, v = (t[:, :, :, None].expand(b, sk, kvh, g, t.shape[-1])
                    .reshape(b, sk, h, t.shape[-1]) for t in (k, v))
    elif seq_axis is not None and sq > 1:
        # each rank's block of queries; its share of dk / dv is partial
        q_axes = cp
        coord = rules.mesh.get_coordinate()[list(rules.sizes).index(seq_axis)]
        q_offset = q_offset + coord * (sq // rules.sizes[seq_axis])
        partial = ((1, seq_axis), (2, seq_axis))

    def local(ql, kl, vl):
        return (flash_attention(ql, kl, vl, q_offset=q_offset, **opts),)

    return shard_map(local, (q, k, v), (q_axes, kv_axes, kv_axes),
                     [(q_axes, q.shape[:-1] + v.shape[-1:])], partial)[0]


class _PlainFlashFunction(torch.autograd.Function):
    """The CPU counterpart of the reference's ``_flash_vjp``: forward
    ``flash_chunked`` with its row statistics, backward
    ``flash_bwd_chunked``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, chunk):
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset, chunk=chunk)
        o, m, l = flash_chunked(q, k, v, return_stats=True, **opts)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, do):
        grads = flash_bwd_chunked(*ctx.saved_tensors, do, **ctx.opts)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None, None)


def _attn_mask(qpos, kpos, causal, window):
    """(Sq, C) bool: key ``kpos`` visible from query ``qpos``. The chunks
    are cut at Sk, not padded, so every key of a chunk exists."""
    mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def flash_chunked(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0,
                  chunk=512, return_stats=False):
    """Online softmax over KV chunks of ``chunk`` keys, f32 statistics and
    accumulator; the plain version of the flash kernel. With
    ``return_stats`` also the f32 row statistics (B, Sq, H): m, the row max
    of the scaled, soft-capped, masked scores, and l = sum exp(s - m) (the
    reference's ``_flash_chunked_jnp(..., return_stats=True)``)."""
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
        mask = _attn_mask(qpos, kpos, causal, window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(b, sq, h, d).to(q.dtype)
    if return_stats:
        return out, m.reshape(b, sq, h), l.reshape(b, sq, h)
    return out


def flash_bwd_chunked(q, k, v, o, m, l, do, *, causal=True, window=0,
                      softcap=0.0, q_offset=0, chunk=512):
    """The flash backward, chunk for chunk the reference's ``_flash_bwd``:
    per KV chunk recompute p = exp(sc - m) / l, then dv = p^T dO,
    dp = dO v^T, ds = p (dp - D) [(1 - (sc/cap)^2) under softcap] d^-0.5,
    dq += ds k and dk = ds^T q, with D = rowsum(dO o); dk and dv summed over
    each KV head's query group. f32 throughout (o and dO upcast as stored);
    m, l: (B, Sq, H) f32 from ``flash_chunked(..., return_stats=True)`` or
    the forward kernel. Returns (dq, dk, dv) in q's, k's and v's dtypes;
    the plain version of the backward kernel."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(chunk, sk)
    scale = d ** -0.5
    shape = (b, sq, kvh, g)
    qf = q.float().reshape(*shape, d)
    go = do.float().reshape(*shape, d)
    of = o.float().reshape(*shape, d)
    m = m.reshape(shape)
    linv = 1.0 / torch.clamp_min(l.reshape(shape), 1e-30)
    delta = (go * of).sum(dim=-1)
    qpos = (torch.arange(sq, device=q.device) + q_offset)[:, None]

    dq = torch.zeros((*shape, d), device=q.device)
    dks, dvs = [], []
    for c0 in range(0, sk, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        kpos = torch.arange(c0, c0 + kb.shape[1], device=q.device)[None, :]
        s = torch.einsum("bqkgd,bckd->bqkgc", qf * scale, kb)
        sc = torch.tanh(s / softcap) * softcap if softcap else s
        mask = _attn_mask(qpos, kpos, causal, window)
        p = torch.where(mask[None, :, None, None, :],
                        torch.exp(sc - m[..., None]), 0.0) * linv[..., None]
        dvs.append(torch.einsum("bqkgc,bqkgd->bckd", p, go))
        dp = torch.einsum("bqkgd,bckd->bqkgc", go, vb)
        ds = p * (dp - delta[..., None])
        if softcap:
            ds = ds * (1.0 - torch.square(sc / softcap))
        ds = ds * scale
        dq = dq + torch.einsum("bqkgc,bckd->bqkgd", ds, kb)
        dks.append(torch.einsum("bqkgc,bqkgd->bckd", ds, qf))
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence


def rg_lru(a, gx, h0=None):
    """h_t = a_t * h_{t-1} + gx_t. a/gx: (B,S,D) -> (h, h_last);
    differentiable in a, gx and h0."""
    if sharding.is_dtensor(a):
        seq, row = ("batch", None, "ffn"), ("batch", "ffn")
        b, _, d = a.shape
        return shard_map(rg_lru, (a, gx, h0), (seq, seq, row),
                         [(seq, a.shape), (row, (b, d))])
    if a.is_cuda:
        return _rg_lru.rg_lru(a, gx, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, gx, h0)):
        return _PlainRGLRUFunction.apply(a, gx, h0)
    return ref.rg_lru(a, gx, h0)


class _PlainRGLRUFunction(torch.autograd.Function):
    """The CPU counterpart of the kernels' Function: forward ``ref.rg_lru``
    with its f32 carry, backward ``ref.rg_lru_bwd``."""

    @staticmethod
    def forward(ctx, a, gx, h0):
        ctx.set_materialize_grads(False)
        h, h_last, h32 = ref.rg_lru(a, gx, h0, return_carry=True)
        ctx.save_for_backward(a, h32, h0)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        if dh is None and dh_last is None:
            return None, None, None
        a, h32, h0 = ctx.saved_tensors
        grads = ref.rg_lru_bwd(a, h32, dh, dh_last, h0)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


# ---------------------------------------------------------------------------
# mLSTM


def mlstm(q, k, v, log_f, log_i, state=None, chunk=128):
    """Chunkwise mLSTM. state: optional (C, n, m) carry (decode path)."""
    if sharding.is_dtensor(q):
        return _mlstm_sharded(q, k, v, log_f, log_i, state, chunk)
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


def _mlstm_sharded(q, k, v, log_f, log_i, state, chunk):
    """The SPMD mLSTM over DTensors: batch and heads sharded, the state's
    too."""
    b, s, h, d = q.shape
    x4, x3 = ("batch", None, "heads", None), ("batch", None, "heads")
    c_axes, n_axes, m_axes = (("batch", "heads", None, None),
                              ("batch", "heads", None), ("batch", "heads"))
    c, n, m = state if state is not None else (None, None, None)

    def local(ql, kl, vl, fl, il, cl, nl, ml):
        st = None if cl is None else (cl, nl, ml)
        hl, (c2, n2, m2) = mlstm(ql, kl, vl, fl, il, st, chunk)
        # a DTensor's ops read its local tensor as laid out contiguously
        # (the chunked form's output is a permuted view)
        return hl.contiguous(), c2, n2, m2

    hs, c2, n2, m2 = shard_map(
        local, (q, k, v, log_f, log_i, c, n, m),
        (x4, x4, x4, x3, x3, c_axes, n_axes, m_axes),
        [(x4, q.shape), (c_axes, (b, h, d, d)), (n_axes, (b, h, d)),
         (m_axes, (b, h))])
    return hs, (c2, n2, m2)


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

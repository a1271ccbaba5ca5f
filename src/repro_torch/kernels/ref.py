"""Plain PyTorch oracles for the ported kernels. Small, obviously correct, f32.

Counterparts of ``repro/kernels/ref.py``: ``flash_attention`` (naive
full-matrix attention), the RG-LRU scan ``rg_lru`` (sequential, f32 carry)
and its backward ``rg_lru_bwd`` (the reverse scan),
the mLSTM cell ``mlstm`` (sequential, log-space stabilized) and the
blockwise int8 ``quantize_blockwise`` / ``dequantize_blockwise``.
``chip_smoke.py`` holds the CUDA kernels against the plain versions beside
their wrappers on the card; the CPU tests hold these against the JAX
oracles and Pallas kernels.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    q_offset=0):
    """Naive full-matrix attention oracle.

    q: (B, Sq, H, D); k/v: (B, Sk, KV, D). GQA via kv-head repetition.
    ``q_offset``: absolute position of q[0] relative to k[0] (prefill=0).
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        rep = h // kvh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qf = q.float() * (d ** -0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return o.to(q.dtype)


def rg_lru(a, gx, h0=None, return_carry=False):
    """Linear recurrence h_t = a_t * h_{t-1} + gx_t, a loop over t in f32.

    a, gx: (B, S, D) (already gated/scaled inputs); h0: (B, D) or None.
    Returns (h_seq (B,S,D), h_last (B,D)) in a's dtype, and with
    ``return_carry`` the f32 carry (B,S,D) too. Each step rounds the
    product before the add (two torch ops, never a fused multiply-add), as
    the CUDA kernel does, so the two agree bit for bit on the card.
    """
    af, gf = a.float(), gx.float()
    b, s, d = a.shape
    h = (torch.zeros((b, d), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(s):
        h = af[:, t] * h + gf[:, t]
        hs.append(h)
    carry = torch.stack(hs, dim=1)
    if return_carry:
        return carry.to(a.dtype), h.to(a.dtype), carry
    return carry.to(a.dtype), h.to(a.dtype)


def rg_lru_bwd(a, h32, dh, dh_last=None, h0=None):
    """The VJP of ``rg_lru`` by a reverse loop over t in f32.

    a: (B, S, D); h32: the forward's f32 carry (B, S, D); dh: (B, S, D) and
    dh_last: (B, D), the gradients of h and h_last (None: zero); h0: (B, D)
    or None. From g_{S-1} = dh_{S-1} + dh_last, in reverse time order:
    dgx_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0, or 0), then
    g_{t-1} = dh_{t-1} + a_t g_t, each product rounded before the add (as
    the CUDA kernel does), and dh0 = a_0 g_0. Returns (da, dgx, dh0) in a's
    dtype, dh0 None without h0.
    """
    af = a.float()
    b, s, d = a.shape
    zero = torch.zeros((b, d), dtype=torch.float32, device=a.device)
    g_in = zero if dh_last is None else dh_last.float()
    h_init = zero if h0 is None else h0.float()
    das, dgxs = [], []
    for t in range(s - 1, -1, -1):
        g = g_in if dh is None else dh[:, t].float() + g_in
        dgxs.append(g)
        das.append(g * (h32[:, t - 1] if t else h_init))
        g_in = af[:, t] * g
    da = torch.stack(das[::-1], dim=1).to(a.dtype)
    dgx = torch.stack(dgxs[::-1], dim=1).to(a.dtype)
    return da, dgx, None if h0 is None else g_in.to(a.dtype)


def mlstm(q, k, v, log_f, log_i, c0=None, n0=None, m0=None):
    """mLSTM (xLSTM matrix memory) sequential oracle, log-space stabilized.

    q/k/v: (B, S, H, D); log_f/log_i: (B, S, H) log forget/input gates.
    C: (B,H,D,D) matrix state; n: (B,H,D) normalizer; m: (B,H) stabilizer.
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))   [xLSTM eq. 19-27]
    ``(c0, n0, m0)`` is an optional carried state (zeros and -1e30 if not
    given). Returns (h (B,S,H,D) in q's dtype, (C, n) in q's dtype, m f32).
    """
    b, s, h, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    lf, li = log_f.float(), log_i.float()
    scale = d ** -0.5
    dev = q.device
    C = torch.zeros((b, h, d, d), device=dev) if c0 is None else c0.float()
    n = torch.zeros((b, h, d), device=dev) if n0 is None else n0.float()
    m = torch.full((b, h), NEG_INF, device=dev) if m0 is None else m0.float()
    hs = []
    for t in range(s):
        qt, kt, vt = qf[:, t], kf[:, t] * scale, vf[:, t]     # (B,H,D)
        m_new = torch.maximum(lf[:, t] + m, li[:, t])
        fg = torch.exp(lf[:, t] + m - m_new)[..., None]       # (B,H,1)
        ig = torch.exp(li[:, t] - m_new)[..., None]
        C = fg[..., None] * C + ig[..., None] * (kt[..., :, None]
                                                 * vt[..., None, :])
        n = fg * n + ig * kt
        num = torch.einsum("bhdk,bhd->bhk", C, qt)
        den = torch.einsum("bhd,bhd->bh", n, qt).abs()
        den = torch.maximum(den, torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    return (torch.stack(hs, dim=1).to(q.dtype),
            (C.to(q.dtype), n.to(q.dtype), m))


def quantize_blockwise(x, block: int = 2048):
    """Blockwise symmetric int8 quantization. x: flat (N,) with N % block == 0.

    Returns (q int8 (N,), scales f32 (N/block,)). ``scale = max|x| / 127``
    floored at 1e-12; ``q = clip(round_half_even(x / scale), -127, 127)``.
    """
    n = x.shape[0]
    xb = x.float().reshape(n // block, block)
    amax = xb.abs().amax(dim=1)
    # divide by a tensor, not a Python scalar: on CUDA, torch turns division
    # by a scalar into a product with its reciprocal, one ulp off IEEE
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(n), scale


def dequantize_blockwise(q, scale, block: int = 2048):
    n = q.shape[0]
    xb = q.float().reshape(n // block, block) * scale[:, None]
    return xb.reshape(n)

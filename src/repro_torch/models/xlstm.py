"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel kernel) and sLSTM
(scalar memory, inherently sequential -> a loop over the sequence).

Counterpart of ``repro/models/xlstm.py``.

mLSTM block (pre up-projection, proj_factor 2):
  x -> norm -> up (2x: value path v & output gate z)
            -> causal conv4 on value path -> q,k projections
            -> mlstm(q,k,v, log_f, log_i) -> headwise groupnorm
            -> (* silu(z)) -> down-projection
sLSTM block: norm -> fused gates (input + recurrent, per-head block-diagonal
recurrence) -> stabilized scalar cell -> headwise groupnorm -> out proj,
followed by a gated FFN (proj_factor 4/3).

The stateless mLSTM block runs ``kernels.ops.mlstm`` without a state: the
CUDA kernel on the card (with its plain backward), the chunked plain
version on the CPU. The decode path carries a state and is plain PyTorch
on either device, as in the reference. Unlike the reference, whose caches
are immutable arrays, the decode path writes the new state into the cache
tensors it is given. The causal depthwise convolution (``_conv_descs``,
``_causal_conv``) is shared with the RG-LRU block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.launch import sharding
from repro_torch.launch.sharding import is_dtensor, replicate_like
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import P, apply_norm, cfg_dtype, norm_descs


def _conv_descs(dim, width):
    return {"kernel": P((width, dim), (None, "embed"), "fanin"),
            "bias": P((dim,), ("embed",), "zeros")}


def _causal_conv(p, x, state=None):
    """x: (B,S,D). state: (B,W-1,D) trailing inputs from the previous step.
    Returns (y, new_state). The ``width`` shifted products are summed in
    x's dtype in index order, from Python's 0, as the reference does."""
    w = p["kernel"].shape[0]
    if state is None:
        state = replicate_like(torch.zeros((x.shape[0], w - 1, x.shape[2]),
                                           dtype=x.dtype, device=x.device), x)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * p["kernel"][i].to(x.dtype)
            for i in range(w))
    y = y + p["bias"].to(x.dtype)
    new_state = xp[:, -(w - 1):]
    return y, new_state


def _groupnorm_heads(x, eps=1e-6):
    """x: (B,S,H,D) — normalize per head (no learned params here)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# mLSTM block


def mlstm_descs(cfg):
    d = cfg.d_model
    du = int(d * cfg.mlstm_proj_factor)
    h = cfg.num_heads
    return {
        "norm": norm_descs(cfg),
        "w_up_v": P((d, du), ("embed", "ffn"), "fanin"),
        "w_up_z": P((d, du), ("embed", "ffn"), "fanin"),
        "conv": _conv_descs(du, cfg.conv1d_width),
        "wq": P((du, du), ("ffn", "ffn_out"), "fanin"),
        "wk": P((du, du), ("ffn", "ffn_out"), "fanin"),
        "w_if": P((d, 2 * h), ("embed", None), "fanin"),
        "w_down": P((du, d), ("ffn", "embed"), "fanin"),
    }


def _logsigmoid(x):
    """``F.logsigmoid``; on a DTensor, on each rank's block (DTensor has no
    strategy for its backward), in the placements it has, a partial sum
    summed first."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_map(F.logsigmoid, out_placements=(pl,), in_placements=(pl,),
                     device_mesh=x.device_mesh)(
        x.redistribute(x.device_mesh, pl))


def _mlstm_qkv(cfg, p, xn, conv_state=None):
    b, s, _ = xn.shape
    du = p["w_up_v"].shape[1]
    h = cfg.num_heads
    dh = du // h
    v_path = torch.matmul(xn, p["w_up_v"].to(xn.dtype))
    z = torch.matmul(xn, p["w_up_z"].to(xn.dtype))
    c, new_conv = _causal_conv(p["conv"], v_path, conv_state)
    c = F.silu(c)
    q = torch.matmul(c, p["wq"].to(xn.dtype))
    k = torch.matmul(c, p["wk"].to(xn.dtype))
    gates = torch.matmul(xn, p["w_if"].to(xn.dtype))
    log_i = gates[..., :h].float()
    log_f = _logsigmoid(gates[..., h:].float() + 3.0)
    shp = (b, s, h, dh)
    return (q.reshape(shp), k.reshape(shp), v_path.reshape(shp),
            log_f, log_i, z, new_conv)


def _mlstm_out(p, x, hseq, z):
    hseq = _groupnorm_heads(hseq)
    hflat = hseq.reshape(x.shape[0], x.shape[1], -1) * F.silu(z)
    return x + torch.matmul(hflat, p["w_down"].to(x.dtype))


def apply_mlstm_block(cfg, p, x):
    xn = apply_norm(cfg, p["norm"], x)
    q, k, v, log_f, log_i, z, _ = _mlstm_qkv(cfg, p, xn)
    hseq, _ = kops.mlstm(q, k, v, log_f, log_i)
    return _mlstm_out(p, x, hseq, z)


def init_mlstm_cache(cfg, batch, device="cuda"):
    du = int(cfg.d_model * cfg.mlstm_proj_factor)
    h = cfg.num_heads
    dh = du // h
    dt = cfg_dtype(cfg)
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=dt, device=device),
        "n": torch.zeros((batch, h, dh), dtype=dt, device=device),
        "m": torch.full((batch, h), NEG_INF, dtype=torch.float32,
                        device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, du), dtype=dt,
                            device=device),
    }


def decode_mlstm_block(cfg, p, x, cache):
    """x: (B, S, d) from the state in ``cache`` (S = 1 when decoding, the
    prompt when prefilling). Returns (out, cache), the cache updated in
    place."""
    xn = apply_norm(cfg, p["norm"], x)
    q, k, v, log_f, log_i, z, new_conv = _mlstm_qkv(cfg, p, xn, cache["conv"])
    hseq, (C, n, m) = kops.mlstm(q, k, v, log_f, log_i,
                                 state=(cache["C"], cache["n"], cache["m"]))
    out = _mlstm_out(p, x, hseq, z)
    for key, val in (("C", C), ("n", n), ("m", m), ("conv", new_conv)):
        _store(cache[key], val)
    return out, cache


def _store(buf, val):
    """``buf`` set to ``val`` in place through ``sharding.write_slice``:
    on DTensors (a cache placed by ``cache_axes``) each rank copies its
    own block, along a dim that no mesh axis splits where there is one."""
    dim = 0
    if is_dtensor(buf):
        split = {p.dim for p in buf.placements if p.is_shard()}
        dim = next((i for i in range(buf.dim()) if i not in split), 0)
    sharding.write_slice(buf, val, dim, 0)


# ---------------------------------------------------------------------------
# sLSTM block


def slstm_descs(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    df = int(d * cfg.slstm_proj_factor)
    return {
        "norm": norm_descs(cfg),
        "w_in": P((d, 4 * d), ("embed", None), "fanin"),
        "w_rec": P((h, dh, 4 * dh), ("heads", "head_dim", None), "fanin",
                   0.5),
        "w_out": P((d, d), ("embed", "embed_out"), "fanin"),
        "norm2": norm_descs(cfg),
        "w_ff_gate": P((d, df), ("embed", "ffn"), "fanin"),
        "w_ff_up": P((d, df), ("embed", "ffn"), "fanin"),
        "w_ff_down": P((df, d), ("ffn", "embed"), "fanin"),
    }


def _slstm_scan(cfg, p, gates_in, state):
    """gates_in: (B,S,4d) input contribution; sequential over S (a Python
    loop, the reference's ``lax.scan``). state: (c, n, m, h), each
    (B,H,dh) f32, or None for the zero state. Returns (hs (B,S,H,dh) f32,
    final state). Under a rule set (DTensors) the loop runs through
    ``kops.shard_map`` on each rank's block: batch over the data axes and
    heads over the model axis where the rules give that (a head's
    recurrence reads only its own block of ``w_rec``), so each step is
    plain torch on local tensors."""
    b, s, _ = gates_in.shape
    h = cfg.num_heads
    dh = cfg.d_model // h
    gates = gates_in.reshape(b, s, h, 4 * dh)
    if is_dtensor(gates):
        rows, g_axes = ("batch", "heads", None), ("batch", None, "heads", None)
        st = (None,) * 4 if state is None else tuple(state)
        out = kops.shard_map(
            lambda g, w, *st: _slstm_loop(g, w, None if st[0] is None
                                          else st),
            (gates, p["w_rec"]) + st,
            (g_axes, ("heads", None, None)) + (rows,) * 4,
            [(g_axes, (b, s, h, dh))] + [(rows, (b, h, dh))] * 4,
            # each rank's rows give their part of w_rec's gradient
            partial_grads=[(1, a) for a in
                           sharding.batch_mesh_axes(gates.shape)])
        return out[0], tuple(out[1:])
    hs, *state = _slstm_loop(gates, p["w_rec"], state)
    return hs, tuple(state)


def _slstm_loop(gates, w_rec, state):
    """The sLSTM recurrence over gates (B,S,H,4dh) from ``state`` (c, n,
    m, h) or, if None, the zero state: (hs (B,S,H,dh) f32, c, n, m, h)."""
    b, s, h, dh4 = gates.shape
    dh = dh4 // 4
    w_rec = w_rec.float()
    if state is None:
        state = _slstm_zero_state((b, h, dh), gates.device)
    c, n, m, hprev = state
    hs = []
    for t in range(s):
        g_rec = torch.einsum("bhd,hdg->bhg", hprev, w_rec)
        g = gates[:, t].float() + g_rec
        zi, ii, fi, oi = torch.split(g, dh, dim=-1)        # (B,H,dh)
        zt = torch.tanh(zi)
        ot = torch.sigmoid(oi)
        log_i = ii
        log_f = F.logsigmoid(fi + 3.0)
        m_new = torch.maximum(log_f + m, log_i)
        # each gate coefficient once (the reference writes each twice)
        fg = torch.exp(log_f + m - m_new)
        ig = torch.exp(log_i - m_new)
        c = fg * c + ig * zt
        n = fg * n + ig
        hprev = ot * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(hprev)
    return torch.stack(hs, dim=1), c, n, m, hprev


def _slstm_zero_state(shape, device):
    """(c, n, m, h) of ``shape``: four distinct tensors, as the cache
    updates them in place."""
    z = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return (z(), z(), torch.full(shape, NEG_INF, dtype=torch.float32,
                                 device=device), z())


def _slstm_init_state(cfg, batch, device):
    return _slstm_zero_state(
        (batch, cfg.num_heads, cfg.d_model // cfg.num_heads), device)


def _slstm_out(cfg, p, x, hs):
    hs = _groupnorm_heads(hs).reshape(x.shape).to(x.dtype)
    x = x + torch.matmul(hs, p["w_out"].to(x.dtype))
    xn2 = apply_norm(cfg, p["norm2"], x)
    gate = torch.matmul(xn2, p["w_ff_gate"].to(x.dtype))
    up = torch.matmul(xn2, p["w_ff_up"].to(x.dtype))
    return x + torch.matmul(F.silu(gate) * up, p["w_ff_down"].to(x.dtype))


def apply_slstm_block(cfg, p, x):
    xn = apply_norm(cfg, p["norm"], x)
    g_in = torch.matmul(xn, p["w_in"].to(x.dtype))
    hs, _ = _slstm_scan(cfg, p, g_in, None)
    return _slstm_out(cfg, p, x, hs)


def init_slstm_cache(cfg, batch, device="cuda"):
    return {"state": _slstm_init_state(cfg, batch, device)}


def decode_slstm_block(cfg, p, x, cache):
    """As ``decode_mlstm_block``: the state tensors of ``cache`` are
    updated in place."""
    xn = apply_norm(cfg, p["norm"], x)
    g_in = torch.matmul(xn, p["w_in"].to(x.dtype))
    hs, state = _slstm_scan(cfg, p, g_in, cache["state"])
    for buf, val in zip(cache["state"], state):
        _store(buf, val)
    return _slstm_out(cfg, p, x, hs), cache

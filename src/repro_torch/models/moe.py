"""Mixture-of-experts FFN with sorted capacity-based dispatch.

Counterpart of ``repro/models/moe.py``'s dense path (``_apply_moe_dense``),
which the reference also takes when no mesh is active: assignments are
routed in f32, sorted by expert id, ranked within expert, dropped beyond
capacity, gathered into an (E, C, d) buffer, run through a batched expert
MLP (``torch.bmm`` over the expert dim) and combined back weighted by the
router probabilities. All shapes are static (capacity = ceil(T*topk/E *
cf), padded to 8), so dispatch needs no host sync.

The same tokens are dropped in the same order as in the reference:
- top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
  does (a stable descending sort; ``torch.topk`` promises no tie order);
- assignments are ordered by a stable argsort, as ``jnp.argsort`` is.
No step reads a value back to the host.

The combine does not scatter-add (``index_add_`` on CUDA sums in atomic
order, which differs from run to run): the (T*k, d) contributions are
un-sorted by the inverse permutation and summed over each token's k
slots, an order fixed by the shapes. The sum of two terms is commutative,
so at top-1 and top-2 the result equals the reference's scatter-add bit
for bit. The expert-parallel ``shard_map`` path of the reference
(``moe_sharded.py``) is not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import P, activation


def moe_descs(cfg):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    descs = {
        "router": P((d, e), ("embed", "experts_flat"), "fanin"),
        "w_gate": P((e, d, f), ("experts", "embed", "ffn"), "fanin"),
        "w_up": P((e, d, f), ("experts", "embed", "ffn"), "fanin"),
        "w_down": P((e, f, d), ("experts", "ffn", "embed"), "fanin"),
    }
    if cfg.num_shared_experts:
        fs = cfg.d_ff_shared or cfg.d_ff_expert * cfg.num_shared_experts
        descs["shared"] = {
            "w_gate": P((d, fs), ("embed", "ffn"), "fanin"),
            "w_up": P((d, fs), ("embed", "ffn"), "fanin"),
            "w_down": P((fs, d), ("ffn", "embed"), "fanin"),
        }
    return descs


def capacity(cfg, tokens: int) -> int:
    c = math.ceil(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)   # pad to 8 for layout friendliness


def route(cfg, p, xt):
    """xt: (T, d) -> (top-k weights (T, k) f32, normalized; expert ids
    (T, k) int64), from an f32 softmax over the router logits."""
    logits = torch.matmul(xt.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    topw = topw / torch.clamp_min(topw.sum(dim=-1, keepdim=True), 1e-9)
    return topw, topi


def apply_moe(cfg, p, x):
    """x: (B, S, d) -> (B, S, d). Runs in a profiler range named ``moe``, so
    that a trace can tell the FFN's device time from the rest of a layer's
    (``chip_smoke.py`` splits it into the expert products and the
    dispatch); with no profiler on, it records nothing."""
    with torch.profiler.record_function("moe"):
        return _apply_moe(cfg, p, x)


def _apply_moe(cfg, p, x):
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    dt = x.dtype
    xt = x.reshape(t, d)
    topw, topi = route(cfg, p, xt)

    # --- sorted capacity dispatch ---
    cap = capacity(cfg, t)
    flat_e = topi.reshape(-1)                               # (t*k,)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], topw.reshape(-1)[order]
    stok = torch.div(order, k, rounding_mode="floor")       # token of each
    # rank within expert: position - start offset of that expert, found in
    # the sorted ids (the reference's cumsum of a bincount; torch.bincount
    # on CUDA reads the ids' max on the host to size its output)
    starts = torch.searchsorted(se, torch.arange(e, device=x.device))
    rank = torch.arange(t * k, device=x.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)  # overflow: dump row

    xe = x.new_zeros((e * cap + 1, d))
    xe[slot] = xt[stok]
    xe = xe[:-1].view(e, cap, d)

    # --- batched expert MLP ---
    gate = torch.bmm(xe, p["w_gate"].to(dt))
    up = torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(activation(cfg, gate) * up, p["w_down"].to(dt))

    # --- combine, in a fixed order: un-sort, then sum each token's k ---
    ye_flat = torch.cat([ye.reshape(e * cap, d), x.new_zeros((1, d))])
    contrib = ye_flat[slot] * sw[:, None].to(dt) * keep[:, None].to(dt)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=x.device)
    out = contrib[inv].view(t, k, d).sum(dim=1)

    if cfg.num_shared_experts:
        sp = p["shared"]
        g = torch.matmul(xt, sp["w_gate"].to(dt))
        u = torch.matmul(xt, sp["w_up"].to(dt))
        out = out + torch.matmul(activation(cfg, g) * u, sp["w_down"].to(dt))
    return out.reshape(b, s, d)

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
slots in top-k rank order, an order fixed by the shapes. The reference
scatter-adds them (``.at[stok].add``) in expert-sorted order. The sum of
two terms is commutative, so at top-1 and top-2 the result equals the
reference's bit for bit; at top-8 (deepseek-v3-671b) the two orders agree
only within f32 rounding (``tests/test_torch_moe.py::
test_apply_moe_matches_reference``, case "top8": routing ids equal, then
outputs within 1e-5). Under an active rule set whose mesh fits the expert
count, ``apply_moe`` takes the expert-parallel path (``moe_sharded.py``),
as the reference does. Under one that it does not fit (and on a mesh of
one device), the dense dispatch runs on DTensors: it keeps the
reference's global capacity, its routing, sort and gather run on each
rank over every token (``kops.shard_map`` with whole operands: DTensor has
no strategy for the sort, ``searchsorted`` or ``index_put``), the expert
products run on ``xe`` placed by the reference's two ``("experts", None,
None)`` sites, and the combine again over whole operands.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch import sharding
from repro_torch.models import moe_sharded
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
    """x: (B, S, d) -> (B, S, d). Uses the expert-parallel path
    (moe_sharded.py) when a distributed rule set is active and the expert
    count matches the mesh; else the sorted dispatch below. Runs in a
    profiler range named ``moe``, so that a trace can tell the FFN's device
    time from the rest of a layer's (``chip_smoke.py`` splits it into the
    expert products and the dispatch); with no profiler on, it records
    nothing."""
    with torch.profiler.record_function("moe"):
        rules = sharding.active_rules()
        if moe_sharded.sharded_moe_available(cfg, rules):
            return moe_sharded.apply_moe_sharded(cfg, p, x, rules)
        return _apply_moe(cfg, p, x)


def _apply_moe(cfg, p, x):
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    dt = x.dtype
    cap = capacity(cfg, t)
    sharded = sharding.is_dtensor(x)
    if sharded:
        # the sort, searchsorted, gather and index_put over every token
        # (DTensor has no strategy for them): on each rank, in plain torch
        # over the whole (replicated) operands, as GSPMD's result holds them
        xe, slot, sw, keep, order = _whole(
            lambda x, router: _dispatch(cfg, {"router": router},
                                        x.reshape(t, d), cap),
            (x, p["router"]), [(e, cap, d)] + [(t * k,)] * 4)
        xt = x
    else:
        xt = x.reshape(t, d)
        # through a view: the dispatch's gradient (the gather's and the
        # router's parts) reaches xt as one sum, as it reaches x from the
        # sharded branch's shard_map, so a mesh of one device gets the
        # eager gradient bit for bit
        xe, slot, sw, keep, order = _dispatch(cfg, p, xt.view_as(xt), cap)
    xe = sharding.constrain(xe, ("experts", None, None))

    # --- batched expert MLP ---
    gate = torch.bmm(xe, p["w_gate"].to(dt))
    up = torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(activation(cfg, gate) * up, p["w_down"].to(dt))
    ye = sharding.constrain(ye, ("experts", None, None))

    if sharded:
        out, = _whole(lambda *a: (_combine(*a, k).view(b, s, d),),
                      (ye, slot, sw, keep, order), [(b, s, d)])
    else:
        out = _combine(ye, slot, sw, keep, order, k)

    if cfg.num_shared_experts:
        sp = p["shared"]
        g = torch.matmul(xt, sp["w_gate"].to(dt))
        u = torch.matmul(xt, sp["w_up"].to(dt))
        out = out + torch.matmul(activation(cfg, g) * u, sp["w_down"].to(dt))
    if sharded:
        # each rank's rows of the batch, as x holds them
        rules = sharding.active_rules()
        return out.redistribute(rules.mesh, rules.sharding(
            ("batch", None, None), (b, s, d))[1])
    return out.reshape(b, s, d)


def _whole(fn, args, out_shapes):
    """``fn`` on every rank over the whole (replicated) values of DTensor
    ``args``; its outputs of ``out_shapes`` come back replicated. Every
    rank computes the whole gradient, so nothing is summed over ranks."""
    whole = lambda n: (None,) * n
    return kops.shard_map(fn, args, [whole(a.dim()) for a in args],
                          [(whole(len(s)), s) for s in out_shapes])


def _dispatch(cfg, p, xt, cap):
    """Route xt (T, d), sort the assignments by expert, rank them within
    their expert and gather the kept ones into (E, cap, d): (xe, each
    sorted assignment's slot (the dump row E * cap when dropped), its
    weight, whether it is kept, the sort's order)."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    topw, topi = route(cfg, p, xt)

    # --- sorted capacity dispatch ---
    flat_e = topi.reshape(-1)                               # (t*k,)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], topw.reshape(-1)[order]
    stok = torch.div(order, k, rounding_mode="floor")       # token of each
    # rank within expert: position - start offset of that expert, found in
    # the sorted ids (the reference's cumsum of a bincount; torch.bincount
    # on CUDA reads the ids' max on the host to size its output)
    starts = torch.searchsorted(se, torch.arange(e, device=xt.device))
    rank = torch.arange(t * k, device=xt.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)  # overflow: dump row

    xe = xt.new_zeros((e * cap + 1, d))
    xe[slot] = xt[stok]
    return xe[:-1].view(e, cap, d), slot, sw, keep, order


def _combine(ye, slot, sw, keep, order, k):
    """(T, d): the kept rows of ye (E, cap, d) weighted by their
    assignments, in a fixed order: un-sorted, then each token's k summed
    in top-k rank order (no atomics)."""
    e, cap, d = ye.shape
    n = order.shape[0]
    dt = ye.dtype
    ye_flat = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))])
    contrib = ye_flat[slot] * sw[:, None].to(dt) * keep[:, None].to(dt)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=ye.device)
    return contrib[inv].view(n // k, k, d).sum(dim=1)

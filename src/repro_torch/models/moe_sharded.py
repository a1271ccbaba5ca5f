"""Expert-parallel MoE with fixed-capacity all-to-all over
``torch.distributed``.

Counterpart of ``repro/models/moe_sharded.py``, whose ``shard_map`` body
runs here eagerly on each rank, on the rank's block: its batch shard of
x (eager model code runs on local tensors), the router whole, and its
experts' weights. The schedule is the reference's:

GRID mode (E == data * model, e.g. deepseek 256 on a 16x16 pod — expert e
lives wholly on device (e // ncols, e % ncols)):
  1. tokens are batch-sharded over `data` rows, replicated over `model` cols
  2. each col c keeps the assignments routed to experts with
     e % ncols == c (cols partition the assignment set)
  3. bin by destination row (e // ncols), capacity-clip, all_to_all over
     `data` (the only cross-row traffic: cap-padded token payloads)
  4. local expert FFN (weights fully resident), reverse all_to_all
  5. scatter-add weighted outputs locally, all_reduce over `model` to merge
     cols

ROW mode (E == data and d_ff_expert divisible by model, e.g. llama4 16
experts — expert e lives on row e, its f-dim split over `model`):
  same dispatch with dest row = e, no col filter (cols replicate dispatch);
  the expert FFN contracts its f-shard and all_reduces over `model` inside
  the expert; no final all_reduce.

Capacity per (src device, dest bin): ceil(T_loc * k / bins * cf), padded to
8. Overflow drops: assignments are ordered by a stable sort on the
destination, as ``jnp.argsort`` orders them, so the same ones drop. Zeros
flow through the FFN to a zero contribution.

The collectives are ``torch.distributed``'s, outside autograd: this path
computes the forward only. The expert products are ``torch.matmul``, as
the reference's are einsums outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.models.common import activation


def _cap(n_assign: int, bins: int, cf: float) -> int:
    c = math.ceil(n_assign / bins * cf)
    return max(8, ((c + 7) // 8) * 8)


def sharded_moe_available(cfg, rules) -> bool:
    if rules is None or cfg.num_experts == 0:
        return False
    sizes = rules.sizes
    if "data" not in sizes or "model" not in sizes:
        return False
    e = cfg.num_experts
    grid = e == sizes["data"] * sizes["model"]
    row = (not grid) and e == sizes["data"] \
        and cfg.d_ff_expert % sizes["model"] == 0
    return grid or row


def _block(rules, t: torch.Tensor, spec) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: a DTensor is
    redistributed and its local shard taken; a plain tensor holds the whole
    value on every rank and is sliced by the rank's mesh coordinate
    (composite axes major first)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.redistribute(rules.mesh, rules.placements(spec)).to_local()
    coord = dict(zip(rules.sizes, rules.mesh.get_coordinate()))
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else \
            (() if entry is None else (entry,))
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * rules.sizes[a] + coord[a], n * rules.sizes[a]
        if n > 1:
            step = t.shape[dim] // n
            t = t.narrow(dim, idx * step, step)
    return t


def apply_moe_sharded(cfg, p, x, rules):
    """x: (B_l, S, d), this rank's batch block (the rows the batch rule
    gives its data row; the cols of a row hold the same block). ``p``'s
    leaves are DTensors on ``rules.mesh`` or plain tensors whole on every
    rank. Returns this rank's (B_l, S, d) block of the output. Called by
    every rank of the mesh."""
    mesh = rules.mesh
    sizes = rules.sizes
    nrows, ncols = sizes["data"], sizes["model"]
    e = cfg.num_experts
    grid_mode = e == nrows * ncols

    if grid_mode:
        w_spec = (("data", "model"), None, None)
        wd_spec = (("data", "model"), None, None)
    else:
        w_spec = ("data", None, "model")           # experts x d x f-shard
        wd_spec = ("data", "model", None)

    router = _block(rules, p["router"], (None, None))
    wg = _block(rules, p["w_gate"], w_spec)
    wu = _block(rules, p["w_up"], w_spec)
    wd = _block(rules, p["w_down"], wd_spec)
    col = mesh.get_coordinate()[list(sizes).index("model")]
    out = _local_moe(cfg, x, router, wg, wu, wd, grid_mode=grid_mode,
                     nrows=nrows, ncols=ncols, col=col,
                     data_group=mesh.get_group("data"),
                     model_group=mesh.get_group("model"))

    if cfg.num_shared_experts:
        sp = {k: _block(rules, w, (None, None))
              for k, w in p["shared"].items()}
        dt = x.dtype
        g = torch.matmul(x, sp["w_gate"].to(dt))
        u = torch.matmul(x, sp["w_up"].to(dt))
        out = out + torch.matmul(activation(cfg, g) * u, sp["w_down"].to(dt))
    return out


def _local_moe(cfg, xl, router, wg, wu, wd, *, grid_mode, nrows, ncols,
               col, data_group, model_group):
    """The reference's ``local_moe`` on one rank's blocks."""
    from repro_torch.models.moe import route
    b_l, s_l, d = xl.shape
    t = b_l * s_l
    k = cfg.top_k
    dev = xl.device
    xt = xl.reshape(t, d)

    # --- routing (replicated across cols; f32) ---
    topw, topi = route(cfg, {"router": router}, xt)
    flat_e = topi.reshape(-1)
    flat_w = topw.reshape(-1).to(xl.dtype)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)

    bins = nrows
    if grid_mode:
        mine = (flat_e % ncols) == col              # this col's experts
        dest = torch.div(flat_e, ncols, rounding_mode="floor")
        cap = _cap(t * k, nrows * ncols, cfg.capacity_factor)
    else:
        mine = torch.ones_like(flat_e, dtype=torch.bool)
        dest = flat_e                               # dest row == expert id
        cap = _cap(t * k, nrows, cfg.capacity_factor)

    dest = torch.where(mine, dest, bins)            # invalid -> dump bin
    order = torch.argsort(dest, stable=True)
    sdest, stok, sw = dest[order], flat_t[order], flat_w[order]
    starts = torch.searchsorted(sdest, torch.arange(bins + 1, device=dev))
    rank = torch.arange(t * k, device=dev) - starts[sdest]
    keep = (rank < cap) & (sdest < bins)
    slot = torch.where(keep, sdest * cap + rank, bins * cap)

    send = xl.new_zeros((bins * cap + 1, d))
    send[slot] = xt[stok]
    send = send[:-1]
    # slot-aligned metadata stays local (all_to_all keeps slot order)
    meta_tok = torch.full((bins * cap + 1,), -1, dtype=torch.int64,
                          device=dev)
    meta_tok[slot] = torch.where(keep, stok, -1)
    meta_tok = meta_tok[:-1]
    meta_w = xl.new_zeros((bins * cap + 1,))
    meta_w[slot] = torch.where(keep, sw, 0)
    meta_w = meta_w[:-1]

    h = torch.empty_like(send)                      # (bins*cap, d) grouped
    dist.all_to_all_single(h, send, group=data_group)

    # --- expert FFN (weights local: one expert, (1, d, f) / (1, f, d)) ---
    gate = torch.matmul(h, wg[0].to(h.dtype))
    up = torch.matmul(h, wu[0].to(h.dtype))
    y = torch.matmul(activation(cfg, gate) * up, wd[0].to(h.dtype))
    if not grid_mode:
        # f is sharded over model: partial sums -> all_reduce inside expert
        dist.all_reduce(y, group=model_group)

    back = torch.empty_like(y)
    dist.all_to_all_single(back, y, group=data_group)

    contrib = back * meta_w[:, None]
    tok_safe = torch.where(meta_tok >= 0, meta_tok, t)
    out = xl.new_zeros((t + 1, d)).index_add_(0, tok_safe, contrib)[:-1]
    if grid_mode:
        dist.all_reduce(out, group=model_group)     # merge col contributions
    return out.reshape(b_l, s_l, d)

"""Expert-parallel MoE with fixed-capacity all-to-all over
``torch.distributed``.

Counterpart of ``repro/models/moe_sharded.py``, whose ``shard_map`` body
(``_local_moe``) runs here on each rank's blocks: its batch shard of x,
the router whole, and its experts' weights. Under the SPMD step and
sharded serving, x and the params are DTensors and the body runs through
``kops.shard_map`` with the reference's ``in_specs`` / ``out_specs``;
eager callers (``launch/elastic.py``) hand it a rank's local batch block.
The schedule is the reference's:

GRID mode (E == data * model, e.g. deepseek 256 on a 16x16 pod — expert e
lives wholly on device (e // ncols, e % ncols)):
  1. tokens are batch-sharded over `data` rows, replicated over `model` cols
  2. each col c keeps the assignments routed to experts with
     e % ncols == c (cols partition the assignment set)
  3. bin by destination row (e // ncols), capacity-clip, all_to_all over
     `data` (the only cross-row traffic: cap-padded token payloads)
  4. local expert FFN (weights fully resident), reverse all_to_all
  5. combine the weighted outputs locally, sum over `model` to merge cols

ROW mode (E == data and d_ff_expert divisible by model, e.g. llama4 16
experts — expert e lives on row e, its f-dim split over `model`):
  same dispatch with dest row = e, no col filter (cols replicate dispatch);
  the expert FFN contracts its f-shard and sums over `model` inside the
  expert; no final sum.

Capacity per (src device, dest bin): ceil(T_loc * k / bins * cf), padded to
8. Overflow drops: assignments are ordered by a stable sort on the
destination, as ``jnp.argsort`` orders them, so the same ones drop. Zeros
flow through the FFN to a zero contribution. This capacity is not the
dense dispatch's (``moe.py::capacity``, per expert over every token): when
routing is uneven across data rows the two drop different assignments, in
the reference as here.

The combine does not scatter-add (``index_add_`` on CUDA sums in atomic
order): each assignment's slot is un-sorted and each token's k slots are
summed in top-k rank order, as ``moe.py``'s dense combine does.

Autograd differentiates the path: the all-to-all and the sum over
``model`` are autograd Functions whose backward is the true gradient of
the forward (``_AllToAll``, ``_SumOverModel``). The expert products are
``torch.matmul``, as the reference's are einsums outside any Pallas
kernel.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from repro_torch.launch.sharding import batch_mesh_axes, is_dtensor
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
    """x: (B, S, d). A DTensor ``x`` (the SPMD step, sharded serving) runs
    ``_local_moe`` through ``kops.shard_map`` on each rank's blocks, the
    reference's ``in_specs`` / ``out_specs``, and returns the (B, S, d)
    DTensor in x's batch placement; autograd differentiates it. A plain
    ``x`` is this rank's batch block (the rows the batch rule gives its
    data row; the cols of a row hold the same block), ``p``'s leaves
    DTensors on ``rules.mesh`` or plain tensors whole on every rank, and
    the result is this rank's (B_l, S, d) block. Called by every rank of
    the mesh."""
    mesh = rules.mesh
    sizes = rules.sizes
    nrows, ncols = sizes["data"], sizes["model"]
    grid_mode = cfg.num_experts == nrows * ncols

    if grid_mode:
        w_spec = (("data", "model"), None, None)
        wd_spec = (("data", "model"), None, None)
    else:
        w_spec = ("data", None, "model")           # experts x d x f-shard
        wd_spec = ("data", "model", None)
    col = mesh.get_coordinate()[list(sizes).index("model")]
    body = functools.partial(_local_moe, cfg, grid_mode=grid_mode,
                             nrows=nrows, ncols=ncols, col=col,
                             data_group=mesh.get_group("data"),
                             model_group=mesh.get_group("model"))

    if is_dtensor(x):
        out = _sharded_body(cfg, rules, body, p, x,
                            (w_spec, w_spec, wd_spec))
    else:
        router = _block(rules, p["router"], (None, None))
        wg = _block(rules, p["w_gate"], w_spec)
        wu = _block(rules, p["w_up"], w_spec)
        wd = _block(rules, p["w_down"], wd_spec)
        out = body(x, router, wg, wu, wd)

    if cfg.num_shared_experts:
        sp = p["shared"] if is_dtensor(x) else \
            {k: _block(rules, w, (None, None)) for k, w in p["shared"].items()}
        dt = x.dtype
        g = torch.matmul(x, sp["w_gate"].to(dt))
        u = torch.matmul(x, sp["w_up"].to(dt))
        out = out + torch.matmul(activation(cfg, g) * u, sp["w_down"].to(dt))
    return out


def _sharded_body(cfg, rules, body, p, x, w_specs):
    """``body`` over the DTensors' blocks: x by the batch rule, the router
    whole, the experts by the reference's ``w_spec`` / ``wd_spec``, which
    the rule set gives their logical axes in either mode (checked). A
    rank's gradient of x is a part over ``model`` (each col routes its own
    experts, or holds an f-shard), and of the router a part over every
    mesh axis (each rank routes its own rows)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.moe import moe_descs
    descs = moe_descs(cfg)
    names = ("router", "w_gate", "w_up", "w_down")
    axes = [descs[n].axes for n in names]
    for n, a, want in zip(names[1:], axes[1:], w_specs):
        got = rules.spec(a, tuple(p[n].shape))
        if got != want:
            raise ValueError(f"{n}: the rule set places it by {got}, not "
                             f"the expert-parallel layout {want}")
    x_axes = ("batch", None, None)
    # mesh axes besides ``model`` that do not split the batch (a batch
    # smaller than the data axis): their ranks dispatch the same tokens,
    # so each expert gets every token from each of them. Each such copy
    # takes its share of the output's gradient, and of x's.
    split = batch_mesh_axes(x.shape)
    copies = [a for a in rules.sizes if a != "model" and a not in split]
    share = 1.0 / math.prod(rules.sizes[a] for a in copies)

    def local(*args):
        out = body(*args)
        return (out if share == 1.0 else _ScaleGrad.apply(out, share),)

    return kops.shard_map(
        local, (x,) + tuple(p[n] for n in names),
        [x_axes, (None, None)] + axes[1:], [(x_axes, tuple(x.shape))],
        partial_grads=[(0, a) for a in ["model"] + copies]
        + [(1, a) for a in rules.sizes])[0]


class _AllToAll(torch.autograd.Function):
    """The tiled, equal-split ``all_to_all_single`` over ``group``: chunk j
    of the input goes to rank j. Its transpose is the same exchange of the
    gradient's chunks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _SumOverModel(torch.autograd.Function):
    """The sum over ``group`` that every rank then holds whole (the
    reference's ``psum``). Each rank's result feeds the same replicated
    value, so the gradient that reaches a rank is already the whole
    gradient of the sum: the backward hands it on unchanged (a second
    all-reduce would scale it by the group's size)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _local_moe(cfg, xl, router, wg, wu, wd, *, grid_mode, nrows, ncols,
               col, data_group, model_group):
    """The reference's ``local_moe`` on one rank's blocks, differentiable:
    the collectives are autograd Functions. In ROW mode every col routes
    the same tokens whole, so each col's routing takes 1 / ncols of the
    gradient that reaches it (the cols' parts of x's and the router's
    gradient are summed over ``model``)."""
    from repro_torch.models.moe import route
    b_l, s_l, d = xl.shape
    t = b_l * s_l
    k = cfg.top_k
    dev = xl.device
    xt = xl.reshape(t, d)

    # --- routing (replicated across cols; f32) ---
    topw, topi = route(cfg, {"router": router}, xt)
    if not grid_mode and ncols > 1:
        topw = _ScaleGrad.apply(topw, 1.0 / ncols)
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
    sdest, stok = dest[order], flat_t[order]
    starts = torch.searchsorted(sdest, torch.arange(bins + 1, device=dev))
    rank = torch.arange(t * k, device=dev) - starts[sdest]
    keep = (rank < cap) & (sdest < bins)
    slot = torch.where(keep, sdest * cap + rank, bins * cap)

    send = xl.new_zeros((bins * cap + 1, d))
    send[slot] = xt[stok]
    h = _AllToAll.apply(send[:-1], data_group)      # (bins*cap, d) grouped

    # --- expert FFN (weights local: one expert, (1, d, f) / (1, f, d)) ---
    gate = torch.matmul(h, wg[0].to(h.dtype))
    up = torch.matmul(h, wu[0].to(h.dtype))
    y = torch.matmul(activation(cfg, gate) * up, wd[0].to(h.dtype))
    if not grid_mode:
        # f is sharded over model: partial sums -> summed inside expert
        y = _SumOverModel.apply(y, model_group)

    back = _AllToAll.apply(y, data_group)

    # --- combine, in a fixed order: each assignment's slot (the dump row
    # when dropped or another col's), un-sorted, then each token's k
    # slots summed in top-k rank order (no atomics) ---
    aslot = torch.empty_like(slot)
    aslot[order] = slot
    back = torch.cat([back, xl.new_zeros((1, d))])
    out = (back[aslot] * flat_w[:, None]).view(t, k, d).sum(dim=1)
    if grid_mode:
        out = _SumOverModel.apply(out, model_group)  # merge col contributions
    return out.reshape(b_l, s_l, d)

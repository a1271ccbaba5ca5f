"""Logical-axis -> mesh sharding rules (DP / FSDP / TP / EP / SP).

Counterpart of ``repro/launch/sharding.py``, with the same rule table and
the same resolution: every parameter descriptor carries logical axis
names, and ``RuleSet.spec`` resolves them against the mesh with (a)
divisibility checks (a dim only shards if evenly divisible) and (b)
conflict avoidance (one mesh axis at most once per tensor, resolved in dim
order). A spec is a tuple with one entry per tensor dim: a mesh axis name,
a tuple of names for a composite axis, or ``None`` — the entries of the
reference's ``PartitionSpec``.

Where the reference builds a ``NamedSharding``, the port gives DTensor
placements (``RuleSet.placements``): ``Shard(dim)`` on every mesh dim the
spec uses for tensor dim ``dim``, ``Replicate()`` on the others. A
composite axis shards its tensor dim over its mesh dims major first, as
JAX lays out ``("data", "model")``.

Baseline rule table:
  batch        -> (pod, data)   data parallelism (pod = DCN-only axis)
  seq          -> model         sequence-sharded KV caches (decode) / CP
  embed        -> data          FSDP: weights gathered at use
  ffn/vocab    -> model         tensor parallelism (Megatron col/row)
  heads        -> model         head TP when head count divides the axis
  experts      -> (data, model) one expert a device (deepseek) or
                  data          one expert a row (llama4)

Model code runs eagerly, on plain tensors or on DTensors: ``constrain`` is
a no-op unless a rule set is active, and then redistributes only DTensors.
The SPMD train step is the port's eager ``make_train_step`` over a state
and a batch that ``place_tree`` placed as DTensors by the rule set, run
under ``use_rules``: every op goes through DTensor's sharding propagation,
the reference's constraint sites redistribute as its
``with_sharding_constraint`` does, a tensor made inside model or
optimizer code joins the mesh through ``replicate_like``, the kernels run
on each rank's local shards (``kernels/ops.py`` through ``local_map``),
and the optimizer hands back each leaf in its input's placements
(``placed_like``). Sharded serving (``runtime/serve_step.py``) takes params
placed by ``param_axes`` and a cache made by ``full_tree`` with
``cache_axes``, whose sequence dim the model axis splits: a cache write
goes into each rank's own block (``write_slice``), and the step returns
the cache in those placements (``place_tree`` of a placed tree moves
nothing).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import mesh_sizes

# candidates: logical axis -> tuple of options; each option is a tuple of
# mesh axes used jointly for that dim (tried in order until one fits)
DEFAULT_RULES: Dict[Optional[str], Tuple[Tuple[str, ...], ...]] = {
    "batch": (("pod", "data"), ("data",), ("pod",)),
    "seq": (("model",),),
    "embed": (("data",),),
    "embed_out": (("model",),),
    "ffn": (("model",),),
    "ffn_out": (("data",),),
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (),
    "head_dim": (),
    "head_dim2": (),
    "q_lora": (),
    "kv_lora": (),
    "rope_dim": (),
    "experts": (("data", "model"), ("data",), ("model",)),
    "experts_flat": (("model",),),
    "layers": (),
    "enc_dim": (),
    None: (),
}


def is_axes_leaf(x) -> bool:
    """A logical-axes tuple (not a NamedTuple of subtrees)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


class RuleSet:
    """Rules over ``mesh``: a DeviceMesh, or anything with
    ``mesh_dim_names`` and ``shape`` (to plan a mesh without processes)."""

    def __init__(self, mesh, overrides: Optional[dict] = None):
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        self.rules = dict(DEFAULT_RULES)
        if overrides:
            self.rules.update(overrides)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> tuple:
        """Resolve logical axes to a spec with divisibility + conflict
        checks. shape=None skips divisibility (constraints only)."""
        used: set = set()
        out = []
        for i, name in enumerate(logical_axes):
            choice = None
            for option in self.rules.get(name, ()):
                axes = tuple(a for a in option if a in self.sizes)
                if not axes or any(a in used for a in axes):
                    continue
                k = math.prod(self.sizes[a] for a in axes)
                if shape is not None and shape[i] % k != 0:
                    continue
                choice = axes
                break
            if choice:
                used.update(choice)
                out.append(choice if len(choice) > 1 else choice[0])
            else:
                out.append(None)
        return tuple(out)

    def placements(self, spec: Sequence) -> list:
        """DTensor placements of ``spec`` on this mesh, one a mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.sizes)
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else \
                (() if entry is None else (entry,))
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                # a DTensor shards one tensor dim over mesh dims in mesh
                # order only; the rule table's composites are in that order
                raise ValueError(f"composite axis {axes} is not in the "
                                 f"mesh's order {tuple(names)}")
            for j in idx:
                out[j] = Shard(dim)
        return out

    def sharding(self, logical_axes, shape=None):
        """(mesh, placements): the port's ``NamedSharding``."""
        return self.mesh, self.placements(self.spec(logical_axes, shape))

    def tree_shardings(self, axes_tree, shape_tree):
        """axes_tree: logical-axis tuples; shape_tree: the matching tree of
        tensors (or anything with ``shape``). Returns a tree of
        (mesh, placements)."""
        return zip_axes(lambda a, s: self.sharding(a, tuple(s.shape)),
                        axes_tree, shape_tree)


def zip_axes(fn, axes, other):
    """``fn(axes leaf, other's subtree)`` over the axes tree's leaves, in
    its structure (nested dicts, tuples and NamedTuples); module-level
    recursion (``models/common.py::zip_map`` says why)."""
    if is_axes_leaf(axes):
        return fn(axes, other)
    if isinstance(axes, dict):
        return {k: zip_axes(fn, axes[k], other[k]) for k in axes}
    if isinstance(axes, tuple):
        kids = [zip_axes(fn, a, o) for a, o in zip(axes, other)]
        return type(axes)(*kids) if hasattr(axes, "_fields") else tuple(kids)
    raise TypeError(f"not an axes tree node: {type(axes).__name__}")


# ---------------------------------------------------------------------------
# activation constraints from inside model code (contextvar-scoped)

_ACTIVE: contextvars.ContextVar[Optional[RuleSet]] = \
    contextvars.ContextVar("repro_torch_ruleset", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[RuleSet]):
    token = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_rules() -> Optional[RuleSet]:
    return _ACTIVE.get()


def batch_mesh_axes(shape) -> Tuple[str, ...]:
    """The mesh axes over which the active rule set splits dim 0 (the
    batch) of a tensor of ``shape``: their ranks hold other rows, and so
    each gives only its rows' part of a gradient they share."""
    entry = active_rules().spec(("batch",) + (None,) * (len(shape) - 1),
                                tuple(shape))[0]
    return entry if isinstance(entry, tuple) else \
        (() if entry is None else (entry,))


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """``x`` outside a rule set. Inside one, a DTensor is redistributed to
    the resolved placements (divisibility-checked against its global
    shape); a plain tensor is a rank's local value and comes back as it
    is."""
    rules = _ACTIVE.get()
    if rules is None or not is_dtensor(x):
        return x
    _, placements = rules.sharding(logical_axes, tuple(x.shape))
    return x.redistribute(rules.mesh, placements)


# ---------------------------------------------------------------------------
# DTensors of the SPMD step: placing a state and a batch, and the tensors
# model and optimizer code make or hand back


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor's module (no
    DTensor exists before something imported it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def replicated(mesh) -> list:
    """The placements of a tensor whole on every rank of ``mesh``."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def whole(x):
    """A DTensor ``x`` replicated on every rank of its mesh; anything else
    (a plain tensor, None) as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, replicated(x.device_mesh))


def replicate_like(t, ref):
    """``t``, a plain tensor made inside model or optimizer code, as a
    replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor (every
    rank makes the same ``t``); else ``t`` itself."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, ref.device_mesh,
                              replicated(ref.device_mesh), run_check=False)


def batch_like(t, ref):
    """``t`` (B, ...), made inside model code, as a DTensor split over the
    mesh dims that split ``ref``'s batch dim 0 and replicated over the
    others, when ``ref`` is a DTensor; else ``t`` itself."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import Replicate
    return replicate_like(t, ref).redistribute(
        ref.device_mesh, [p if p.is_shard(0) else Replicate()
                          for p in ref.placements])


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements when both are DTensors
    (an update's leaf back in its input leaf's placements); else ``x``."""
    if not is_dtensor(x) or list(x.placements) == list(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def place_tree(rules: RuleSet, axes_tree, tree):
    """Every leaf of ``tree`` as a DTensor on the rule set's mesh with the
    placements of the matching leaf of ``axes_tree`` (scalar and zero-size
    leaves replicated): a train state with ``state_logical_axes``, a batch
    with ``batch_axes`` (the port's ``in_shardings``). A leaf that is a
    DTensor already is redistributed, which leaves one in those placements
    as it is: a serving step's cache by ``cache_axes`` (the reference's
    ``out_shardings``)."""
    from torch.distributed.tensor import distribute_tensor

    def place(axes, leaf):
        placements = (replicated(rules.mesh)
                      if leaf.dim() == 0 or leaf.numel() == 0
                      else rules.sharding(axes, tuple(leaf.shape))[1])
        if is_dtensor(leaf):
            return leaf.redistribute(rules.mesh, placements)
        return distribute_tensor(leaf, rules.mesh, placements)

    return zip_axes(place, axes_tree, tree)


def full_tree(rules: RuleSet, axes_tree, tree, values):
    """DTensors with the shapes and dtypes of ``tree``'s leaves (tensors on
    the ``meta`` device will do), each filled with the number at its place
    in ``values`` (a tree of the same structure), in the placements of
    ``axes_tree``'s leaves, on the mesh's device type: each rank allocates
    only its own block, and nothing is sent (a serving cache by
    ``cache_axes``)."""
    from torch.distributed.tensor import DTensor

    def full(axes, leaf_value):
        leaf, value = leaf_value
        placements = rules.sharding(axes, tuple(leaf.shape))[1]
        _, sizes = local_block(rules.mesh, placements, leaf.shape)
        local = torch.full(sizes, value, dtype=leaf.dtype,
                           device=rules.mesh.device_type)
        return DTensor.from_local(local, rules.mesh, placements,
                                  run_check=False, shape=leaf.shape,
                                  stride=torch.empty(leaf.shape,
                                                     device="meta").stride())

    return zip_axes(full, axes_tree, _pairs(tree, values))


def _pairs(tree, values):
    """The tree of (leaf, value) pairs of two trees of one structure
    (nested dicts and tuples); module-level recursion."""
    if isinstance(tree, dict):
        return {k: _pairs(tree[k], values[k]) for k in tree}
    if isinstance(tree, tuple):
        kids = [_pairs(t, v) for t, v in zip(tree, values)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return (tree, values)


# ---------------------------------------------------------------------------
# a rank's block of a DTensor, and writes into it (serving's caches)


def local_block(mesh, placements, shape) -> Tuple[list, list]:
    """(offsets, sizes): the block of a tensor of global ``shape`` that
    this rank of ``mesh`` holds under ``placements`` (``Shard`` and
    ``Replicate``), split as ``torch.chunk`` splits, mesh dims in order."""
    offsets, sizes = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            d, k = p.dim, mesh.size(i)
            chunk = -(-sizes[d] // k)
            start = min(coord[i] * chunk, sizes[d])
            offsets[d] += start
            sizes[d] = min(chunk, sizes[d] - start)
    return offsets, sizes


def write_slice(dst, src, dim: int, start: int):
    """``dst``'s slice ``start .. start + src.shape[dim]`` along ``dim``
    set to ``src`` (cast to ``dst``'s dtype), in place; returns ``dst``.
    A DTensor ``dst`` keeps its placements: ``src`` is brought to them,
    whole along ``dim``, and each rank copies only the part of the slice
    that falls in its own block of ``dim``, so no rank gathers ``dst`` and
    every other element stays as it was. ``src`` is a DTensor on
    ``dst``'s mesh when ``dst`` is one."""
    n = src.shape[dim]
    if n == 0:
        return dst
    if not is_dtensor(dst):
        dst.narrow(dim, start, n).copy_(src)
        return dst
    from torch.distributed.tensor import Replicate
    src = src.redistribute(dst.device_mesh,
                           [Replicate() if p.is_shard(dim) else p
                            for p in dst.placements])
    offsets, sizes = local_block(dst.device_mesh, dst.placements, dst.shape)
    lo = max(start, offsets[dim])
    hi = min(start + n, offsets[dim] + sizes[dim])
    if lo < hi:
        with torch.no_grad():
            dst.to_local().narrow(dim, lo - offsets[dim], hi - lo).copy_(
                src.to_local().narrow(dim, lo - start, hi - lo))
    return dst


# ---------------------------------------------------------------------------
# cache logical axes (mirrors transformer.init_cache structure)


def cache_axes(cfg, cache) -> Any:
    """Assign logical axes to decode-cache leaves by their role. The cache
    tree is {seg*: {pos*: kind-cache}}; leaves are identified by key path."""
    from repro_torch.checkpoint.serializer import tree_map_with_path
    return tree_map_with_path(
        lambda path, leaf: _cache_leaf_axes(path.split("/"),
                                            len(leaf.shape)), cache)


def _cache_leaf_axes(names, rank: int) -> tuple:
    last = names[-1] if names else ""
    if last in ("k", "v"):              # (L,B,S,KV,HD) attn ring/cross
        return ("layers", "batch", "seq", "kv_heads", "head_dim")[:rank]
    if last == "c_kv":
        return ("layers", "batch", "seq", "kv_lora")[:rank]
    if last == "k_rope":
        return ("layers", "batch", "seq", "rope_dim")[:rank]
    if last == "C":                     # (L,B,H,dk,dv) mlstm state
        return ("layers", "batch", "heads", "head_dim", "head_dim2")[:rank]
    if last == "n":
        return ("layers", "batch", "heads", "head_dim")[:rank]
    if last == "m":
        return ("layers", "batch", "heads")[:rank]
    if last == "conv":                  # (L,B,W-1,du)
        return ("layers", "batch", None, "ffn")[:rank]
    if last == "h":                     # (L,B,width) rglru state
        return ("layers", "batch", "ffn")[:rank]
    if "state" in names:                # slstm tuple (L,B,H,dh)
        return ("layers", "batch", "heads", "head_dim")[:rank]
    return ("layers", "batch") + (None,) * max(rank - 2, 0)


def batch_axes(batch) -> Any:
    """Input batch dict: inputs/labels (B,S); enc_input (B,S,E)."""
    return {k: ("batch",) + (None,) * (len(v.shape) - 1)
            for k, v in batch.items()}

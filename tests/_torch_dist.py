"""Process-group workers for the port's distribution tests.

``spawn(fn, world, tmp_path, *args)`` starts ``world`` CPU processes in one
``gloo`` group over a ``FileStore`` under ``tmp_path`` and runs
``fn(rank, *args)`` in each; workers write what the tests check under
``tmp_path``. This module imports neither JAX nor the reference package:
the spawned processes import it, and only it and the port.
"""
from __future__ import annotations

import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from _torch_buffer import STEADY_PING_S

# a collective that one rank never joins fails the test instead of hanging
GROUP_TIMEOUT = datetime.timedelta(seconds=180)


def spawn(fn, world: int, tmp_path, *args) -> None:
    store = os.path.join(str(tmp_path), "store")
    torch.multiprocessing.spawn(_entry, args=(world, store, fn, args),
                                nprocs=world, join=True)


def _entry(rank, world, store_path, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def _state(arch: str, optimizer: str = ""):
    """(cfg, model, optimizer, state) of reduced ``arch`` drawn from seed 0
    on the CPU; ``optimizer`` overrides the config's."""
    import dataclasses
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.train_step import (init_train_state,
                                                make_optimizer)
    cfg = reduced(get_config(arch))
    if optimizer:
        cfg = dataclasses.replace(cfg, optimizer=optimizer)
    model = build_model(cfg)
    opt = make_optimizer(cfg)
    return cfg, model, opt, init_train_state(cfg, model, opt, 0, "cpu")


# ---------------------------------------------------------------------------
# placements: each rank's shard of every train-state leaf


def placements_worker(rank, out_dir, archs):
    """On a (2, 2) mesh: every state leaf of each reduced arch, holding its
    flat indices, distributed with the rule set's placements; records each
    local shard's offsets and shape (read off its first index) and checks
    that the shard holds the indices of that block."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint.serializer import tree_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import RuleSet, zip_axes
    from repro_torch.runtime.train_step import state_logical_axes
    mesh = make_host_mesh(2, 2, device_type="cpu")
    rules = RuleSet(mesh)
    out = {"coord": list(mesh.get_coordinate()), "archs": {}}
    for arch in archs:
        cfg, model, opt, state = _state(arch)
        axes = state_logical_axes(cfg, model, opt)

        def place(a, leaf):
            idx = torch.arange(leaf.numel()).reshape(leaf.shape)
            _, placements = rules.sharding(a, tuple(leaf.shape))
            return distribute_tensor(idx, mesh, placements)

        leaves = {}
        for name, d in tree_paths(zip_axes(place, axes, state)):
            idx = torch.arange(d.numel()).reshape(d.shape)
            local = d.to_local()
            if local.numel():
                first = int(local.reshape(-1)[0])
                offset = [int(o) for o in
                          np.unravel_index(first, tuple(d.shape))]
            else:
                offset = [0] * d.dim()
            block = idx[tuple(slice(o, o + n)
                              for o, n in zip(offset, local.shape))]
            if not torch.equal(local, block):
                raise AssertionError(f"{arch} {name}: the shard is not a "
                                     f"block of the leaf")
            leaves[name] = {"offset": offset, "shape": list(local.shape)}
        out["archs"][arch] = leaves
    with open(os.path.join(out_dir, f"placements{rank}.json"), "w") as f:
        json.dump(out, f)



# ---------------------------------------------------------------------------
# elastic restore: save on (2, 2), restore onto the degraded (1, 2) mesh


def _digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes."""
    import hashlib
    data = t.detach().contiguous().reshape(-1).view(torch.uint8) \
        .numpy().tobytes() if t.numel() else b""
    return hashlib.sha256(data).hexdigest()


def _check_placed(placed, small_rules, axes_tree, want):
    """Per leaf of a restored state: its mesh, its placements (the rule
    set's; scalar and zero-size leaves replicated) and its whole value's
    digest against ``want[name]``. Returns a summary dict."""
    from torch.distributed.tensor import Replicate
    from repro_torch.checkpoint.serializer import tree_paths
    from repro_torch.launch.sharding import zip_axes
    expect = dict(tree_paths(zip_axes(
        lambda a, leaf: _Held(a), axes_tree, placed)))
    out = {"names": [], "sharded": 0, "bad_values": [],
           "bad_placements": [], "mesh_sizes": set()}
    for path, leaf in tree_paths(placed):
        out["names"].append(path)
        out["mesh_sizes"].add(leaf.device_mesh.size())
        if leaf.dim() == 0 or leaf.numel() == 0:
            placements = [Replicate()] * small_rules.mesh.ndim
        else:
            _, placements = small_rules.sharding(expect[path].axes,
                                                 tuple(leaf.shape))
        if list(leaf.placements) != list(placements):
            out["bad_placements"].append(path)
        out["sharded"] += any(not p.is_replicate() for p in leaf.placements)
        if _digest(leaf.full_tensor()) != want.get(path):
            out["bad_values"].append(path)
    out["mesh_sizes"] = sorted(out["mesh_sizes"])
    return out


class _Held:
    """An axes tuple as one leaf of a tree."""

    def __init__(self, axes):
        self.axes = axes


def elastic_worker(rank, out_dir, cases, ref_case):
    """Each case (arch): the reduced state placed on a (2, 2) mesh, saved
    through the port's manager (each rank its own in-process buffer, from
    the same seed), then restored by ``elastic_restore`` onto
    ``degraded_mesh(4, 2, model_axis=2)`` by ranks 0 and 1; also the
    checkpoint the reference wrote under ``ref_case``'s PFS directory."""
    import shutil
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.checkpoint.bbckpt import BBCheckpointManager
    from repro_torch.core import BBConfig, BurstBufferSystem
    from repro_torch.launch.elastic import degraded_mesh, elastic_restore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import RuleSet, zip_axes
    from repro_torch.models.common import map_tree
    from repro_torch.runtime.train_step import state_logical_axes
    big = make_host_mesh(2, 2, device_type="cpu")
    small = degraded_mesh(4, 2, model_axis=2, device_type="cpu")
    big_rules, small_rules = RuleSet(big), RuleSet(small)
    report = {"small_coord": small.get_coordinate(), "cases": {}}

    def bbcfg(**kw):
        return BBConfig(num_servers=2, num_clients=2,
                        dram_capacity=64 << 20,
                        stabilize_interval=STEADY_PING_S, **kw)

    for arch in cases:
        cfg, model, opt, state = _state(arch)
        axes = state_logical_axes(cfg, model, opt)
        axes = {"params": axes.params, "opt_state": axes.opt_state}
        plain = {"params": state.params, "opt_state": state.opt_state}
        placed_big = zip_axes(
            lambda a, leaf: distribute_tensor(
                leaf, big, big_rules.sharding(a, tuple(leaf.shape))[1]),
            axes, plain)
        # a placed state's checkpoint is the plain state's, byte for byte
        same_bytes = ser.serialize_tree(placed_big) == \
            ser.serialize_tree(plain)
        saved = {name: _digest(leaf) for name, leaf in ser.tree_paths(plain)}
        with BurstBufferSystem(bbcfg()) as bb:
            mgr = BBCheckpointManager(bb, quantize=False)
            mgr.save(3, placed_big, blocking_flush=True)
            case = {"same_bytes": same_bytes,
                    "flushed": bool(mgr.metrics[3].get("flushed"))}
            if small.get_coordinate() is not None:
                target = map_tree(torch.zeros_like, plain)
                placed, step = elastic_restore(mgr, cfg, model, opt, small,
                                               target)
                case.update(step=step, **_check_placed(
                    placed, small_rules, axes, saved))
        report["cases"][arch] = case
        dist.barrier()

    arch, step, pfs_dir, digests = ref_case
    if small.get_coordinate() is not None:
        cfg, model, opt, state = _state(arch)
        axes = state_logical_axes(cfg, model, opt)
        axes = {"params": axes.params, "opt_state": axes.opt_state}
        mine = os.path.join(out_dir, f"pfs{rank}")
        shutil.copytree(pfs_dir, mine)
        with BurstBufferSystem(bbcfg(pfs_dir=mine)) as bb:
            mgr = BBCheckpointManager(bb, quantize=False)
            target = map_tree(torch.zeros_like,
                              {"params": state.params,
                               "opt_state": state.opt_state})
            placed, ck_step = elastic_restore(mgr, cfg, model, opt, small,
                                              target, step=step)
        report["reference"] = dict(
            step=ck_step, **_check_placed(placed, small_rules, axes,
                                          digests))
    dist.barrier()
    with open(os.path.join(out_dir, f"elastic{rank}.json"), "w") as f:
        json.dump(report, f)


# ---------------------------------------------------------------------------
# expert-parallel MoE on a (2, 2) mesh


def moe_cfg(arch: str, num_experts: int, top_k: int, d_ff_expert: int,
            capacity_factor: float):
    """Reduced ``arch`` in f32 with the sharded test's MoE overrides."""
    import dataclasses
    from repro_torch.configs.base import get_config, reduced
    return dataclasses.replace(
        reduced(get_config(arch)), num_experts=num_experts, top_k=top_k,
        d_ff_expert=d_ff_expert, capacity_factor=capacity_factor,
        compute_dtype="float32", param_dtype="float32")


def moe_worker(rank, out_dir, inputs_path, cases):
    """Each case: ``apply_moe`` under the (2, 2) rule set on the rank's
    batch block, with the params whole on every rank and placed by the
    rule set; rank 0 writes the outputs gathered in data-row order, and
    whether the cols of each row agree."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import RuleSet, use_rules, zip_axes
    from repro_torch.models import moe, moe_sharded
    from repro_torch.models.common import map_tree
    mesh = make_host_mesh(2, 2, device_type="cpu")
    rules = RuleSet(mesh)
    world = dist.get_world_size()
    coords = [None] * world
    dist.all_gather_object(coords, tuple(mesh.get_coordinate()))
    data = np.load(inputs_path)
    outs = {}
    for name, spec in cases.items():
        cfg = moe_cfg(**spec)
        if not moe_sharded.sharded_moe_available(cfg, rules):
            raise AssertionError(f"{name}: no sharded path on {rules.sizes}")
        x = torch.from_numpy(data[f"{name}/x"])
        p = _moe_params(data, name)
        # the rank's batch block: its data row's rows of x
        x_spec = rules.spec(("batch", None, None), tuple(x.shape))
        assert x_spec == ("data", None, None), x_spec
        row = mesh.get_coordinate()[0]
        xl = x.chunk(2)[row]
        axes = map_tree(lambda d: d.axes, moe.moe_descs(cfg))
        pd = zip_axes(lambda a, leaf: distribute_tensor(
            leaf, mesh, rules.sharding(a, tuple(leaf.shape))[1]), axes, p)
        for how, params in (("whole", p), ("placed", pd)):
            with use_rules(rules):
                local = moe.apply_moe(cfg, params, xl)
            blocks = [torch.empty_like(local) for _ in range(world)]
            dist.all_gather(blocks, local.contiguous())
            outs[f"{name}/{how}"] = torch.cat(
                [blocks[coords.index((r, 0))] for r in range(2)]).numpy()
            outs[f"{name}/{how}_cols_agree"] = np.array(all(
                torch.equal(blocks[i], blocks[coords.index((c[0], 0))])
                for i, c in enumerate(coords)))
        # gradients of sum(out * w) over DTensors placed by the rule set:
        # twice (bit-identical), then with the sum over ``model``'s
        # backward an all-reduce, which scales a col's part by ncols
        w = torch.from_numpy(data[f"{name}/w"])
        for run in ("", "_again", "_allreduce_bwd"):
            if run == "_allreduce_bwd":
                with _allreduce_backward():
                    grads = _moe_grads(cfg, rules, p, x, w)
            else:
                grads = _moe_grads(cfg, rules, p, x, w)
            outs.update({f"{name}/grad{run}/{k}": v.numpy()
                         for k, v in grads.items()})
    if rank == 0:
        np.savez(os.path.join(out_dir, "moe_port.npz"), **outs)


def _moe_grads(cfg, rules, p, x, w):
    """``apply_moe`` under the rule set over x placed by the batch rule and
    the params by their logical axes: the output and the gradients of
    sum(out * w) (x's, then each param's by its path), gathered whole."""
    from repro_torch.checkpoint.serializer import tree_paths
    from repro_torch.launch.sharding import place_tree, use_rules
    from repro_torch.models import moe
    from repro_torch.models.common import map_tree
    axes = map_tree(lambda d: d.axes, moe.moe_descs(cfg))
    pd = map_tree(lambda t: t.detach().requires_grad_(True),
                  place_tree(rules, axes, p))
    xd = place_tree(rules, ("batch", None, None), x).detach() \
        .requires_grad_(True)
    with use_rules(rules):
        out = moe.apply_moe(cfg, pd, xd)
        (out * place_tree(rules, ("batch", None, None), w)).sum().backward()
    got = {"out": out.full_tensor().detach(), "x": xd.grad.full_tensor()}
    got.update({n: t.grad.full_tensor() for n, t in tree_paths(pd)})
    return got


class _allreduce_backward:
    """Within: ``moe_sharded._SumOverModel``'s backward all-reduces the
    gradient over ``model`` (the fault: every col's part counted ncols
    times)."""

    def __enter__(self):
        from repro_torch.models import moe_sharded
        fn = moe_sharded._SumOverModel
        self.saved = fn.backward

        def backward(ctx, g):
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
            return g, None

        fn.backward = staticmethod(backward)

    def __exit__(self, *exc):
        from repro_torch.models import moe_sharded
        moe_sharded._SumOverModel.backward = self.saved


def _moe_params(data, name):
    prefix = f"{name}/p/"
    p = {}
    for key in data.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = p
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(data[key])
    return p


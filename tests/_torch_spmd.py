"""Process-group workers for ``tests/test_torch_spmd.py``: the port's SPMD
train step over DTensors on CPU ``gloo`` ranks.

The reference writes each case's initial train state through its
serializer; a worker loads it with the port's, places it and the case's
batch with the rule set (``launch/sharding.py::place_tree``) and runs the
port's ``make_train_step`` under ``use_rules``. Workers write what the
tests check under the output directory. This module imports neither JAX nor
the reference package (the spawned processes import it, ``_torch_dist`` and
the port only).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

ARCHS = ("starcoder2-3b", "gemma3-4b", "deepseek-coder-33b",
         "recurrentgemma-9b", "whisper-large-v3")
MESHES = ((2, 2), (4, 1), (1, 4))
# 2 heads on a model axis of 4, which does not divide them, so attention
# takes the context-parallel branch (whisper's cross-attention too)
CP_OVERRIDES = {"gemma3-4b@1x4": {"num_heads": 2, "num_kv_heads": 1},
                "whisper-large-v3@1x4": {"num_heads": 2, "num_kv_heads": 2}}
CP_CASES = tuple(sorted(CP_OVERRIDES))
BATCH, SEQ, ACCUM = 4, 32, 2


def cases(archs=ARCHS, overrides=CP_OVERRIDES, extra=()):
    """[(name, arch, config overrides, mesh shape)]: every config of
    ``archs`` on every mesh, with the ``overrides`` of a case by its name
    (gemma3's and whisper's (1, 4) cases the context-parallel ones), then
    the ``extra`` cases. A test file passes its own configs."""
    out = []
    for arch in archs:
        for shape in MESHES:
            name = f"{arch}@{shape[0]}x{shape[1]}"
            out.append((name, arch, overrides.get(name, {}), shape))
    return out + list(extra)


def tokens(name: str, vocab: int) -> np.ndarray:
    """The case's (B, S + 1) tokens, from a numpy seed of its config."""
    seed = sum(name.split("@")[0].encode())
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, SEQ + 1))


def frames(name: str, encoder_seq: int, encoder_dim: int) -> np.ndarray:
    """The case's (B, encoder_seq, encoder_dim) float64 ``enc_input``
    (whisper's frames), from a numpy seed of its config."""
    seed = sum(name.split("@")[0].encode()) + 1
    return np.random.default_rng(seed).standard_normal(
        (BATCH, encoder_seq, encoder_dim))


def _load_reference(path, timeout=600.0):
    """The reference's initial states, once its subprocess has written
    them (it renames the file into place when whole)."""
    import time
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference states at {path}")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def _build(arch, overrides, ref_state):
    """(cfg, model, optimizer, TrainState) of the reduced config with the
    reference's initial state, loaded through the checkpoint format."""
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.train_step import (TrainState, init_train_state,
                                                make_optimizer)
    cfg = dataclasses.replace(reduced(get_config(arch)), **overrides)
    model, opt = build_model(cfg), make_optimizer(cfg)
    target = init_train_state(cfg, model, opt, 0, "cpu")
    loaded = ser.deserialize_tree({"params": target.params,
                                   "opt_state": target.opt_state},
                                  *ref_state)
    return cfg, model, opt, TrainState(loaded["params"], loaded["opt_state"])


def _batch(name, cfg):
    """The case's batch; with an encoder, its ``enc_input`` in f32 (placed
    by ``batch_axes`` with the tokens)."""
    tok = torch.from_numpy(tokens(name, cfg.vocab_size))
    batch = {"inputs": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    if cfg.encoder_seq:
        batch["enc_input"] = torch.from_numpy(
            frames(name, cfg.encoder_seq, cfg.encoder_dim)).float()
    return batch


def _placement_str(placements) -> list:
    return [str(p) for p in placements]


def _shard_block(d) -> dict:
    """A DTensor leaf's local block: offset and shape in the global leaf,
    read off an index tensor with the same placements."""
    from torch.distributed.tensor import distribute_tensor
    idx = distribute_tensor(torch.arange(d.numel()).reshape(d.shape),
                            d.device_mesh, d.placements).to_local()
    if idx.numel():
        offset = [int(o) for o in
                  np.unravel_index(int(idx.reshape(-1)[0]), tuple(d.shape))]
    else:
        offset = [0] * d.dim()
    return {"offset": offset, "shape": list(idx.shape)}


class _Recorder:
    """Wraps ``sharding.constrain`` and ``ops.flash_attention`` in this
    process: each constraint's logical axes, global shape, resulting
    placements and site (the calling function's name), and each local
    flash call's q length, heads, KV heads and ``q_offset``."""

    def __init__(self):
        import sys
        from repro_torch.kernels import ops
        from repro_torch.launch import sharding
        self.constraints, self.flash = [], []
        constrain, flash = sharding.constrain, ops.flash_attention

        def recorded_constrain(x, logical_axes):
            out = constrain(x, logical_axes)
            if sharding.is_dtensor(out):
                self.constraints.append({
                    "axes": list(logical_axes), "shape": list(out.shape),
                    "placements": _placement_str(out.placements),
                    "site": sys._getframe(1).f_code.co_name})
            return out

        def recorded_flash(q, k, v, **kw):
            if not sharding.is_dtensor(q):
                self.flash.append({"sq": q.shape[1], "h": q.shape[2],
                                   "kv": k.shape[2],
                                   "q_offset": kw.get("q_offset", 0)})
            return flash(q, k, v, **kw)

        sharding.constrain = recorded_constrain
        ops.flash_attention = recorded_flash


def spmd_worker(rank, out_dir, ref_path, case_list):
    """Each case: the reference's initial state and the case's batch placed
    by the rule set on the case's mesh, two SPMD steps; writes rank 0's
    gathered new state, loss and grad norm, whether the two runs agree bit
    for bit, the recorded constraints and flash calls, and every rank's
    local block and placements of each new leaf."""
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (RuleSet, batch_axes, place_tree,
                                             use_rules)
    from repro_torch.runtime.train_step import (make_train_step,
                                                state_logical_axes)
    ref = _load_reference(ref_path)
    rec = _Recorder()
    meshes, report, states = {}, {}, {}
    for name, arch, overrides, shape in case_list:
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = make_host_mesh(*shape, device_type="cpu")
        rules = RuleSet(meshes[shape])
        cfg, model, opt, state = _build(arch, overrides, ref[name]["init"])
        axes = state_logical_axes(cfg, model, opt)
        placed = place_tree(rules, axes, state)
        batch = _batch(name, cfg)
        placed_batch = place_tree(rules, batch_axes(batch), batch)
        step = make_train_step(cfg, model, opt, accum_steps=ACCUM)
        runs = []
        for _ in range(2):
            rec.constraints.clear()
            rec.flash.clear()
            with use_rules(rules):
                new, metrics = step(placed, placed_batch)
            runs.append((new, {k: float(v.full_tensor())
                               for k, v in metrics.items()}))
        (new, metrics), (again, metrics2) = runs
        new_tree = {"params": new.params, "opt_state": new.opt_state}
        leaves = ser.tree_paths(new_tree)
        before = dict(ser.tree_paths({"params": placed.params,
                                      "opt_state": placed.opt_state}))
        same = [torch.equal(a.full_tensor(), b.full_tensor())
                for (_, a), (_, b) in zip(leaves, ser.tree_paths(
                    {"params": again.params, "opt_state": again.opt_state}))]
        report[name] = {
            "metrics": metrics, "metrics_again": metrics2,
            "differ_between_runs": [n for (n, _), s in zip(leaves, same)
                                    if not s],
            "constraints": list(rec.constraints),
            "flash": list(rec.flash),
            "blocks": {n: _shard_block(d) for n, d in leaves},
            "placements": {n: _placement_str(d.placements)
                           for n, d in leaves},
            "placements_before": {n: _placement_str(before[n].placements)
                                  for n, _ in leaves},
            "coord": list(meshes[shape].get_coordinate()),
        }
        states[name] = ser.serialize_tree(new_tree)
    if rank == 0:
        with open(os.path.join(out_dir, "port_states.pkl"), "wb") as f:
            pickle.dump(states, f)
    with open(os.path.join(out_dir, f"spmd{rank}.json"), "w") as f:
        json.dump(report, f)


def ops_worker(rank, out_dir):
    """Each kernel's wrapper over DTensors on a (2, 2) and a (1, 4) mesh
    against its plain version on the whole tensors, forward and the
    gradients of a fixed projection of the outputs: flash attention in its
    heads plan (4 heads over 2 KV: k / v heads sharded on (2, 2), repeated
    to q's on (1, 4); over 1 KV: repeated), its context-parallel plan (3
    heads, 32 tokens) and its batch-only plan (3 heads, 31 tokens); the
    RG-LRU scan; the mLSTM forward. Writes rank 0's largest differences;
    also whether a DTensor handed to a kernel's own wrapper raises."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import RuleSet, replicated, use_rules
    gen = torch.Generator().manual_seed(5)
    rec = _Recorder()

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    out = {}
    for shape in ((2, 2), (1, 4)):
        rules = RuleSet(make_host_mesh(*shape, device_type="cpu"))

        def place(t):
            return distribute_tensor(t, rules.mesh, replicated(rules.mesh))

        def both(fn, *xs):
            """Outputs and input gradients of ``fn``: plain, and over
            replicated DTensors under the rule set (gathered)."""
            plain_in = [x.clone().requires_grad_(True) for x in xs]
            dt_in = [place(x).requires_grad_(True) for x in xs]
            y = fn(*plain_in)
            ys = y if isinstance(y, tuple) else (y,)
            w = [rand(*t.shape) for t in ys]
            g = torch.autograd.grad(sum((t * u).sum() for t, u in
                                        zip(ys, w)), plain_in)
            with use_rules(rules):
                yd = fn(*dt_in)
                yds = yd if isinstance(yd, tuple) else (yd,)
                loss = sum((t * place(u)).sum() for t, u in zip(yds, w))
                gd = torch.autograd.grad(loss, dt_in)
            err = max(float((a.full_tensor() - b).abs().max())
                      for a, b in zip((*yds, *gd), (*ys, *g)))
            return err

        tag = f"{shape[0]}x{shape[1]}"
        b, s, d = 4, 32, 16
        for h, kvh, sq, label in ((4, 2, s, "heads"), (4, 1, s, "heads_mqa"),
                                  (3, 1, s, "context_parallel"),
                                  (3, 1, s - 1, "batch_only")):
            for window in (0, 8):
                q, k, v = rand(b, sq, h, d), rand(b, sq, kvh, d), \
                    rand(b, sq, kvh, d)
                rec.flash.clear()
                out[f"flash/{label}/w{window}/{tag}"] = both(
                    lambda q, k, v: ops.flash_attention(
                        q, k, v, causal=True, window=window), q, k, v)
                # the local calls of the sharded run (the plain run's
                # first): (q length, heads, KV heads, q_offset)
                out[f"plan/{label}/w{window}/{tag}"] = sorted(
                    {(f["sq"], f["h"], f["kv"], f["q_offset"])
                     for f in rec.flash[1:]})
        a = torch.sigmoid(rand(b, s, 16))
        out[f"rg_lru/{tag}"] = both(lambda a, x: ops.rg_lru(a, x),
                                    a, rand(b, s, 16))
        q, k, v = rand(b, s, 4, d), rand(b, s, 4, d), rand(b, s, 4, d)
        lf = torch.nn.functional.logsigmoid(rand(b, s, 4))
        li = rand(b, s, 4)
        with torch.no_grad():
            hp, (cp, n_p, mp) = ops.mlstm(q, k, v, lf, li, chunk=8)
            with use_rules(rules):
                hd, (cd, nd, md) = ops.mlstm(*(place(t) for t in
                                               (q, k, v, lf, li)), chunk=8)
            out[f"mlstm/{tag}"] = max(
                float((x.full_tensor() - y).abs().max())
                for x, y in ((hd, hp), (cd, cp), (nd, n_p), (md, mp)))
        raised = []
        for call in (lambda: fa.flash_attention(place(q), place(k),
                                                place(v)),
                     lambda: ops._rg_lru.rg_lru(place(a), place(a))):
            try:
                call()
                raised.append(None)
            except TypeError as e:
                raised.append(str(e))
        out[f"direct_raises/{tag}"] = raised
    if rank == 0:
        with open(os.path.join(out_dir, "ops.json"), "w") as f:
            json.dump(out, f)


def single_worker(rank, out_dir, ref_path, archs):
    """A world of one on a (1, 1) mesh: for each config, the SPMD step
    over the reference's initial state placed as DTensors and the eager
    step over the same plain tensors; writes the leaves and metrics that
    differ in any bit."""
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (RuleSet, batch_axes, place_tree,
                                             use_rules)
    from repro_torch.runtime.train_step import (make_train_step,
                                                state_logical_axes)
    assert dist.get_world_size() == 1
    ref = _load_reference(ref_path)
    rules = RuleSet(make_host_mesh(1, 1, device_type="cpu"))
    out = {}
    for arch in archs:
        name = f"{arch}@2x2"
        cfg, model, opt, state = _build(arch, {}, ref[name]["init"])
        batch = _batch(name, cfg)
        step = make_train_step(cfg, model, opt, accum_steps=ACCUM)
        eager, em = step(state, batch)
        with use_rules(rules):
            spmd, sm = step(place_tree(rules, state_logical_axes(
                cfg, model, opt), state), place_tree(
                rules, batch_axes(batch), batch))
        differ = [n for (n, a), (_, b) in zip(
            ser.tree_paths({"params": spmd.params,
                            "opt_state": spmd.opt_state}),
            ser.tree_paths({"params": eager.params,
                            "opt_state": eager.opt_state}))
            if not torch.equal(a.full_tensor(), b)]
        differ += [k for k in em
                   if not torch.equal(sm[k].full_tensor(), em[k])]
        out[arch] = differ
    with open(os.path.join(out_dir, "single.json"), "w") as f:
        json.dump(out, f)

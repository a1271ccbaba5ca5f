"""Process-group workers for ``tests/test_torch_spmd_serve.py``: the port's
sharded prefill and decode over DTensors on CPU ``gloo`` ranks.

The reference writes each config's params through its serializer, with its
plain run's greedy tokens; a worker loads the params with the port's,
places them by ``param_axes``, makes the cache placed by ``cache_axes``
(``init_cache(..., rules=)``) and runs ``make_prefill`` / ``make_decode_step``
with the rule set: the prompt, then decode steps teacher-forced on the
reference's tokens. Workers write what the tests check under the output
directory. This module imports neither JAX nor the reference package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from _torch_spmd import (_load_reference, _placement_str, _Recorder,
                         _shard_block)

ARCHS = ("starcoder2-3b", "gemma3-4b", "recurrentgemma-9b",
         "whisper-large-v3")
MESHES = ((2, 2), (4, 1), (1, 4))
# 2 heads on a model axis of 4: attention takes the context-parallel
# branch (sites: the attn kinds' prefill, the cross prefill's
# self-attention, cross-attention's q)
CP_OVERRIDES = {"gemma3-4b@1x4": {"num_heads": 2, "num_kv_heads": 1},
                "whisper-large-v3@1x4": {"num_heads": 2, "num_kv_heads": 2}}
# B prompts of PROMPT tokens (past gemma3's and recurrentgemma's 16-token
# window), GEN teacher-forced decode steps, a cache of MAX_SEQ
BATCH, PROMPT, GEN, MAX_SEQ = 4, 32, 8, 48


def cases(archs=ARCHS, overrides=CP_OVERRIDES):
    """[(name, arch, config overrides, mesh shape)]: every config of
    ``archs`` on every mesh, with the ``overrides`` of a case by its name.
    A test file passes its own configs."""
    out = []
    for arch in archs:
        for shape in MESHES:
            name = f"{arch}@{shape[0]}x{shape[1]}"
            out.append((name, arch, overrides.get(name, {}), shape))
    return out


def config_key(arch, overrides) -> str:
    """The key of a config (arch and overrides): cases on different meshes
    share its params and its plain run."""
    return json.dumps([arch, overrides], sort_keys=True)


def inputs(arch: str, vocab: int, encoder_seq: int, encoder_dim: int):
    """The config's prompts (B, PROMPT) and, with an encoder, its frames
    (B, encoder_seq, encoder_dim) float64, from a numpy seed of the arch."""
    rng = np.random.default_rng(sum(arch.encode()) + 1)
    prompts = rng.integers(0, vocab, (BATCH, PROMPT))
    enc = (rng.standard_normal((BATCH, encoder_seq, encoder_dim))
           if encoder_seq else None)
    return prompts, enc


def _config(arch, overrides):
    from repro_torch.configs.base import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def _params(cfg, model, serialized):
    """The reference's params, loaded through the checkpoint format."""
    from repro_torch.checkpoint import serializer as ser
    target = model.init(0, device="cpu")
    return ser.deserialize_tree({"params": target}, *serialized)["params"]


def _gathered(x):
    from repro_torch.launch import sharding
    return x.full_tensor() if sharding.is_dtensor(x) else x


def serve(cfg, model, params, prompts, enc, forced, rules=None):
    """Prefill over ``prompts``, then one decode step a token of
    ``forced`` (GEN tokens (B, 1), teacher forcing; None: each step's own
    greedy token). Returns (the steps' logits gathered, their greedy tokens,
    the cache, its leaves' placements after the prefill, the leaves whose
    (local) tensor is no longer the storage ``init_cache`` allocated)."""
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.runtime.serve_step import (greedy_token,
                                                make_decode_step,
                                                make_prefill)
    cache = model.init_cache(BATCH, MAX_SEQ, device="cpu", rules=rules)
    storage = {n: _local(d).data_ptr() for n, d in ser.tree_paths(cache)}
    prefill = make_prefill(cfg, model, rules)
    decode = make_decode_step(cfg, model, rules)
    logits_all, toks = [], []
    with torch.no_grad():
        logits, cache = prefill(params, cache, prompts, enc)
        after_prefill = {n: _placement_str(d.placements)
                         for n, d in ser.tree_paths(cache)
                         if rules is not None}
        for i in range(GEN + 1):
            logits_all.append(_gathered(logits))
            toks.append(_gathered(greedy_token(cfg, logits)))
            if i == GEN:
                break
            tok = toks[-1] if forced is None else forced[i]
            logits, cache = decode(params, cache, tok, PROMPT + i)
    moved = [n for n, d in ser.tree_paths(cache)
             if _local(d).data_ptr() != storage[n]]
    return logits_all, toks, cache, after_prefill, moved


def _local(x):
    from repro_torch.launch import sharding
    return x.to_local() if sharding.is_dtensor(x) else x


def serve_worker(rank, out_dir, ref_path, case_list):
    """Each case: the reference's params placed by ``param_axes`` on the
    case's mesh and the case's prompts served twice with the rule set;
    writes rank 0's gathered logits, greedy tokens and final cache, whether
    the two runs agree bit for bit, the recorded constraints and flash
    calls, and every rank's block and placements of each cache leaf (after
    the prefill and after the last decode step), whether its local tensor
    is that block of the whole leaf, and whether it is still the storage
    ``init_cache`` allocated; and rank 0's eager serve of the same params
    and tokens (the port's plain run: its final cache)."""
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (RuleSet, cache_axes, place_tree,
                                             zip_axes)
    from repro_torch.models.registry import build_model
    ref = _load_reference(ref_path)
    rec = _Recorder()
    meshes, report, results = {}, {}, {}
    for name, arch, overrides, shape in case_list:
        shape = tuple(shape)
        if shape not in meshes:
            meshes[shape] = make_host_mesh(*shape, device_type="cpu")
        rules = RuleSet(meshes[shape])
        cfg = _config(arch, overrides)
        model = build_model(cfg)
        init = ref[config_key(arch, overrides)]
        params = place_tree(rules, model.param_axes(),
                            _params(cfg, model, init["params"]))
        prompts, enc = inputs(arch, cfg.vocab_size, cfg.encoder_seq,
                              cfg.encoder_dim)
        prompts = torch.from_numpy(prompts)
        enc = None if enc is None else torch.from_numpy(enc).float()
        forced = [torch.from_numpy(np.asarray(t)) for t in init["tokens"]]
        runs = []
        for _ in range(2):
            rec.constraints.clear()
            rec.flash.clear()
            runs.append(serve(cfg, model, params, prompts, enc, forced,
                              rules))
        (logits, toks, cache, after_prefill, moved), again = runs
        leaves = ser.tree_paths(cache)
        # (a string a leaf: the serializer's paths walk into lists)
        rule_pl = ser.tree_paths(zip_axes(
            lambda a, d: " ".join(_placement_str(
                rules.sharding(a, tuple(d.shape))[1])),
            cache_axes(cfg, cache), cache))
        blocks = {n: _shard_block(d) for n, d in leaves}
        local_is_block = {
            n: bool(torch.equal(d.to_local(), d.full_tensor()[tuple(
                slice(o, o + k) for o, k in zip(blocks[n]["offset"],
                                                blocks[n]["shape"]))]))
            for n, d in leaves}
        report[name] = {
            "differ_between_runs": (
                [i for i, (a, b) in enumerate(zip(logits, again[0]))
                 if not torch.equal(a, b)]
                + [n for (n, a), (_, b) in zip(leaves,
                                              ser.tree_paths(again[2]))
                   if not torch.equal(a.full_tensor(), b.full_tensor())]),
            "constraints": list(rec.constraints),
            "flash": list(rec.flash),
            "blocks": blocks,
            "placements": {n: _placement_str(d.placements)
                           for n, d in leaves},
            "placements_after_prefill": after_prefill,
            "rule_placements": {n: p.split() for n, p in rule_pl},
            "local_is_block": local_is_block,
            "moved": moved,
            "coord": list(meshes[shape].get_coordinate()),
        }
        results[name] = {
            "logits": [t.numpy() for t in logits],
            "tokens": [t.numpy() for t in toks],
            "cache": {n: d.full_tensor().numpy() for n, d in leaves}}
        if rank == 0:
            eager = serve(cfg, model, _params(cfg, model, init["params"]),
                          prompts, enc, forced)
            results[name]["plain_cache"] = {
                n: d.numpy() for n, d in ser.tree_paths(eager[2])}
        dist.barrier()
    if rank == 0:
        with open(os.path.join(out_dir, "port_serve.pkl"), "wb") as f:
            pickle.dump(results, f)
    with open(os.path.join(out_dir, f"serve{rank}.json"), "w") as f:
        json.dump(report, f)


def single_worker(rank, out_dir, archs):
    """A world of one on a (1, 1) mesh: for each config (its own params
    from seed 0), the sharded serve against the eager serve of the same
    plain tensors, each decoding its own greedy tokens; writes the steps,
    tokens and cache leaves that differ in any bit, and the cache leaves
    of either run that left the storage ``init_cache`` allocated."""
    from repro_torch.checkpoint import serializer as ser
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import RuleSet, place_tree
    from repro_torch.models.registry import build_model
    assert dist.get_world_size() == 1
    rules = RuleSet(make_host_mesh(1, 1, device_type="cpu"))
    out = {}
    for arch in archs:
        cfg = _config(arch, {})
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        prompts, enc = inputs(arch, cfg.vocab_size, cfg.encoder_seq,
                              cfg.encoder_dim)
        prompts = torch.from_numpy(prompts)
        enc = None if enc is None else torch.from_numpy(enc).float()
        eager = serve(cfg, model, params, prompts, enc, None)
        placed = place_tree(rules, model.param_axes(), params)
        spmd = serve(cfg, model, placed, prompts, enc, None, rules)
        differ = [f"logits{i}" for i, (a, b) in
                  enumerate(zip(spmd[0], eager[0])) if not torch.equal(a, b)]
        differ += [f"tokens{i}" for i, (a, b) in
                   enumerate(zip(spmd[1], eager[1])) if not torch.equal(a, b)]
        differ += [n for (n, a), (_, b) in zip(ser.tree_paths(spmd[2]),
                                               ser.tree_paths(eager[2]))
                   if not torch.equal(a.full_tensor(), b)]
        out[arch] = {"differ": differ, "moved": spmd[4] + eager[4]}
    with open(os.path.join(out_dir, "single.json"), "w") as f:
        json.dump(out, f)

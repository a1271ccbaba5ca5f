"""The checks of ``tests/test_torch_spmd_serve_kinds.py`` and
``tests/test_torch_spmd_serve_kinds_mla.py``: the port's sharded serving
over DTensors for the xLSTM, MLA and MoE kinds, against the reference's
jitted sharded prefill and decode, on 4 CPU ``gloo`` ranks and 4 forced
host devices. A test file imports the ``runs`` fixture and the tests from
here, sets ``ARCHS`` and ``CASES`` and parametrizes them with
``parametrize``. This module imports the reference package, so only the
pytest process imports it (the spawned ranks run ``_torch_spmd_serve``'s
workers).

The reference's subprocesses and the port's workers are those of
``tests/test_torch_spmd_serve.py`` (its docstring sets out the wiring and
the traffic: B = 4 prompts of 32 tokens, 8 decode steps teacher-forced on
the reference's plain greedy tokens, a 48-token cache) on the (2, 2),
(4, 1) and (1, 4) meshes.

(a) The prefill's and every decode step's logits, and every leaf of the
    final cache, within the bound of ``test_torch_spmd_serve.py`` of the
    reference's sharded run; where the reference runs ``moe_sharded`` (the
    MoE configs), without its sharded-vs-plain term for what follows an
    MoE FFN (the logits, and the cache of every layer after the first
    with an MoE FFN): max(1e-5, 2 x the noise probe). The reference's own
    sharded run departs from its plain run there by design
    (``test_reference_sharded_moe_capacity_departs``), so that term would
    hold nothing. The caches of the layers before it keep the term, as in
    ``test_torch_spmd_serve.py``, and take twice the port's eager run's
    difference from the reference's plain run beside it: llama4's first
    layer's K cache, rotated at positions up to 39, differs from the
    reference's by up to 1.24e-5 in the eager run already (an f32
    rotation of values near 7), over the noise probe's 1.14e-5, while
    the reference's sharded and plain runs agree there. Each case records
    its worst error as a fraction of its tolerance (``worst_fraction`` in
    the JUnit XML).
(b) The greedy tokens equal wherever the reference's top-2 gap exceeds
    that tolerance.
(c) Every rank's block of every cache leaf against the reference's
    ``devices_indices_map``, its local tensor that block of the whole
    leaf, its placements the rule set's after the prefill and the last
    decode step, its storage the one ``init_cache`` allocated.
(d) On a world of one ((1, 1) mesh), the sharded serve equals the eager
    serve bit for bit.
(e) Two runs on the same mesh are bit-identical."""

import json
import os
import pickle
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

import _torch_dist
import _torch_spmd_serve as harness
import test_torch_spmd_serve as base
from test_torch_spmd import _RefMesh
from repro.launch import sharding as jsharding
from repro.models import moe_sharded as jmoe_sharded

FLOOR = base.FLOOR


def takes_moe_sharded(case) -> bool:
    """Whether the reference's serving runs ``moe_sharded`` in this case."""
    import dataclasses
    from repro.configs.base import get_config, reduced
    cfg = dataclasses.replace(reduced(get_config(case[1])), **case[2])
    return jmoe_sharded.sharded_moe_available(
        cfg, jsharding.RuleSet(_RefMesh(case[3])))


def parametrize(metafunc, cases, archs):
    """A test file's ``pytest_generate_tests``: its cases' names and its
    configs."""
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", [c[0] for c in cases])
    if "arch" in metafunc.fixturenames:
        metafunc.parametrize("arch", archs)


def _case(request, name):
    return {c[0]: c for c in request.module.CASES}[name]


def _spec(tmp, init_path, wait_path, cases, all_cases):
    """The reference's inputs for ``cases``, written to a JSON file (every
    config of ``all_cases`` is in it)."""
    configs, prompts, enc = {}, {}, {}
    for _, arch, overrides, _ in all_cases:
        key = harness.config_key(arch, overrides)
        cfg = harness._config(arch, overrides)
        p, _ = harness.inputs(arch, cfg.vocab_size, cfg.encoder_seq,
                              cfg.encoder_dim)
        configs[key] = [arch, overrides]
        prompts[key] = p.tolist()
        enc[key] = None
    spec = {"cases": [list(c[:3]) + [list(c[3])] for c in cases],
            "configs": configs, "prompts": prompts, "enc": enc,
            "batch": harness.BATCH, "prompt": harness.PROMPT,
            "gen": harness.GEN, "max_seq": harness.MAX_SEQ,
            "noise_eps": base.NOISE_EPS, "noise_runs": base.NOISE_RUNS,
            "init_path": str(init_path), "wait_path": str(wait_path)}
    path = tmp / f"spec{len(list(tmp.glob('spec*')))}.json"
    path.write_text(json.dumps(spec))
    return path


def _env():
    return dict(os.environ, PYTHONPATH=base.SRC, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")


def _reference(tmp, out_path, cases, all_cases, init, first):
    spec = _spec(tmp, init if first else "", init, cases, all_cases)
    with open(f"{out_path}.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c",
                                 textwrap.dedent(base._REF), str(out_path),
                                 str(spec)],
                                env=_env(), stdout=log,
                                stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The reference's results, then at once: the port's sharded serving
    on 4 ranks (two worlds, half the test file's cases each) and a world
    of one."""
    cases, archs = request.module.CASES, request.module.ARCHS
    tmp = tmp_path_factory.mktemp("spmd_serve_kinds")
    init = tmp / "reference_init.pkl"
    procs = [_reference(tmp, tmp / f"reference{i}.pkl", cases[i::2], cases,
                        init, i == 0) for i in (0, 1)]
    dirs = {k: tmp / k for k in ("even", "odd", "single")}
    for d in dirs.values():
        d.mkdir()
    jobs = [(harness.serve_worker, 4, dirs["even"], str(init), cases[0::2]),
            (harness.serve_worker, 4, dirs["odd"], str(init), cases[1::2]),
            (harness.single_worker, 1, dirs["single"], archs)]
    failures = []

    def side(job):
        try:
            fn, world, where, *args = job
            _torch_dist.spawn(fn, world, where, str(where), *args)
        except Exception as e:          # raised by the main thread
            failures.append(e)

    threads = [threading.Thread(target=side, args=(job,))
               for job in jobs[1:]]
    for t in threads:
        t.start()
    try:
        side(jobs[0])
    finally:
        for t in threads:
            t.join()
        for p in procs:
            p.wait(timeout=900)
    for i, p in enumerate(procs):
        assert p.returncode == 0, \
            (tmp / f"reference{i}.pkl.log").read_text()[-3000:]
    if failures:
        raise failures[0]
    ref = {}
    for i in (0, 1):
        with open(tmp / f"reference{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    ranks = [{} for _ in range(4)]
    port = {}
    for d in (dirs["even"], dirs["odd"]):
        for r in range(4):
            ranks[r].update(json.loads((d / f"serve{r}.json").read_text()))
        with open(d / "port_serve.pkl", "rb") as f:
            port.update(pickle.load(f))
    return {"ref": ref, "ranks": ranks, "port": port,
            "single": json.loads((dirs["single"] / "single.json")
                                 .read_text())}


def _tolerance(case, sharded, plain, noise, leaf=None, port_plain=None):
    """``test_torch_spmd_serve.py``'s bound; where the reference runs
    ``moe_sharded``, without the sharded-vs-plain term for the logits and
    the cache leaves that an MoE layer runs before, and for the other
    cache leaves with the two packages' plain difference beside it (twice
    the port's eager run's difference from the reference's plain run)."""
    if not takes_moe_sharded(case):
        return base._tolerance(sharded, plain, noise)
    if not _before_any_moe(case, leaf):
        return max(FLOOR, 2 * noise)
    return max(base._tolerance(sharded, plain, noise),
               2 * float(np.abs(port_plain - plain).max()))


def _before_any_moe(case, leaf) -> bool:
    """Whether cache leaf ``leaf`` ("seg<i>/<j>/...") belongs to a layer
    whose input no MoE FFN has touched: a layer at or before the first
    one with an MoE FFN (its attention runs before its FFN), in a segment
    of one repeat. The logits (``leaf`` None) come after every layer."""
    if leaf is None:
        return False
    segments = harness._config(case[1], case[2]).segments
    seg, pos = leaf.split("/")[:2]
    i, j = int(seg[len("seg"):]), int(pos)
    kinds = [k for unit, reps in segments[:i] for k in unit * reps]
    unit, reps = segments[i]
    return reps == 1 and not any("moe" in k for k in kinds + list(unit[:j]))


def test_sharded_serve_matches_reference(runs, name, request,
                                         record_property):
    """(a)"""
    case = _case(request, name)
    ref, port = runs["ref"][name], runs["port"][name]
    bad, worst = [], []
    for i, (got, want, plain, noise) in enumerate(zip(
            port["logits"], ref["logits"], ref["plain_logits"],
            ref["noise"]["logits"])):
        err = float(np.abs(got - want).max())
        tol = _tolerance(case, want, plain, noise)
        worst.append((err / tol, f"logits of step {i}"))
        if err > tol:
            bad.append((f"logits of step {i}", err, tol))
    assert len(port["logits"]) == harness.GEN + 1
    assert sorted(port["cache"]) == sorted(ref["cache"])
    for leaf, got in port["cache"].items():
        want, plain = ref["cache"][leaf], ref["plain_cache"][leaf]
        err = float(np.abs(got - want).max())
        tol = _tolerance(case, want, plain, ref["noise"]["cache"][leaf],
                         leaf, port["plain_cache"][leaf])
        worst.append((err / tol, leaf))
        if err > tol:
            bad.append((leaf, err, tol))
    record_property("worst_fraction", json.dumps(max(worst)))
    assert not bad, bad


def test_greedy_tokens_match_where_the_gap_is_clear(runs, name, request):
    """(b)"""
    case = _case(request, name)
    ref, port = runs["ref"][name], runs["port"][name]
    clear = 0
    for got, want, gap, logits, plain, noise in zip(
            port["tokens"], ref["tokens"], ref["gaps"], ref["logits"],
            ref["plain_logits"], ref["noise"]["logits"]):
        sure = gap > _tolerance(case, logits, plain, noise)
        assert np.array_equal(got[sure], want[sure])
        clear += int(sure.sum())
    assert clear > harness.BATCH * (harness.GEN + 1) // 2


def test_cache_blocks_match_reference_devices_indices_map(runs, name):
    """(c)"""
    want = runs["ref"][name]["indices"]
    coords = set()
    for r in runs["ranks"]:
        got = r[name]
        key = ",".join(map(str, got["coord"]))
        coords.add(key)
        assert sorted(got["blocks"]) == sorted(want)
        for leaf, block in got["blocks"].items():
            assert block == want[leaf][key], (leaf, key)
        assert got["placements"] == got["rule_placements"]
        assert got["placements_after_prefill"] == got["rule_placements"]
        assert all(got["local_is_block"].values())
        assert got["moved"] == []
    assert len(coords) == 4
    assert any(len({json.dumps(b) for b in per.values()}) > 1
               for per in want.values())


def test_world_of_one_equals_the_eager_serve(runs, arch):
    """(d)"""
    assert runs["single"][arch] == {"differ": [], "moved": []}


def test_two_runs_are_bit_identical(runs, name):
    """(e)"""
    for r in runs["ranks"]:
        assert r[name]["differ_between_runs"] == []


_CAPACITY = """
    import dataclasses, json, sys
    import jax, numpy as np
    from jax.sharding import AxisType
    from repro.configs.base import get_config, reduced
    from repro.launch.sharding import (RuleSet, batch_axes, cache_axes,
                                       use_rules)
    from repro.models import moe_sharded
    from repro.models.registry import build_model

    spec = json.loads(sys.argv[1])
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = RuleSet(mesh)
    tokens = {"tokens": np.asarray(spec["prompts"], np.int32)}

    def prefill(cfg, sharded):
        # the last position's logits of the prefill, plain or jitted with
        # dryrun.py's shardings under the rules (a function of its own
        # each call: jit's trace cache does not see the rule set)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        cache = model.init_cache(spec["batch"], spec["max_seq"])

        def fn(params, cache, specs):
            return model.prefill(params, cache, specs["tokens"])[0]

        if not sharded:
            return np.asarray(jax.jit(fn)(params, cache, tokens))
        with use_rules(rules):
            p_sh = rules.tree_shardings(model.param_axes(), params)
            c_sh = rules.tree_shardings(cache_axes(cfg, cache), cache)
            t_sh = rules.tree_shardings(batch_axes(tokens), tokens)
            return np.asarray(jax.jit(fn, in_shardings=(p_sh, c_sh, t_sh))(
                params, cache, tokens))

    cfg = reduced(get_config("deepseek-v3-671b"))
    out = {}
    for tag, c in (("as_configured", cfg), ("no_drops", dataclasses.replace(
            cfg, capacity_factor=spec["no_drop_cf"]))):
        out[tag] = float(np.abs(prefill(c, True) - prefill(c, False)).max())
    moe_sharded.sharded_moe_available = lambda cfg, rules: False
    out["sharded_moe_off"] = float(np.abs(prefill(cfg, True)
                                          - prefill(cfg, False)).max())
    print(json.dumps(out))
"""


def test_reference_sharded_moe_capacity_departs():
    """The reference alone, reduced deepseek-v3-671b on a (2, 2) mesh,
    with routing uneven across the data rows: this file's prompts, those of
    data row 0 (prompts 0 and 1) one token repeated. Its sharded prefill's
    logits depart from its plain prefill's; with ``moe_sharded`` off, or
    at a capacity factor at which neither capacity drops an assignment,
    they agree within 1e-5. So the departure is the expert-parallel
    path's capacity: per (source device, destination bin), ``_cap(T_loc *
    k, bins, cf)``, where the dense path caps each expert over every token
    (``moe.capacity``), and the two drop different assignments. (With
    this file's prompts as drawn, nothing drops in either and the two
    agree within 1e-5.) The port follows the reference's sharded run."""
    from repro.configs.base import get_config, reduced
    cfg = reduced(get_config("deepseek-v3-671b"))
    prompts, _ = harness.inputs(cfg.name.replace("-reduced", ""),
                                cfg.vocab_size, 0, 0)
    prompts[:2] = 5
    # per (source, bin): T_loc * k = 2 rows x 32 tokens x top-2 over 4
    # bins; the dense path: 4 x 32 x 2 over 4 experts; at 8 both hold all
    no_drop = 8.0
    assert jmoe_sharded._cap(64 * cfg.top_k, 4, no_drop) >= 64 * cfg.top_k
    spec = json.dumps({"prompts": prompts.tolist(),
                       "batch": harness.BATCH, "max_seq": harness.MAX_SEQ,
                       "no_drop_cf": no_drop})
    done = subprocess.run([sys.executable, "-c", textwrap.dedent(_CAPACITY),
                           spec], env=_env(), capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    diff = json.loads(done.stdout.strip().splitlines()[-1])
    assert diff["as_configured"] > 1e-2, diff
    assert diff["sharded_moe_off"] < 1e-5, diff
    assert diff["no_drops"] < 1e-5, diff

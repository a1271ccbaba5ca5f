"""The checks of ``tests/test_torch_spmd_kinds.py``,
``tests/test_torch_spmd_kinds_moe.py``, ``tests/test_torch_spmd_kinds_row.py``,
``tests/test_torch_spmd_kinds_mla.py`` and
``tests/test_torch_spmd_kinds_dense.py``: the port's SPMD train step over
DTensors for the xLSTM, MLA and MoE kinds and the MTP module, against the
reference's jitted sharded step, on 4 CPU ``gloo`` ranks and 4 forced host
devices. A test file imports the ``runs`` fixture and the tests from here,
sets ``ARCHS`` and ``CASES`` and parametrizes them with ``parametrize``.
This module imports the reference package, so only the pytest process
imports it (the spawned ranks run ``_torch_spmd``'s workers).

The reference's subprocesses and the port's workers are those of
``tests/test_torch_spmd.py`` (its docstring sets out the wiring). Batch
4 x 32, accumulation 2; meshes (2, 2), (4, 1) and (1, 4).

(a) The loss to rtol 1e-5. The grad norm and every state leaf within the
    larger of max(1e-5, 2 x the reference's own sharded-vs-plain
    difference) and twice the reference's own rounding noise, as in
    ``test_torch_spmd.py``; where the reference's step takes
    ``moe_sharded`` (every MoE case but the dense-dispatch one), without
    the sharded-vs-plain term: its per-(source, bin) capacity drops other
    assignments than the plain step's global capacity, so that term
    would hold nothing. Without that term a leaf kept in bfloat16 (the
    Adafactor momentum) is held to at least one bfloat16 step at its
    largest magnitude, the finest difference the dtype can show (the
    term it replaces covered that step in ``test_torch_spmd.py``'s
    deepseek-coder-33b). Each case records its worst error as a fraction
    of its tolerance (``worst_fraction`` in the JUnit XML).
(b) Every rank's block of every new leaf against the reference's
    ``devices_indices_map``, placements kept through the step.
(c) The placements at each constraint site against the reference's
    ``RuleSet.spec``; the sites recorded are the train path's, the MTP
    module's (``forward_with_mtp``) on the deepseek-v3 cases, and moe's
    two expert sites (``_apply_moe``) on the dense-dispatch case only.
(d) On a world of one ((1, 1) mesh), the SPMD step equals the eager step
    bit for bit (the MoE configs take the dense dispatch there).
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
import _torch_spmd
import test_torch_spmd as base
from repro.launch import sharding as jsharding
from repro.models import moe_sharded as jmoe_sharded
from repro_torch.launch.sharding import RuleSet

LOSS_RTOL, FLOOR = base.LOSS_RTOL, base.FLOOR
# the train path's sites (test_torch_spmd.SITES without context
# parallelism and enc_input)
SITES = {(None, "batch", None), ("batch", None), ("batch", None, None)}
EXPERTS = ("experts", None, None)


def _config(case):
    import dataclasses
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import reduced as jreduced
    _, arch, overrides, _ = case
    return dataclasses.replace(jreduced(jget_config(arch)), **overrides)


def takes_moe_sharded(case) -> bool:
    """Whether the reference's step runs ``moe_sharded`` in this case."""
    return jmoe_sharded.sharded_moe_available(
        _config(case), jsharding.RuleSet(base._RefMesh(case[3])))


def parametrize(metafunc, cases, archs):
    """A test file's ``pytest_generate_tests``: its cases' names and its
    configs."""
    if "name" in metafunc.fixturenames:
        metafunc.parametrize("name", [c[0] for c in cases])
    if "arch" in metafunc.fixturenames:
        metafunc.parametrize("arch", archs)


def _case(request, name):
    return {c[0]: c for c in request.module.CASES}[name]


def _reference(out_path, cases, all_cases, init_path=""):
    """``test_torch_spmd.py``'s reference subprocess over ``cases``; with
    ``init_path`` it first writes the initial state of every case of
    ``all_cases`` there."""
    tokens = {name: _torch_spmd.tokens(name, 128).tolist()
              for name, *_ in cases}
    spec = json.dumps({"cases": base._jsonable(cases), "tokens": tokens,
                       "frames": {}, "accum": _torch_spmd.ACCUM,
                       "eps": base.NOISE_EPS, "runs": base.NOISE_RUNS,
                       "init_path": str(init_path),
                       "init_cases": base._jsonable(all_cases)})
    env = dict(os.environ, PYTHONPATH=base.SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with open(f"{out_path}.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c",
                                 textwrap.dedent(base._REF), str(out_path),
                                 spec], env=env, stdout=log,
                                stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """The reference's results, then at once: the port's 4-rank SPMD steps
    (two worlds, half the test file's cases each; one world for a single
    case) and, when the file names its ``ARCHS``, a world of one."""
    cases, archs = request.module.CASES, request.module.ARCHS
    tmp = tmp_path_factory.mktemp("spmd_kinds")
    init = tmp / "reference_init.pkl"
    halves = [h for h in (cases[0::2], cases[1::2]) if h]
    procs = [_reference(tmp / f"reference{i}.pkl", half, cases,
                        init if i == 0 else "")
             for i, half in enumerate(halves)]
    dirs = [tmp / f"half{i}" for i in range(len(halves))]
    jobs = [(_torch_spmd.spmd_worker, 4, d, str(init), half)
            for d, half in zip(dirs, halves)]
    if archs:
        jobs.append((_torch_spmd.single_worker, 1, tmp / "single",
                     str(init), archs))
    for job in jobs:
        job[2].mkdir()
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
    for i in range(len(procs)):
        with open(tmp / f"reference{i}.pkl", "rb") as f:
            ref.update(pickle.load(f))
    ranks = [{} for _ in range(4)]
    states = {}
    for d in dirs:
        for r in range(4):
            ranks[r].update(json.loads((d / f"spmd{r}.json").read_text()))
        with open(d / "port_states.pkl", "rb") as f:
            states.update(pickle.load(f))
    single = (json.loads((tmp / "single" / "single.json").read_text())
              if archs else {})
    return {"ref": ref, "ranks": ranks, "states": states, "single": single}


def test_cases_take_the_modes_they_name(request):
    """The reference takes ``moe_sharded`` in every MoE case but the dense
    one, in ROW mode in the ``/row`` case and GRID mode in the others."""
    for case in request.module.CASES:
        cfg, (rows, cols) = _config(case), case[3]
        moe = cfg.num_experts > 0
        assert takes_moe_sharded(case) == (moe and "/dense" not in case[0])
        if takes_moe_sharded(case):
            grid = cfg.num_experts == rows * cols
            assert grid == ("/row" not in case[0]), case[0]


def _bf16_leaves(serialized) -> set:
    """The names of the leaves stored in bfloat16."""
    return {m["name"] for m in serialized[1]["leaves"]
            if m["dtype"] == "bfloat16"}


def _bf16_ulp(ref) -> float:
    """One bfloat16 step at the largest magnitude of ``ref``: a leaf kept
    in bfloat16 (deepseek-v3's Adafactor momentum) cannot agree more
    closely wherever its f32 value lies near a rounding boundary."""
    top = float(np.abs(ref).max())
    return 0.0 if top == 0 else 2.0 ** (np.floor(np.log2(top)) - 7)


def test_sharded_step_matches_reference(runs, name, request,
                                        record_property):
    """(a)"""
    case = _case(request, name)
    own_term = not takes_moe_sharded(case)
    ref = runs["ref"][name]
    got = runs["ranks"][0][name]["metrics"]
    want, plain = ref["metrics"]["sharded"], ref["metrics"]["plain"]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL, abs=0)
    own = abs(want["grad_norm"] / plain["grad_norm"] - 1) if own_term else 0
    rtol = max(FLOOR, 2 * own, 2 * ref["metrics"]["grad_norm_noise"])
    worst = [(abs(got["grad_norm"] / want["grad_norm"] - 1) / rtol,
              "grad_norm")]
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=rtol,
                                             abs=0)
    port = base._leaves(runs["states"][name])
    assert sorted(port) == sorted(ref["sharded"])
    bf16 = _bf16_leaves(runs["states"][name])
    bad = []
    for leaf, a in port.items():
        b = ref["sharded"][leaf]
        if not a.size:
            continue
        own = float(np.abs(b - ref["plain"][leaf]).max()) if own_term else 0
        tol = max(FLOOR, 2 * own, 2 * ref["noise"][leaf])
        if not own_term and leaf in bf16:
            tol = max(tol, _bf16_ulp(b))
        err = float(np.abs(a - b).max())
        worst.append((err / tol, leaf))
        if err > tol:
            bad.append((leaf, err, tol))
    record_property("worst_fraction", json.dumps(max(worst)))
    assert not bad, bad


def test_local_shards_match_reference_devices_indices_map(runs, name):
    """(b)"""
    want = runs["ref"][name]["indices"]
    coords = set()
    for r in runs["ranks"]:
        got = r[name]
        key = ",".join(map(str, got["coord"]))
        coords.add(key)
        assert sorted(got["blocks"]) == sorted(want)
        for leaf, block in got["blocks"].items():
            assert block == want[leaf][key], (leaf, key)
        assert got["placements"] == got["placements_before"]
    assert len(coords) == 4
    assert any(len({json.dumps(b) for b in per.values()}) > 1
               for per in want.values())


def test_constraint_placements_match_reference_spec(runs, name, request):
    """(c)"""
    shape = _case(request, name)[3]
    jrules = jsharding.RuleSet(base._RefMesh(shape))
    prules = RuleSet(base._PortMesh(shape))
    records = runs["ranks"][0][name]["constraints"]
    for rec in records:
        spec = jrules.spec(tuple(rec["axes"]), tuple(rec["shape"]))
        want = [str(p) for p in prules.placements(spec)]
        assert rec["placements"] == want, rec
    dense = name.endswith("/dense")
    assert {tuple(r["axes"]) for r in records} == \
        SITES | ({EXPERTS} if dense else set())
    sites = {r["site"] for r in records}
    assert ("forward_with_mtp" in sites) == name.startswith("deepseek-v3")
    experts = [r for r in records if tuple(r["axes"]) == EXPERTS]
    assert all(r["site"] == "_apply_moe" for r in experts)
    if dense:
        # xe and ye of each MoE layer (the trunk's and the MTP module's)
        # in each microbatch's forward
        assert len(experts) == 2 * 2 * _torch_spmd.ACCUM
    # every microbatch: the embedding, one residual a unit's repeat and,
    # with MTP, its projection
    assert sum(tuple(r["axes"]) == ("batch", None, None)
               for r in records) % _torch_spmd.ACCUM == 0


def test_world_of_one_equals_the_eager_step(runs, arch):
    """(d)"""
    assert runs["single"][arch] == []


def test_two_runs_are_bit_identical(runs, name):
    """(e)"""
    for r in runs["ranks"]:
        got = r[name]
        assert got["differ_between_runs"] == []
        assert got["metrics"] == got["metrics_again"]

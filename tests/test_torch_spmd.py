"""The port's SPMD train step over DTensors against the reference's jitted
sharded step, on 4 CPU ``gloo`` ranks and 4 forced host devices.

The reference (a subprocess) builds each case's reduced config, its
initial state and a batch made from a numpy seed, and runs
``jax.jit(make_train_step(...), in_shardings=(state, batch),
out_shardings=(state, None))`` under ``use_rules`` on a mesh it builds with
``AxisType.Auto`` axes, and the same step unsharded. The port loads the
initial state through the checkpoint format, places it and the batch with
the rule set and runs its ``make_train_step`` under ``use_rules``. Cases:
reduced starcoder2-3b (AdamW), gemma3-4b (``attn_local`` and ``attn``),
deepseek-coder-33b (Adafactor), recurrentgemma-9b (the RG-LRU kernel's
kind) and whisper-large-v3 (``enc`` and ``cross``, its ``enc_input``
placed by ``batch_axes`` with the tokens) on the (2, 2), (4, 1) and (1, 4)
meshes; gemma3's (1, 4) case has 2 heads over 1 KV head and whisper's 2
over 2, and both take the context-parallel branch (whisper's in its
encoder's self-attention, its decoder's and its cross-attention).

(a) The loss to rtol 1e-5. The gradient norm and every state leaf within
    the larger of the issue's bound, max(1e-5, 2 x the reference's own
    sharded-vs-plain difference), and twice the reference's own rounding
    noise: the largest change of its plain step's output when the initial
    params are perturbed at f32 rounding level (``NOISE_EPS``,
    ``NOISE_RUNS`` perturbations). Reduced gemma3-4b is chaotic at
    initialisation (embedding scale 8 over d_model 64, seven norms deep):
    such a perturbation moves its grad norm by up to 1e-2 relative, and the
    reference's own sharded and plain grad norms differ by 3.8e-3, so no
    implementation holds it to 1e-5. For the other configs the noise is
    under 1e-5 and the issue's bound is the one that binds. Worst
    measured, as a fraction of its tolerance: see
    ``test_sharded_step_matches_reference``.
(b) Every rank's block of every new leaf against the reference's
    ``devices_indices_map`` of its ``out_shardings``, and the leaf's
    placements the same before and after the step.
(c) The placements at each ported constraint site (recorded by wrapping
    ``sharding.constrain`` in the workers) against the reference's
    ``RuleSet.spec`` of the same logical axes and shape.
(d) On a world of one ((1, 1) mesh), the SPMD step equals the eager step
    bit for bit.
(e) Two runs on the same mesh are bit-identical.
Besides: each kernel wrapper over DTensors against its plain version, and
a DTensor handed to a kernel's own wrapper raises."""
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
from repro.launch import sharding as jsharding
from repro_torch.checkpoint import serializer as ser
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch.sharding import RuleSet

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = _torch_spmd.cases()
NAMES = [c[0] for c in CASES]
# the reference's rounding-noise probe: perturbed initial params
NOISE_EPS, NOISE_RUNS = 6e-8, 8
LOSS_RTOL, FLOOR = 1e-5, 1e-5
# the constraint sites the port's train path records under a rule set
SITES = {(None, "batch", None): "the stacked microbatches",
         ("batch", None): "each microbatch",
         ("batch", None, None): "the trunk's embedding and residual",
         (None, "batch", None, None): "the stacked microbatches' enc_input",
         ("batch", "seq", None, None): "attention's q (context parallel)"}
CP = ("batch", "seq", None, None)
# the functions that constrain q in each context-parallel case's step
CP_SITES = {"gemma3-4b@1x4": {"self_attention"},
            "whisper-large-v3@1x4": {"self_attention", "cross_attend"}}

_REF = """
    import dataclasses, json, os, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.checkpoint import serializer as jser
    from repro.configs.base import get_config, reduced
    from repro.launch.sharding import RuleSet, batch_axes, use_rules
    from repro.models.registry import build_model
    from repro.runtime.train_step import (TrainState, make_optimizer,
                                          make_train_step, state_logical_axes)

    out_path, spec = sys.argv[1], json.loads(sys.argv[2])
    accum, eps, runs = spec["accum"], spec["eps"], spec["runs"]

    def tree(t):
        return jax.device_get({"params": t.params,
                               "opt_state": t.opt_state})

    def leaves(t):
        return {n: np.asarray(a, np.float32)
                for n, a in jser.tree_paths(tree(t))}

    def build(arch, overrides):
        cfg = dataclasses.replace(reduced(get_config(arch)), **overrides)
        model = build_model(cfg)
        opt = make_optimizer(cfg)
        params = model.init(jax.random.PRNGKey(0))
        return cfg, model, opt, TrainState(params, opt.init(params))

    if spec["init_path"]:
        # every case's initial state first: the port's ranks wait for it
        inits = {name: jser.serialize_tree(tree(build(arch, ov)[3]))
                 for name, arch, ov, _ in spec["init_cases"]}
        with open(spec["init_path"] + ".tmp", "wb") as f:
            pickle.dump({n: {"init": i} for n, i in inits.items()}, f)
        os.replace(spec["init_path"] + ".tmp", spec["init_path"])

    out, plains = {}, {}
    for name, arch, overrides, shape in spec["cases"]:
        cfg, model, opt, state = build(arch, overrides)
        params = state.params
        tok = np.asarray(spec["tokens"][name])
        batch = {"inputs": tok[:, :-1], "labels": tok[:, 1:]}
        if name in spec["frames"]:
            batch["enc_input"] = np.asarray(spec["frames"][name], np.float32)
        step = make_train_step(cfg, model, opt, accum_steps=accum)
        key = json.dumps([arch, overrides])
        if key not in plains:
            plain_step = jax.jit(step)
            plain, pm = plain_step(state, batch)
            base = leaves(plain)
            noise = {n: 0.0 for n in base}
            gnoise = 0.0
            rng = np.random.default_rng(0)
            for _ in range(runs):
                pert = jax.tree.map(
                    lambda a: a * (1 + eps * rng.standard_normal(a.shape)
                                   ).astype(a.dtype), params)
                p2, m2 = plain_step(TrainState(pert, state.opt_state), batch)
                for n, a in leaves(p2).items():
                    if a.size:
                        noise[n] = max(noise[n],
                                       float(np.abs(a - base[n]).max()))
                gnoise = max(gnoise, abs(float(m2["grad_norm"])
                                         / float(pm["grad_norm"]) - 1))
            plains[key] = (base, {k: float(v) for k, v in pm.items()},
                           noise, gnoise)
        base, pm, noise, gnoise = plains[key]
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        rules = RuleSet(mesh)
        with use_rules(rules):
            st_sh = rules.tree_shardings(state_logical_axes(cfg, model, opt),
                                         state)
            b_sh = rules.tree_shardings(batch_axes(batch), batch)
            # a step function of its own: jit's trace cache is keyed on the
            # function, not on the active rule set, so the plain step's
            # trace would run here without the rules (no constraint, no
            # moe_sharded)
            sharded_step = make_train_step(cfg, model, opt,
                                           accum_steps=accum)
            sharded, sm = jax.jit(sharded_step, in_shardings=(st_sh, b_sh),
                                  out_shardings=(st_sh, None))(state, batch)
        indices = {}
        for (n, sh), (_, leaf) in zip(
                jser.tree_paths({"params": st_sh.params,
                                 "opt_state": st_sh.opt_state}),
                jser.tree_paths(tree(state))):
            per = {}
            for dev, idx in sh.devices_indices_map(leaf.shape).items():
                coord = ",".join(str(int(c)) for c in
                                 np.argwhere(mesh.devices == dev)[0])
                per[coord] = {
                    "offset": [s.start or 0 for s in idx],
                    "shape": [(s.stop if s.stop is not None else d)
                              - (s.start or 0)
                              for s, d in zip(idx, leaf.shape)]}
            indices[n] = per
        out[name] = {
            "sharded": leaves(sharded), "plain": base, "noise": noise,
            "metrics": {"sharded": {k: float(v) for k, v in sm.items()},
                        "plain": pm, "grad_norm_noise": gnoise},
            "indices": indices}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
"""


def _jsonable(cases):
    return [list(c[:3]) + [list(c[3])] for c in cases]


def _reference(out_path, cases, init_path=""):
    """The reference's subprocess over ``cases``, its output in a log file
    beside ``out_path``; with ``init_path`` it first writes every case's
    initial state there."""
    tokens = {name: _torch_spmd.tokens(name, 128).tolist()
              for name, *_ in cases}
    frames = {}
    for name, arch, _, _ in cases:
        cfg = reduced(get_config(arch))
        if cfg.encoder_seq:
            frames[name] = _torch_spmd.frames(name, cfg.encoder_seq,
                                              cfg.encoder_dim).tolist()
    spec = json.dumps({"cases": _jsonable(cases), "tokens": tokens,
                       "frames": frames,
                       "accum": _torch_spmd.ACCUM, "eps": NOISE_EPS,
                       "runs": NOISE_RUNS, "init_path": str(init_path),
                       "init_cases": _jsonable(CASES)})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with open(f"{out_path}.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c",
                                 textwrap.dedent(_REF), str(out_path), spec],
                                env=env, stdout=log,
                                stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, then at once: the port's 4-rank SPMD steps,
    the kernel wrappers on 4 ranks, and a world of one."""
    tmp = tmp_path_factory.mktemp("spmd")
    init = tmp / "reference_init.pkl"
    # the reference's steps in two processes, half the cases each; the
    # first writes the initial states, which the port's ranks wait for
    procs = [_reference(tmp / f"reference{i}.pkl", CASES[i::2],
                        init if i == 0 else "") for i in (0, 1)]
    dirs = {k: tmp / k for k in ("even", "odd", "single", "ops")}
    for d in dirs.values():
        d.mkdir()
    jobs = [(_torch_spmd.spmd_worker, 4, dirs["even"], str(init),
             CASES[0::2]),
            (_torch_spmd.spmd_worker, 4, dirs["odd"], str(init),
             CASES[1::2]),
            (_torch_spmd.single_worker, 1, dirs["single"], str(init),
             _torch_spmd.ARCHS),
            (_torch_spmd.ops_worker, 4, dirs["ops"])]
    failures = []

    def side(*todo):
        try:
            for fn, world, where, *args in todo:
                _torch_dist.spawn(fn, world, where, str(where), *args)
        except Exception as e:          # raised by the main thread
            failures.append(e)

    threads = [threading.Thread(target=side, args=todo)
               for todo in ((jobs[1],), (jobs[2], jobs[3]))]
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
    states = {}
    for d in (dirs["even"], dirs["odd"]):
        for r in range(4):
            ranks[r].update(json.loads((d / f"spmd{r}.json").read_text()))
        with open(d / "port_states.pkl", "rb") as f:
            states.update(pickle.load(f))
    single_dir, ops_dir = dirs["single"], dirs["ops"]
    return {"ref": ref, "ranks": ranks, "states": states,
            "single": json.loads((single_dir / "single.json").read_text()),
            "ops": json.loads((ops_dir / "ops.json").read_text())}


def _leaves(serialized):
    payloads, manifest = serialized
    return {m["name"]: ser.deserialize_leaf(payloads[m["name"]], m)
            .float().numpy() for m in manifest["leaves"]}


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_reference(runs, name):
    """(a), with the tolerances of the module docstring. Measured worst
    cases, as fractions of their tolerance: leaves 0.55 (gemma3-4b@1x4's
    ``opt_state/.m/embed/tokens``, 6.6e-5 against the noise bound) and
    0.50 (deepseek-coder-33b's bf16 momentum: one bf16 step, twice the
    reference's own difference), whisper-large-v3's at most 0.23
    (2.3e-6 against 1e-5); grad norms 0.32 (whisper-large-v3@1x4) and
    0.30 (gemma3-4b@2x2, 3.5e-3 relative against its noise bound), and
    the other configs' within 1e-5 of the reference (at most 8.9e-6,
    recurrentgemma-9b@2x2); losses within 1.8e-7."""
    ref = runs["ref"][name]
    got = runs["ranks"][0][name]["metrics"]
    want, plain = ref["metrics"]["sharded"], ref["metrics"]["plain"]
    assert got["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL, abs=0)
    own = abs(want["grad_norm"] / plain["grad_norm"] - 1)
    rtol = max(FLOOR, 2 * own, 2 * ref["metrics"]["grad_norm_noise"])
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=rtol,
                                             abs=0)
    port = _leaves(runs["states"][name])
    assert sorted(port) == sorted(ref["sharded"])
    bad = []
    for leaf, a in port.items():
        b = ref["sharded"][leaf]
        if not a.size:
            continue
        own = float(np.abs(b - ref["plain"][leaf]).max())
        tol = max(FLOOR, 2 * own, 2 * ref["noise"][leaf])
        err = float(np.abs(a - b).max())
        if err > tol:
            bad.append((leaf, err, tol))
    assert not bad, bad


@pytest.mark.parametrize("name", NAMES)
def test_local_shards_match_reference_devices_indices_map(runs, name):
    """(b): every rank's block of every new leaf is the one the reference's
    ``out_shardings`` gives its device, and each leaf keeps its placements
    through the step; some leaves are split over the ranks."""
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


class _RefMesh:
    """The reference's ``FakeMesh``: names and shape only."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.devices = type("Devices", (), {"shape": tuple(shape)})()


class _PortMesh:
    def __init__(self, shape):
        self.mesh_dim_names, self.shape = ("data", "model"), tuple(shape)


@pytest.mark.parametrize("name", NAMES)
def test_constraint_placements_match_reference_spec(runs, name):
    """(c): every recorded constraint's placements are the reference's
    ``RuleSet.spec`` of its logical axes and shape on this mesh, and the
    sites recorded are the train path's (the context-parallel q only where
    the reference takes that branch)."""
    shape = dict((c[0], c[3]) for c in CASES)[name]
    jrules = jsharding.RuleSet(_RefMesh(shape))
    prules = RuleSet(_PortMesh(shape))
    records = runs["ranks"][0][name]["constraints"]
    for rec in records:
        spec = jrules.spec(tuple(rec["axes"]), tuple(rec["shape"]))
        want = [str(p) for p in prules.placements(spec)]
        assert rec["placements"] == want, rec
    seen = {tuple(r["axes"]) for r in records}
    expected = set(SITES)
    if name not in _torch_spmd.CP_CASES:
        expected.discard(CP)
    if not name.startswith("whisper-large-v3"):
        expected.discard((None, "batch", None, None))
    assert seen == expected
    # every microbatch: the embedding and one residual a unit's repeat
    assert sum(tuple(r["axes"]) == ("batch", None, None)
               for r in records) % _torch_spmd.ACCUM == 0


def test_context_parallel_case_takes_the_branch(runs):
    """gemma3-4b@1x4 and whisper-large-v3@1x4: q is constrained over the
    sequence at each site of the step (whisper's cross-attention too), and
    each rank's flash calls take its quarter of the queries at its
    absolute offset (whisper's encoder: a quarter of its 16 frames)."""
    for name in _torch_spmd.CP_CASES:
        for r in runs["ranks"]:
            got = r[name]
            assert {c["site"] for c in got["constraints"]
                    if tuple(c["axes"]) == CP} == CP_SITES[name]
            block, m = _torch_spmd.SEQ // 4, got["coord"][1]
            want = {(block, m * block)}
            if name.startswith("whisper-large-v3"):
                want.add((16 // 4, m * 16 // 4))
            assert got["flash"]
            assert {(f["sq"], f["q_offset"]) for f in got["flash"]} == want
    for name in NAMES:
        if name not in _torch_spmd.CP_CASES:
            # whole sequences: the tokens (and whisper's 16 frames)
            whole = {_torch_spmd.SEQ}
            if name.startswith("whisper-large-v3"):
                whole.add(16)
            assert all(f["q_offset"] == 0 and f["sq"] in whole
                       for f in runs["ranks"][0][name]["flash"])


@pytest.mark.parametrize("arch", _torch_spmd.ARCHS)
def test_world_of_one_equals_the_eager_step(runs, arch):
    """(d)"""
    assert runs["single"][arch] == []


@pytest.mark.parametrize("name", NAMES)
def test_two_runs_are_bit_identical(runs, name):
    """(e)"""
    for r in runs["ranks"]:
        got = r[name]
        assert got["differ_between_runs"] == []
        assert got["metrics"] == got["metrics_again"]


# f32 throughout; each rank runs the plain version on its shards, so only
# sums that the plan splits or regroups differ: dk / dv summed over ranks
# (context parallel) or over a repeated KV head's group (measured up to
# 3.4e-6, there)
OPS_TOL = 1e-5


# each flash case's local calls on each rank: (q length, heads, KV heads,
# q_offset) by the model axis's size m and the rank's model coordinate c
PLANS = {"heads": lambda m, c: (32, 4 // m, 2 // m if m == 2 else 4 // m, 0),
         "heads_mqa": lambda m, c: (32, 4 // m, 4 // m, 0),
         "context_parallel": lambda m, c: (32 // m, 3, 1, c * 32 // m),
         "batch_only": lambda m, c: (31, 3, 1, 0)}


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_kernel_wrappers_over_dtensors_match_plain(runs, mesh):
    """Each kernel's ``ops`` wrapper over DTensors (through ``local_map``)
    against its plain version on the whole tensors: outputs and input
    gradients; flash attention in each of its plans, with and without a
    window, and each plan's local calls on rank 0 (k / v heads sharded
    where the model axis divides them, else repeated to q's). A DTensor
    given to a kernel's own wrapper raises."""
    ops = {k: v for k, v in runs["ops"].items() if k.endswith(mesh)}
    assert len(ops) == 19
    m = int(mesh.split("x")[1])
    for key, got in ops.items():
        if key.startswith("direct_raises"):
            assert all(e and "DTensor" in e for e in got), got
        elif key.startswith("plan/"):
            assert [tuple(g) for g in got] == \
                [PLANS[key.split("/")[1]](m, 0)], key
        else:
            assert got <= OPS_TOL, (key, got)

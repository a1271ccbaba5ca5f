"""The port's sharded serving over DTensors against the reference's jitted
sharded prefill and decode, on 4 CPU ``gloo`` ranks and 4 forced host
devices.

The reference (subprocesses) builds each case's reduced config and its
params, and runs ``launch/dryrun.py``'s wiring with real arrays: the
prefill jitted with ``in_shardings=(params by param_axes, cache by
cache_axes, tokens by batch_axes)`` and ``out_shardings=(None, cache)``,
then the decode step likewise, on a mesh built with ``AxisType.Auto`` axes
(the reference's own ``make_host_mesh`` gives Explicit axes, which
``with_sharding_constraint`` refuses on JAX 0.9), and the same two steps
unsharded. Its plain run's greedy tokens drive every decode step of both
packages (teacher forcing: a near-tie cannot split the runs). The port
loads the params through the checkpoint format, places them by
``param_axes``, makes the cache placed by ``cache_axes`` and runs
``make_prefill`` / ``make_decode_step`` with the rule set. Cases: reduced
starcoder2-3b (``attn``), gemma3-4b (``attn_local`` and ``attn``),
recurrentgemma-9b (``rglru`` and ``attn_local``: the RG-LRU scan at
S = 32 and S = 1) and whisper-large-v3 (``enc`` and ``cross``) on the
(2, 2), (4, 1) and (1, 4) meshes: B = 4 prompts of 32 tokens (past the
16-token windows), 8 decode steps, a 48-token cache; whisper over its
16-frame context. gemma3's and whisper's (1, 4) cases have 2 heads and
take the context-parallel branch.

(a) The prefill's and every decode step's logits, and every leaf of the
    final cache, within the larger of the bound max(1e-5, 2 x the
    reference's own sharded-vs-plain difference), and twice the
    reference's own rounding noise (the largest change of its plain run's
    output when its params are perturbed at f32 rounding level:
    ``NOISE_EPS``, ``NOISE_RUNS`` perturbations), of the reference's
    sharded run, as ``tests/test_torch_spmd.py`` holds the train step.
    Reduced gemma3-4b (embedding scale 8 over d_model 64) amplifies
    rounding: its caches of magnitude ~20 move by up to 2.8e-3 under the
    probe, and its 2-head (1, 4) case's own sharded-vs-plain difference is
    1.3e-4 there, so the noise term binds; for the other configs both terms
    are a few f32 ulps of the cache. Worst measured, as a fraction of its
    tolerance: 0.71 (recurrentgemma-9b@2x2, a decode step's logits, 1.05e-5
    against 1.47e-5), then 0.67 (starcoder2-3b@4x1 and whisper's, a cache's
    K, 7.6e-6 against 1.14e-5) and 0.58 (gemma3-4b@1x4, 6.7e-6).
(b) The greedy tokens equal wherever the reference's top-2 gap exceeds
    that tolerance (most rows of most steps).
(c) Every rank's block of every cache leaf returned by the last decode
    step is the one the reference's ``c_shardings`` gives its device, its
    local tensor holds that block of the whole leaf, its placements are the
    rule set's after the prefill and after the decode, and it is still the
    storage ``init_cache`` allocated (every write went into a rank's own
    block; nothing replaced the cache).
(d) On a world of one ((1, 1) mesh), the sharded serve equals the eager
    serve bit for bit.
(e) Two runs on the same mesh are bit-identical.
(f) The context-parallel cases constrain q at the attn kinds' prefill, the
    cross prefill's self-attention and cross-attention, and each rank's
    flash calls take its quarter of the queries at its absolute offset."""
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

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CASES = harness.cases()
NAMES = [c[0] for c in CASES]
FLOOR = 1e-5
# the reference's rounding-noise probe: perturbed params
NOISE_EPS, NOISE_RUNS = 6e-8, 4
CP_CASES = sorted(harness.CP_OVERRIDES)

_REF = """
    import dataclasses, json, os, pickle, sys, time
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.checkpoint import serializer as jser
    from repro.configs.base import get_config, reduced
    from repro.launch.sharding import (RuleSet, batch_axes, cache_axes,
                                       use_rules)
    from repro.models.registry import build_model
    from repro.runtime.serve_step import greedy_token

    out_path, spec_path = sys.argv[1], sys.argv[2]
    with open(spec_path) as f:
        spec = json.load(f)
    B, S, G, MS = spec["batch"], spec["prompt"], spec["gen"], spec["max_seq"]

    def build(arch, overrides):
        cfg = dataclasses.replace(reduced(get_config(arch)), **overrides)
        model = build_model(cfg)
        return cfg, model, model.init(jax.random.PRNGKey(0))

    # the jitted prefill and decode, plain or with the shardings of rule
    # set ``shardings``, and config ``key``'s prefill inputs
    def steps(cfg, model, params, key, shardings=None):
        def prefill_fn(params, cache, specs):
            return model.prefill(params, cache, specs["tokens"],
                                 specs.get("enc_input"))

        def decode_fn(params, cache, specs, pos):
            return model.decode_step(params, cache, specs["tokens"], pos)

        specs = {"tokens": np.asarray(spec["prompts"][key], np.int32)}
        if spec["enc"][key] is not None:
            specs["enc_input"] = np.asarray(spec["enc"][key], np.float32)
        if shardings is None:
            return jax.jit(prefill_fn), jax.jit(decode_fn), None, specs
        else:
            rules = shardings
            p_sh = rules.tree_shardings(model.param_axes(), params)
            cache_struct = jax.eval_shape(lambda: model.init_cache(B, MS))
            c_sh = rules.tree_shardings(cache_axes(cfg, cache_struct),
                                        cache_struct)
            tok_sh = rules.tree_shardings(batch_axes(specs), specs)
            one = {"tokens": np.zeros((B, 1), np.int32)}
            one_sh = rules.tree_shardings(batch_axes(one), one)
            pf = jax.jit(prefill_fn, in_shardings=(p_sh, c_sh, tok_sh),
                         out_shardings=(None, c_sh))
            dc = jax.jit(decode_fn, in_shardings=(p_sh, c_sh, one_sh, None),
                         out_shardings=(None, c_sh))
            return pf, dc, c_sh, specs

    # the prompt, then G decode steps (each on its own greedy token, or
    # teacher-forced on ``forced``): the steps' logits and greedy tokens,
    # and the final cache's leaves
    def run(cfg, model, params, fns, forced):
        pf, dc, _, specs = fns
        logits, cache = pf(params, model.init_cache(B, MS), specs)
        out = [logits]
        for i in range(G):
            tok = (greedy_token(cfg, logits) if forced is None
                   else jnp.asarray(forced[i], jnp.int32))
            logits, cache = dc(params, cache, {"tokens": tok},
                               jnp.int32(S + i))
            out.append(logits)
        leaves = {n: np.asarray(a, np.float32)
                  for n, a in jser.tree_paths(jax.device_get(cache))}
        toks = [np.asarray(greedy_token(cfg, l)) for l in out]
        logits = [np.asarray(l, np.float32) for l in out]
        return logits, toks, leaves

    if spec["init_path"]:
        # every config's params and plain run first: the port's ranks and
        # the other reference process wait for them
        init = {}
        rng = np.random.default_rng(0)
        for key, (arch, overrides) in spec["configs"].items():
            cfg, model, params = build(arch, overrides)
            fns = steps(cfg, model, params, key)
            logits, toks, leaves = run(cfg, model, params, fns, None)
            forced = [t.tolist() for t in toks[:G]]
            # the rounding noise: the plain run's largest change when its
            # params are perturbed at f32 rounding level
            noise = {"logits": [0.0] * len(logits),
                     "cache": {n: 0.0 for n in leaves}}
            for _ in range(spec["noise_runs"]):
                pert = jax.tree.map(
                    lambda a: a * (1 + spec["noise_eps"] * rng.standard_normal(
                        a.shape)).astype(a.dtype), params)
                l2, _, c2 = run(cfg, model, pert, fns, forced)
                noise["logits"] = [max(n, float(np.abs(a - b).max()))
                                   for n, a, b in zip(noise["logits"], l2,
                                                      logits)]
                noise["cache"] = {n: max(v, float(np.abs(c2[n]
                                                         - leaves[n]).max()))
                                  for n, v in noise["cache"].items()}
            init[key] = {
                "params": jser.serialize_tree(
                    jax.device_get({"params": params})),
                "tokens": forced, "logits": logits, "cache": leaves,
                "noise": noise}
        with open(spec["init_path"] + ".tmp", "wb") as f:
            pickle.dump(init, f)
        os.replace(spec["init_path"] + ".tmp", spec["init_path"])
    while not os.path.exists(spec["wait_path"]):
        time.sleep(0.2)
    with open(spec["wait_path"], "rb") as f:
        init = pickle.load(f)

    out = {}
    for name, arch, overrides, shape in spec["cases"]:
        key = json.dumps([arch, overrides], sort_keys=True)
        cfg, model, params = build(arch, overrides)
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        rules = RuleSet(mesh)
        with use_rules(rules):
            fns = steps(cfg, model, params, key, rules)
            logits, toks, leaves = run(cfg, model, params, fns,
                                       init[key]["tokens"])
        c_sh = fns[2]
        gaps = []
        for l in logits:
            top = np.sort(l[..., :cfg.vocab_size], axis=-1)
            gaps.append(top[..., -1] - top[..., -2])
        indices = {}
        for n, sh in jser.tree_paths(c_sh):
            per = {}
            for dev, idx in sh.devices_indices_map(leaves[n].shape).items():
                coord = ",".join(str(int(c)) for c in
                                 np.argwhere(mesh.devices == dev)[0])
                per[coord] = {
                    "offset": [s.start or 0 for s in idx],
                    "shape": [(s.stop if s.stop is not None else d)
                              - (s.start or 0)
                              for s, d in zip(idx, leaves[n].shape)]}
            indices[n] = per
        out[name] = {"logits": logits, "tokens": toks, "gaps": gaps,
                     "cache": leaves, "plain_logits": init[key]["logits"],
                     "plain_cache": init[key]["cache"],
                     "noise": init[key]["noise"], "indices": indices}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
"""


def _spec(tmp, init_path, wait_path, cases):
    """The reference's inputs, written to a JSON file."""
    configs, prompts, enc = {}, {}, {}
    for _, arch, overrides, _ in CASES:
        key = harness.config_key(arch, overrides)
        cfg = harness._config(arch, overrides)
        p, e = harness.inputs(arch, cfg.vocab_size, cfg.encoder_seq,
                              cfg.encoder_dim)
        configs[key] = [arch, overrides]
        prompts[key] = p.tolist()
        enc[key] = None if e is None else e.tolist()
    spec = {"cases": [list(c[:3]) + [list(c[3])] for c in cases],
            "configs": configs, "prompts": prompts, "enc": enc,
            "batch": harness.BATCH, "prompt": harness.PROMPT,
            "gen": harness.GEN, "max_seq": harness.MAX_SEQ,
            "noise_eps": NOISE_EPS, "noise_runs": NOISE_RUNS,
            "init_path": str(init_path), "wait_path": str(wait_path)}
    path = tmp / f"spec{len(list(tmp.glob('spec*')))}.json"
    path.write_text(json.dumps(spec))
    return path


def _reference(tmp, out_path, cases, init, first):
    """A reference subprocess over ``cases``, its output in a log beside
    ``out_path``; the ``first`` writes every config's params and plain
    run to ``init``, which every process then reads."""
    spec = _spec(tmp, init if first else "", init, cases)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with open(f"{out_path}.log", "w") as log:
        return subprocess.Popen([sys.executable, "-c",
                                 textwrap.dedent(_REF), str(out_path),
                                 str(spec)],
                                env=env, stdout=log,
                                stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, then at once: the port's sharded serving
    on 4 ranks (two worlds, half the cases each) and a world of one."""
    tmp = tmp_path_factory.mktemp("spmd_serve")
    init = tmp / "reference_init.pkl"
    procs = [_reference(tmp, tmp / f"reference{i}.pkl", CASES[i::2], init,
                        i == 0) for i in (0, 1)]
    dirs = {k: tmp / k for k in ("even", "odd", "single")}
    for d in dirs.values():
        d.mkdir()
    jobs = [(harness.serve_worker, 4, dirs["even"], str(init), CASES[0::2]),
            (harness.serve_worker, 4, dirs["odd"], str(init), CASES[1::2]),
            (harness.single_worker, 1, dirs["single"], harness.ARCHS)]
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


def _tolerance(sharded, plain, noise):
    """max(FLOOR, 2 x the reference's own sharded-vs-plain difference,
    2 x its rounding noise)."""
    return max(FLOOR, 2 * float(np.abs(sharded - plain).max()), 2 * noise)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_serve_matches_reference(runs, name):
    """(a): the prefill's and each decode step's logits, and each leaf of
    the final cache."""
    ref, port = runs["ref"][name], runs["port"][name]
    bad = []
    for i, (got, want, plain, noise) in enumerate(zip(
            port["logits"], ref["logits"], ref["plain_logits"],
            ref["noise"]["logits"])):
        err = float(np.abs(got - want).max())
        tol = _tolerance(want, plain, noise)
        if err > tol:
            bad.append((f"logits of step {i}", err, tol))
    assert len(port["logits"]) == harness.GEN + 1
    assert sorted(port["cache"]) == sorted(ref["cache"])
    for leaf, got in port["cache"].items():
        want, plain = ref["cache"][leaf], ref["plain_cache"][leaf]
        err = float(np.abs(got - want).max())
        tol = _tolerance(want, plain, ref["noise"]["cache"][leaf])
        if err > tol:
            bad.append((leaf, err, tol))
    assert not bad, bad


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_match_where_the_gap_is_clear(runs, name):
    """(b)"""
    ref, port = runs["ref"][name], runs["port"][name]
    clear = 0
    for got, want, gap, logits, plain, noise in zip(
            port["tokens"], ref["tokens"], ref["gaps"], ref["logits"],
            ref["plain_logits"], ref["noise"]["logits"]):
        sure = gap > _tolerance(logits, plain, noise)
        assert np.array_equal(got[sure], want[sure])
        clear += int(sure.sum())
    assert clear > harness.BATCH * (harness.GEN + 1) // 2


@pytest.mark.parametrize("name", NAMES)
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
    # the caches are split over the ranks
    assert any(len({json.dumps(b) for b in per.values()}) > 1
               for per in want.values())


@pytest.mark.parametrize("arch", harness.ARCHS)
def test_world_of_one_equals_the_eager_serve(runs, arch):
    """(d)"""
    assert runs["single"][arch] == {"differ": [], "moved": []}


@pytest.mark.parametrize("name", NAMES)
def test_two_runs_are_bit_identical(runs, name):
    """(e)"""
    for r in runs["ranks"]:
        assert r[name]["differ_between_runs"] == []


# the constraint sites of each context-parallel case's prefill, by the
# function that constrains q
CP_SITES = {"gemma3-4b@1x4": {"prefill"},
            "whisper-large-v3@1x4": {"self_attention", "_cross_prefill",
                                     "cross_attend"}}


@pytest.mark.parametrize("name", CP_CASES)
def test_context_parallel_cases_take_the_branch(runs, name):
    """(f): q constrained over the sequence at the case's sites (whisper's
    encoder too, at ``self_attention``), and each rank's flash calls take
    its block of the queries at its absolute offset: 32 prompt tokens (16
    frames in whisper's encoder) over the 4 model ranks."""
    for r in runs["ranks"]:
        got = r[name]
        sites = {c["site"] for c in got["constraints"]
                 if c["axes"] == ["batch", "seq", None, None]}
        assert sites == CP_SITES[name]
        m = got["coord"][1]
        assert got["flash"]
        assert {(f["sq"], f["q_offset"]) for f in got["flash"]} <= \
            {(8, 8 * m), (4, 4 * m)}
    others = [n for n in NAMES if n not in CP_CASES]
    for n in others:
        assert not any(c["axes"] == ["batch", "seq", None, None]
                       for c in runs["ranks"][0][n]["constraints"])
        assert all(f["q_offset"] == 0 for f in runs["ranks"][0][n]["flash"])

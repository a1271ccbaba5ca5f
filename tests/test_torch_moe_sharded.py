"""Expert-parallel MoE (``repro_torch.models.moe_sharded``) on a (2, 2)
mesh of 4 ``gloo`` ranks against the reference's ``apply_moe_sharded`` on
4 host devices (one subprocess), on the same numpy inputs: reduced
deepseek-v3-671b and llama4-scout-17b-a16e in f32, GRID mode (4 experts at
top-2, one a device) and ROW mode (2 experts, one a data row, f split over
``model``), each at capacity factor 8 (no drops) and 1.0 (drops). Without
drops the outputs also equal the port's dense ``apply_moe``; with no rule
set, ``apply_moe`` is the sorted dispatch it was, bit for bit.

The backward: over DTensors (x placed by the batch rule, the params by
their logical axes) under the rule set, the gradients of sum(out * w) for
x, the router, the experts and the shared expert against the reference's
``jax.grad`` of ``apply_moe`` under its rules (GRID and ROW mode, with and
without drops), and without drops against the port's dense ``apply_moe``
under autograd. The same check fails when the sum over ``model``'s
backward is an all-reduce (every col's part counted ncols times), and two
runs are bit-identical (the combine sums in a fixed order)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_dist
from repro_torch.models import moe, moe_sharded
from repro_torch.models.common import activation, tree_leaves
from repro_torch.launch.sharding import RuleSet, use_rules

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the reference's bound (tests/test_sharding.py)
TOL = 1e-4
B, S = 4, 16
MODES = {"grid": dict(num_experts=4, top_k=2, d_ff_expert=32),
         "row": dict(num_experts=2, top_k=1, d_ff_expert=32)}
CASES = {f"{arch.split('-')[0]}_{mode}_cf{cf:g}":
         dict(arch=arch, capacity_factor=cf, **over)
         for arch in ("deepseek-v3-671b", "llama4-scout-17b-a16e")
         for mode, over in MODES.items() for cf in (8.0, 1.0)}

_REF = """
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_config, reduced
    from repro.launch.mesh import make_host_mesh
    from repro.launch.sharding import RuleSet, use_rules
    from repro.models import moe, moe_sharded

    cases = json.loads(sys.argv[3])
    data = np.load(sys.argv[1])
    mesh = make_host_mesh(data=2, model=2)
    rules = RuleSet(mesh)
    out = {}
    for name, spec in cases.items():
        spec = dict(spec)
        cfg = dataclasses.replace(
            reduced(get_config(spec.pop("arch"))), compute_dtype="float32",
            param_dtype="float32", **spec)
        assert moe_sharded.sharded_moe_available(cfg, rules), name
        p = {}
        prefix = name + "/p/"
        for key in data.files:
            if key.startswith(prefix):
                *path, leaf = key[len(prefix):].split("/")
                node = p
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = jnp.asarray(data[key])
        x = jnp.asarray(data[name + "/x"])
        with jax.set_mesh(mesh), use_rules(rules):
            sh = jax.jit(lambda p, x:
                         moe_sharded.apply_moe_sharded(cfg, p, x, rules))(p, x)
        out[name] = np.asarray(sh)
        # jax.grad of sum(out * w) through apply_moe under the rules (a
        # function of its own, traced with them active)
        w = jnp.asarray(data[name + "/w"])
        with jax.set_mesh(mesh), use_rules(rules):
            gp, gx = jax.jit(jax.grad(
                lambda p, x: jnp.sum(moe.apply_moe(cfg, p, x) * w),
                argnums=(0, 1)))(p, x)
        out[name + "/grad/x"] = np.asarray(gx)
        for k, v in gp.items():
            for sub, leaf in (v.items() if isinstance(v, dict)
                              else ((None, v),)):
                key = k if sub is None else k + "/" + sub
                out[name + "/grad/" + key] = np.asarray(leaf)
    np.savez(sys.argv[2], **out)
"""


def _inputs(name, spec):
    """numpy-seeded params (the descriptors' shapes, scaled by fan-in) and
    x, flattened to npz keys."""
    cfg = _torch_dist.moe_cfg(**spec)
    rng = np.random.default_rng(sorted(CASES).index(name))
    out = {}

    def draw(path, desc):
        fan_in = desc.shape[-2] if len(desc.shape) >= 2 else desc.shape[-1]
        out[f"{name}/p/{path}"] = (rng.normal(size=desc.shape)
                                   / np.sqrt(fan_in)).astype(np.float32)

    for key, desc in moe.moe_descs(cfg).items():
        if isinstance(desc, dict):
            for sub, d in desc.items():
                draw(f"{key}/{sub}", d)
        else:
            draw(key, desc)
    out[f"{name}/x"] = rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    # the projection whose sum the gradient tests differentiate
    out[f"{name}/w"] = rng.normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """(inputs, the port's outputs, the reference's), computed at once."""
    tmp = tmp_path_factory.mktemp("moe_sharded")
    inputs = {}
    for name, spec in CASES.items():
        inputs.update(_inputs(name, spec))
    in_path, ref_path = tmp / "inputs.npz", tmp / "reference.npz"
    np.savez(in_path, **inputs)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF),
                            str(in_path), str(ref_path), json.dumps(CASES)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        _torch_dist.spawn(_torch_dist.moe_worker, 4, tmp, str(tmp),
                          str(in_path), CASES)
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    return (np.load(in_path), np.load(tmp / "moe_port.npz"),
            np.load(ref_path))


def _dense(inputs, name):
    cfg = _torch_dist.moe_cfg(**CASES[name])
    p = _torch_dist._moe_params(inputs, name)
    return moe.apply_moe(cfg, p, torch.from_numpy(inputs[f"{name}/x"])) \
        .numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_matches_reference(outputs, name):
    inputs, port, ref = outputs
    got, want = port[f"{name}/whole"], ref[name]
    assert got.shape == want.shape == inputs[f"{name}/x"].shape
    assert np.isfinite(got).all()
    err = float(np.max(np.abs(got - want)))
    assert err < TOL, err
    # the params placed by the rule set give the same output, and a data
    # row's two cols agree
    np.testing.assert_array_equal(port[f"{name}/placed"], got)
    assert port[f"{name}/whole_cols_agree"]
    assert port[f"{name}/placed_cols_agree"]
    dense = _dense(inputs, name)
    if CASES[name]["capacity_factor"] >= 8:
        # no drops: the dense dispatch's output
        assert float(np.max(np.abs(got - dense))) < TOL
    else:
        # drops, on the reference's assignments: both differ from dense
        assert float(np.max(np.abs(want - dense))) > 1e-2
        assert float(np.max(np.abs(got - dense))) > 1e-2


def test_cap_and_availability_match_the_reference():
    import dataclasses
    from repro.configs.base import get_config as jget_config
    from repro.configs.base import reduced as jreduced
    from repro.launch.sharding import RuleSet as JRuleSet
    from repro.models import moe_sharded as jmoe_sharded
    for n, bins, cf in [(64, 4, 1.0), (64, 2, 8.0), (3, 5, 1.0),
                        (1000, 16, 1.25)]:
        assert moe_sharded._cap(n, bins, cf) == jmoe_sharded._cap(n, bins,
                                                                  cf)

    class Mesh:
        def __init__(self, names, shape):
            self.mesh_dim_names = self.axis_names = names
            self.shape = shape
            self.devices = type("Devices", (), {"shape": shape})()

    jcfg = jreduced(jget_config("llama4-scout-17b-a16e"))
    cfg = _torch_dist.moe_cfg("llama4-scout-17b-a16e", capacity_factor=1.0,
                              **MODES["row"])
    assert not moe_sharded.sharded_moe_available(cfg, None)
    seen = set()
    for names, shape in [(("data", "model"), (2, 2)),
                         (("data", "model"), (4, 2)),
                         (("data", "model"), (1, 4)),
                         (("pod", "data", "model"), (2, 2, 2)),
                         (("data",), (4,))]:
        mesh = Mesh(names, shape)
        for e in (2, 4, 8):
            for f in (31, 32):
                over = dict(num_experts=e, d_ff_expert=f)
                want = jmoe_sharded.sharded_moe_available(
                    dataclasses.replace(jcfg, **over), JRuleSet(mesh))
                got = moe_sharded.sharded_moe_available(
                    dataclasses.replace(cfg, **over), RuleSet(mesh))
                assert got is want, (names, shape, over)
                seen.add(want)
    assert seen == {True, False}


# ---------------------------------------------------------------------------
# with no rule set, apply_moe is the sorted dispatch it was, bit for bit


def _seed_apply_moe(cfg, p, x):
    """The dense dispatch as it stood before the expert-parallel path."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    dt = x.dtype
    xt = x.reshape(t, d)
    topw, topi = moe.route(cfg, p, xt)
    cap = moe.capacity(cfg, t)
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], topw.reshape(-1)[order]
    stok = torch.div(order, k, rounding_mode="floor")
    starts = torch.searchsorted(se, torch.arange(e, device=x.device))
    rank = torch.arange(t * k, device=x.device) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)
    xe = x.new_zeros((e * cap + 1, d))
    xe[slot] = xt[stok]
    xe = xe[:-1].view(e, cap, d)
    gate = torch.bmm(xe, p["w_gate"].to(dt))
    up = torch.bmm(xe, p["w_up"].to(dt))
    ye = torch.bmm(activation(cfg, gate) * up, p["w_down"].to(dt))
    ye_flat = torch.cat([ye.reshape(e * cap, d), x.new_zeros((1, d))])
    contrib = ye_flat[slot] * sw[:, None].to(dt) * keep[:, None].to(dt)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=x.device)
    out = contrib[inv].view(t, k, d).sum(dim=1)
    if cfg.num_shared_experts:
        sp = p["shared"]
        g = torch.matmul(xt, sp["w_gate"].to(dt))
        u = torch.matmul(xt, sp["w_up"].to(dt))
        out = out + torch.matmul(activation(cfg, g) * u, sp["w_down"].to(dt))
    return out.reshape(b, s, d)


@pytest.mark.parametrize("arch,dtype", [
    ("llama4-scout-17b-a16e", torch.float32),
    ("llama4-scout-17b-a16e", torch.bfloat16),
    ("deepseek-v3-671b", torch.float32),
    ("deepseek-v3-671b", torch.bfloat16)])
def test_apply_moe_without_rules_is_unchanged_bit_for_bit(arch, dtype):
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.common import init_tree
    cfg = reduced(get_config(arch))
    gen = torch.Generator().manual_seed(3)
    p = init_tree(moe.moe_descs(cfg), gen, dtype, "cpu")
    x = torch.randn(2, 24, cfg.d_model, generator=gen).to(dtype)
    got = moe.apply_moe(cfg, p, x)
    assert torch.equal(got, _seed_apply_moe(cfg, p, x))
    # a rule set whose mesh does not fit the experts keeps the dense path
    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (3, 1)
    with use_rules(RuleSet(Mesh())):
        assert torch.equal(moe.apply_moe(cfg, p, x), got)
    assert all(leaf.dtype == dtype for leaf in tree_leaves(p))


# ---------------------------------------------------------------------------
# the backward over DTensors


def _grad_err(got, want):
    """The largest difference of two gradients, relative to the larger of
    1 and the reference's largest entry."""
    return float(np.max(np.abs(got - want))) / max(
        1.0, float(np.max(np.abs(want))))


def _grad_names(port, name, run=""):
    prefix = f"{name}/grad{run}/"
    return sorted(k[len(prefix):] for k in port.files
                  if k.startswith(prefix) and k[len(prefix):] != "out")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_backward_matches_reference(outputs, name):
    """x's, the router's, every expert weight's and the shared expert's
    gradient within TOL (relative to the largest entry, at least 1) of
    the reference's ``jax.grad``; the forward over DTensors is the local
    path's output."""
    inputs, port, ref = outputs
    names = _grad_names(port, name)
    assert {"x", "router", "w_gate", "w_up", "w_down"} <= set(names)
    assert any(n.startswith("shared/") for n in names) == \
        bool(_torch_dist.moe_cfg(**CASES[name]).num_shared_experts)
    for n in names:
        got, want = port[f"{name}/grad/{n}"], ref[f"{name}/grad/{n}"]
        assert got.shape == want.shape, n
        assert _grad_err(got, want) < TOL, (n, _grad_err(got, want))
    assert float(np.max(np.abs(port[f"{name}/grad/out"]
                               - port[f"{name}/whole"]))) < TOL


def _dense_grads(inputs, name):
    cfg = _torch_dist.moe_cfg(**CASES[name])
    p = _torch_dist._moe_params(inputs, name)
    leaves = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                tree[k] = leaves[prefix + k] = v.clone().requires_grad_(True)

    walk(p)
    x = torch.from_numpy(inputs[f"{name}/x"]).requires_grad_(True)
    w = torch.from_numpy(inputs[f"{name}/w"])
    (moe._apply_moe(cfg, p, x) * w).sum().backward()
    return {"x": x.grad.numpy(),
            **{k: v.grad.numpy() for k, v in leaves.items()}}


@pytest.mark.parametrize("name", [n for n in sorted(CASES)
                                  if CASES[n]["capacity_factor"] >= 8])
def test_sharded_moe_backward_matches_dense_autograd(outputs, name):
    """Without drops, the port's dense dispatch differentiated by autograd
    gives the same gradients."""
    inputs, port, _ = outputs
    dense = _dense_grads(inputs, name)
    assert sorted(dense) == _grad_names(port, name)
    for n, want in dense.items():
        err = _grad_err(port[f"{name}/grad/{n}"], want)
        assert err < TOL, (n, err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_allreduce_backward_fails_the_check(outputs, name):
    """With the sum over ``model``'s backward an all-reduce (the trap: a
    col's part of the gradient scaled by ncols = 2), the check of
    ``test_sharded_moe_backward_matches_reference`` fails."""
    _, port, ref = outputs
    errs = {n: _grad_err(port[f"{name}/grad_allreduce_bwd/{n}"],
                         ref[f"{name}/grad/{n}"])
            for n in _grad_names(port, name, "_allreduce_bwd")}
    assert max(errs.values()) > 100 * TOL, errs


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_moe_two_runs_are_bit_identical(outputs, name):
    """The output and every gradient of two runs agree bit for bit: the
    combine un-sorts and sums each token's slots in top-k rank order, no
    scatter-add."""
    _, port, _ = outputs
    for n in _grad_names(port, name) + ["out"]:
        np.testing.assert_array_equal(port[f"{name}/grad/{n}"],
                                      port[f"{name}/grad_again/{n}"])

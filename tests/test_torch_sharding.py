"""The port's logical-axis rules (``repro_torch.launch.sharding``) against
the reference's (``repro.launch.sharding``): the reference's ``RuleSet``
cases, then every leaf of the train state (params, AdamW's and both
Adafactors' states), of the decode cache and of the batch of all ten
configs at full size on four mesh shapes planned without processes, and
the placements themselves: on 4 ``gloo`` ranks, each rank's shard of every
state leaf of two reduced configs against the reference's
``devices_indices_map`` on 4 host devices (one subprocess)."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_dist
from repro.checkpoint import serializer as jser
from repro.configs.base import get_config as jget_config
from repro.launch import sharding as jsharding
from repro.models.registry import build_model as jbuild_model
from repro.optim.adafactor import Adafactor as JAdafactor
from repro.optim.adamw import AdamW as JAdamW
from repro.runtime.train_step import state_logical_axes as jstate_axes
from repro_torch.checkpoint import serializer as ser
from repro_torch.configs.base import _load_all, _REGISTRY, get_config
from repro_torch.launch import sharding
from repro_torch.launch.sharding import (RuleSet, active_rules, constrain,
                                         use_rules)
from repro_torch.models import transformer
from repro_torch.models.common import map_tree
from repro_torch.models.registry import build_model
from repro_torch.optim.adafactor import Adafactor
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.train_step import state_logical_axes

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("deepseek-coder-33b", "deepseek-v3-671b", "gemma3-4b",
         "h2o-danube-1.8b", "llama-3.2-vision-90b", "llama4-scout-17b-a16e",
         "recurrentgemma-9b", "starcoder2-3b", "whisper-large-v3",
         "xlstm-350m")
# the mesh shapes of the parity check: a pod, two pods, the reference's
# test mesh, one device
MESHES = [(("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (4, 8)),
          (("data", "model"), (1, 1))]
# the decode cache and batch of the parity check (batch 8 does not divide
# a data axis of 16)
CACHE_BATCH, CACHE_SEQ = 8, 4096
# the two reduced configs whose placements are checked on 4 ranks
PLACED = ("llama4-scout-17b-a16e", "h2o-danube-1.8b")


class PortMesh:
    """A mesh planned without processes: names and shape only."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)


class RefMesh:
    """The reference's ``FakeMesh``."""

    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.devices = type("Devices", (), {"shape": tuple(shape)})()


def _both(names, shape, overrides=None):
    return (RuleSet(PortMesh(names, shape), overrides),
            jsharding.RuleSet(RefMesh(names, shape), overrides))


# ---------------------------------------------------------------------------
# the reference's RuleSet cases (tests/test_sharding.py)

DM, PDM = ("data", "model"), ("pod", "data", "model")
SPEC_CASES = {
    "basic_tp_fsdp": (DM, (4, 8), ("embed", "ffn"), (64, 128),
                      ("data", "model")),
    "divisibility_blocks": (DM, (4, 8), ("embed", "ffn"), (6, 128),
                            (None, "model")),
    "conflict_one_axis_once": (DM, (4, 8), ("ffn", "vocab"), (128, 256),
                               ("model", None)),
    "composite_experts": (DM, (4, 8), ("experts", None, None), (32, 7, 5),
                          (("data", "model"), None, None)),
    "experts_fallback_row": (DM, (4, 8), ("experts", "ffn"), (4, 64),
                             ("data", "model")),
    "batch_composite_pod": (PDM, (2, 4, 8), ("batch", None), (16, 5),
                            (("pod", "data"), None)),
    "batch_unshardable": (PDM, (2, 4, 8), ("batch", None), (1, 5),
                          (None, None)),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_matches_reference_case(case):
    names, mesh_shape, axes, shape, want = SPEC_CASES[case]
    port, ref = _both(names, mesh_shape)
    got = port.spec(axes, shape)
    assert got == tuple(ref.spec(axes, shape)) == want
    # without a shape (constraints): no divisibility check, as the
    # reference's
    assert port.spec(axes) == tuple(ref.spec(axes))


def test_overrides_replace_rules_as_the_reference():
    over = {"embed": (("model",),), "ffn": ()}
    port, ref = _both(DM, (4, 8), over)
    for axes in [("embed", "ffn"), ("ffn", "embed"), ("vocab", "embed")]:
        assert port.spec(axes, (64, 64)) == tuple(ref.spec(axes, (64, 64)))


def test_placements_of_a_spec():
    port = RuleSet(PortMesh(PDM, (2, 4, 8)))
    assert port.placements((("pod", "data"), None)) == \
        [Shard(0), Shard(0), Replicate()]
    assert port.placements((None, "model")) == \
        [Replicate(), Replicate(), Shard(1)]
    assert port.placements(("data", "model")) == \
        [Replicate(), Shard(0), Shard(1)]
    assert port.placements((None,)) == [Replicate()] * 3
    assert port.placements(()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        port.placements((("model", "data"),))


def test_constrain_without_rules_and_with_plain_tensors():
    x = torch.ones(4, 6)
    assert active_rules() is None
    assert constrain(x, ("batch", None)) is x
    rules = RuleSet(PortMesh(DM, (2, 2)))
    with use_rules(rules):
        assert active_rules() is rules
        with use_rules(None):
            assert active_rules() is None
        # a plain tensor is a rank's local value
        assert constrain(x, ("batch", None)) is x
    assert active_rules() is None


# ---------------------------------------------------------------------------
# every leaf of all ten configs at full size


def _port_state(cfg, opt):
    """The train state on the meta device: shapes, no storage."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    params = map_tree(lambda d: torch.empty(d.shape, device="meta",
                                            dtype=dt[cfg.param_dtype]),
                      transformer.model_descs(cfg))
    return params, opt.init(params)


def _ref_state(jcfg, jopt):
    from repro.models import transformer as jtransformer
    from repro.models.common import is_desc
    params = jax.tree.map(
        lambda d: jax.ShapeDtypeStruct(d.shape, jnp.dtype(jcfg.param_dtype)),
        jtransformer.model_descs(jcfg), is_leaf=is_desc)
    return params, jax.eval_shape(jopt.init, params)


def _port_specs(rules, axes_tree, tree):
    """{leaf path: spec} over ``tree``'s leaves (the checkpoint's paths)."""
    specs = sharding.zip_axes(
        lambda a, leaf: _Spec(rules.spec(a, tuple(leaf.shape))),
        axes_tree, tree)
    return {name: s.spec for name, s in ser.tree_paths(specs)}


class _Spec:
    """A spec as one leaf of a tree (a tuple would be walked into)."""

    def __init__(self, spec):
        self.spec = spec


def _ref_specs(rules, axes_tree, tree):
    """The reference's ``tree_shardings`` up to its ``NamedSharding`` (a
    planned mesh has no devices): its flatten, then ``spec`` a leaf."""
    is_axes = lambda x: isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)
    flat_axes, treedef = jax.tree.flatten(axes_tree, is_leaf=is_axes)
    flat_shapes = treedef.flatten_up_to(tree)
    names = [name for name, _ in jser.tree_paths(tree)]
    assert len(names) == len(flat_axes)
    return {name: tuple(rules.spec(a, s.shape))
            for name, a, s in zip(names, flat_axes, flat_shapes)}


def _optimizers(cfg):
    """(name, port optimizer, reference optimizer): AdamW in the config's
    state dtype, Adafactor with and without momentum."""
    sched = lambda step: 1e-3
    sd = "bfloat16" if cfg.grad_accum_dtype == "bfloat16" else "float32"
    return [("adamw", AdamW(lr=sched, state_dtype=sd),
             JAdamW(lr=sched, state_dtype=sd)),
            ("adafactor", Adafactor(lr=sched, momentum=0.9),
             JAdafactor(lr=sched, momentum=0.9)),
            ("adafactor_nomomentum", Adafactor(lr=sched),
             JAdafactor(lr=sched))]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_spec_matches_reference_at_full_size(arch):
    _load_all()
    assert sorted(_REGISTRY) == sorted(ARCHS)
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    trees = []                  # (what, port axes, port tree, ref axes, ref)
    for name, opt, jopt in _optimizers(cfg):
        axes = state_logical_axes(cfg, model, opt)
        jaxes = jstate_axes(jcfg, jmodel, jopt)
        params, opt_state = _port_state(cfg, opt)
        jparams, jopt_state = _ref_state(jcfg, jopt)
        trees.append((name, axes, {"params": params, "opt_state": opt_state},
                      {"params": jaxes.params, "opt_state": jaxes.opt_state},
                      {"params": jparams, "opt_state": jopt_state}))
    # the model's own param axes, as the dry-run reads them
    assert ser.tree_paths(model.param_axes()) == \
        jser.tree_paths(jmodel.param_axes())
    cache = model.init_cache(CACHE_BATCH, CACHE_SEQ, device="meta")
    jcache = jax.eval_shape(lambda: jmodel.init_cache(CACHE_BATCH,
                                                      CACHE_SEQ))
    trees.append(("cache", sharding.cache_axes(cfg, cache), cache,
                  jsharding.cache_axes(jcfg, jcache), jcache))
    batch = {"inputs": torch.empty(CACHE_BATCH, CACHE_SEQ, device="meta"),
             "labels": torch.empty(CACHE_BATCH, CACHE_SEQ, device="meta")}
    if cfg.encoder_seq:
        batch["enc_input"] = torch.empty(CACHE_BATCH, cfg.encoder_seq,
                                         cfg.encoder_dim, device="meta")
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
              for k, v in batch.items()}
    trees.append(("batch", sharding.batch_axes(batch), batch,
                  jsharding.batch_axes(jbatch), jbatch))

    n = 0
    for names, shape in MESHES:
        port, ref = _both(names, shape)
        for what, axes, tree, jaxes, jtree in trees:
            if what not in ("cache", "batch"):
                axes = {"params": axes.params, "opt_state": axes.opt_state}
            got = _port_specs(port, axes, tree)
            want = _ref_specs(ref, jaxes, jtree)
            assert list(got) == list(want), (what, shape)
            bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
            assert not bad, (what, shape, list(bad.items())[:4])
            n += len(got)
    assert n > 0


# ---------------------------------------------------------------------------
# placements on 4 gloo ranks against the reference's devices_indices_map

_REF_INDICES = """
    import json, sys
    import jax, numpy as np
    from repro.checkpoint import serializer as jser
    from repro.configs.base import get_config, reduced
    from repro.launch.mesh import make_host_mesh
    from repro.launch.sharding import RuleSet
    from repro.models.registry import build_model
    from repro.runtime.train_step import (TrainState, make_optimizer,
                                          state_logical_axes)

    mesh = make_host_mesh(data=2, model=2)
    rules = RuleSet(mesh)
    out = {}
    for arch in sys.argv[2:]:
        cfg = reduced(get_config(arch))
        model = build_model(cfg)
        opt = make_optimizer(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        state = TrainState(params, jax.eval_shape(opt.init, params))
        shardings = rules.tree_shardings(
            state_logical_axes(cfg, model, opt), state)
        leaves = {}
        for (name, sh), (_, leaf) in zip(jser.tree_paths(shardings),
                                         jser.tree_paths(state)):
            per = {}
            for dev, idx in sh.devices_indices_map(leaf.shape).items():
                coord = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
                offset = [s.start or 0 for s in idx]
                size = [(s.stop if s.stop is not None else n) - (s.start or 0)
                        for s, n in zip(idx, leaf.shape)]
                per[",".join(map(str, coord))] = {"offset": offset,
                                                  "shape": size}
            leaves[name] = per
        out[arch] = leaves
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
"""


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """({rank: the port's shards}, the reference's indices), computed at
    once: the reference in a subprocess on 4 host devices, the port on 4
    gloo ranks."""
    tmp = tmp_path_factory.mktemp("placements")
    ref_path = tmp / "reference.json"
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen([sys.executable, "-c",
                            textwrap.dedent(_REF_INDICES), str(ref_path),
                            *PLACED], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        _torch_dist.spawn(_torch_dist.placements_worker, 4, tmp, str(tmp),
                          PLACED)
    finally:
        _, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    ranks = [json.loads((tmp / f"placements{r}.json").read_text())
             for r in range(4)]
    return ranks, json.loads(ref_path.read_text())


@pytest.mark.parametrize("arch", PLACED)
def test_local_shards_match_reference_devices_indices_map(placed, arch):
    ranks, ref = placed
    assert sorted(tuple(r["coord"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    want = ref[arch]
    for r in ranks:
        got = r["archs"][arch]
        assert list(got) == list(want)
        key = ",".join(map(str, r["coord"]))
        for name, block in got.items():
            assert block == want[name][key], (name, key)
    # the check is not vacuous: some leaves are split over the ranks
    split = [name for name, per in want.items()
             if len({json.dumps(b) for b in per.values()}) > 1]
    assert split

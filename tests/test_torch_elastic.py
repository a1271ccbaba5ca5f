"""Elastic restore (``repro_torch.launch.elastic``), the counterpart of
``tests/test_elastic.py``: a train state placed on a (2, 2) mesh of 4
``gloo`` ranks is saved through the port's burst-buffer manager and
restored by ``elastic_restore`` onto ``degraded_mesh(4, 2, model_axis=2)``
(ranks 0 and 1; ranks 2 and 3 are the lost hosts), bit for bit, for an
AdamW state (reduced h2o-danube-1.8b) and an Adafactor one (reduced
deepseek-coder-33b); a checkpoint the reference's manager wrote restores
the same way. Then ``rebalance_domains`` against the reference's."""
import hashlib
import json

import jax
import numpy as np
import pytest

import _torch_dist
from _torch_buffer import STEADY_PING_S
from _hypothesis_compat import given, settings, st
from repro.checkpoint import serializer as jser
from repro.checkpoint.bbckpt import BBCheckpointManager as JManager
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import BBConfig as JBBConfig
from repro.core import BurstBufferSystem as JBurstBufferSystem
from repro.launch.elastic import rebalance_domains as jrebalance
from repro.models.registry import build_model as jbuild_model
from repro.runtime.train_step import init_train_state as jinit_train_state
from repro.runtime.train_step import make_optimizer as jmake_optimizer
from repro_torch.launch.elastic import rebalance_domains

# (arch, optimizer it trains with): AdamW, Adafactor
CASES = ("h2o-danube-1.8b", "deepseek-coder-33b")
# the reference's checkpoint: arch, step
REF_ARCH, REF_STEP = "h2o-danube-1.8b", 5


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    """The reports of ranks 0 and 1 (the degraded mesh's) and the
    reference checkpoint's leaf digests."""
    tmp = tmp_path_factory.mktemp("elastic")
    jcfg = jreduced(jget_config(REF_ARCH))
    jmodel, jopt = jbuild_model(jcfg), jmake_optimizer(jcfg)
    state = jinit_train_state(jcfg, jmodel, jopt, jax.random.PRNGKey(0))
    ck = {"params": state.params, "opt_state": state.opt_state}
    pfs = tmp / "reference_pfs"
    with JBurstBufferSystem(JBBConfig(num_servers=2, num_clients=2,
                                      dram_capacity=64 << 20,
                                      pfs_dir=str(pfs),
                                      stabilize_interval=STEADY_PING_S)
                            ) as bb:
        mgr = JManager(bb, quantize=False)
        mgr.save(REF_STEP, ck, blocking_flush=True)
        assert mgr.metrics[REF_STEP].get("flushed", True)
    digests = {name: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()
               for name, a in jser.tree_paths(jax.device_get(ck))}
    _torch_dist.spawn(_torch_dist.elastic_worker, 4, tmp, str(tmp), CASES,
                      (REF_ARCH, REF_STEP, str(pfs), digests))
    reports = [json.loads((tmp / f"elastic{r}.json").read_text())
               for r in range(4)]
    return reports, digests


def test_degraded_mesh_is_ranks_0_and_1(restored):
    reports, _ = restored
    assert [r["small_coord"] for r in reports] == \
        [[0, 0], [0, 1], None, None]


@pytest.mark.parametrize("arch", CASES)
def test_placed_checkpoint_is_the_plain_one_byte_for_byte(restored, arch):
    reports, _ = restored
    for r in reports:
        assert r["cases"][arch]["same_bytes"]
        assert r["cases"][arch]["flushed"]


@pytest.mark.parametrize("arch", CASES)
def test_elastic_restore_onto_smaller_mesh_is_bit_exact(restored, arch):
    reports, _ = restored
    for r in reports[:2]:
        case = r["cases"][arch]
        assert case["step"] == 3
        assert case["names"], arch
        assert case["bad_values"] == []
        assert case["bad_placements"] == []
        # every leaf lives on the degraded mesh of 2 devices
        assert case["mesh_sizes"] == [2]
        # and the restore did split leaves over it
        assert case["sharded"] > 0
    for r in reports[2:]:
        assert "step" not in r["cases"][arch]


def test_reference_checkpoint_restores_onto_smaller_mesh(restored):
    reports, digests = restored
    for r in reports[:2]:
        ref = r["reference"]
        assert ref["step"] == REF_STEP
        assert ref["names"] == list(digests)
        assert ref["bad_values"] == []
        assert ref["bad_placements"] == []
        assert ref["mesh_sizes"] == [2]
        assert ref["sharded"] > 0
    assert all("reference" not in r for r in reports[2:])


# ---------------------------------------------------------------------------
# rebalance_domains: the reference's two cases, then a property


def test_rebalance_domains_penalizes_stragglers():
    servers = ["s0", "s1", "s2", "s3"]
    tp = {"s0": 100.0, "s1": 100.0, "s2": 100.0, "s3": 10.0}   # s3 straggles
    weighted = rebalance_domains(tp, servers)
    assert weighted.count("s3") == 0          # below slack -> no domains
    assert weighted.count("s0") >= 1
    assert weighted == jrebalance(tp, servers)


def test_rebalance_domains_balanced_noop():
    servers = ["a", "b"]
    assert sorted(rebalance_domains({"a": 5.0, "b": 5.0}, servers)) == \
        ["a", "b"]
    assert rebalance_domains({}, servers) == jrebalance({}, servers)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(st.just(0.0), st.floats(1.0, 1e4), st.none()),
                min_size=1, max_size=8),
       st.floats(0.0, 2.0))
def test_rebalance_domains_matches_reference(throughputs, slack):
    """Flush throughputs (MB/s) of up to 8 servers, a stalled one at 0;
    servers with None report none (they take the median's weight)."""
    servers = [f"server/{i}" for i in range(len(throughputs))]
    tp = {s: t for s, t in zip(servers, throughputs) if t is not None}
    assert rebalance_domains(tp, servers, slack) == \
        jrebalance(tp, servers, slack)

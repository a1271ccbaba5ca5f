"""Elastic scaling + straggler mitigation hooks.

Counterpart of ``repro/launch/elastic.py``. Checkpoint-restart elasticity:
because burst-buffer checkpoints key shards by *logical tree path* (not
device), a job can restart on a different mesh (fewer hosts after
failures) and restore exactly — ``reshard_plan`` computes the new
placements and ``elastic_restore`` rebuilds the train state under them as
DTensors. Straggler mitigation happens at two levels:
  - ingest: the paper's overload-redirect (core/server.py) routes traffic
    away from slow/overloaded burst-buffer servers automatically;
  - flush: ``rebalance_domains`` reassigns PFS file domains away from
    servers whose recent flush throughput lags the ring median (work
    stealing at two-phase shuffle time).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sharding import RuleSet, place_tree


def degraded_mesh(total_hosts: int, lost_hosts: int, *,
                  model_axis: int = 16, device_type: str = "cuda"):
    """Largest (data, model) mesh that fits the surviving hosts, keeping the
    model axis intact (TP groups must stay whole; DP shrinks). Every rank
    of the world calls it; its ranks are the first of the world."""
    surviving = total_hosts - lost_hosts
    data = max(1, surviving // model_axis)
    return make_host_mesh(data=data, model=model_axis,
                          device_type=device_type)


def reshard_plan(cfg, model, optimizer, mesh) -> Tuple[RuleSet, object]:
    from repro_torch.runtime.train_step import state_logical_axes
    rules = RuleSet(mesh)
    axes = state_logical_axes(cfg, model, optimizer)
    return rules, axes


def elastic_restore(mgr, cfg, model, optimizer, mesh, target_state,
                    step: Optional[int] = None):
    """Restore a BB checkpoint onto a (possibly different) mesh: values are
    fetched by logical key through ``mgr.restore``, then each ``params`` /
    ``opt_state`` leaf is placed on ``mesh`` as a DTensor with the rule
    set's placements (scalar and zero-size leaves replicated). Called by
    the ranks of ``mesh`` only. Returns ({"params", "opt_state"}, step)."""
    rules, axes = reshard_plan(cfg, model, optimizer, mesh)
    restored, ck_step = mgr.restore(target_state, step)
    tree = {"params": restored["params"], "opt_state": restored["opt_state"]}
    del restored
    placed = place_tree(rules, {"params": axes.params,
                                "opt_state": axes.opt_state}, tree)
    return placed, ck_step


def rebalance_domains(flush_throughput: Dict[str, float],
                      servers: Sequence[str],
                      slack: float = 0.5) -> List[str]:
    """Weighted server order for domain assignment: servers slower than
    ``slack`` x median get proportionally fewer (possibly zero) domains.
    Returns a server list (with repetitions) to pass as the 'servers'
    argument of twophase.domains — slow servers own fewer bytes."""
    if not flush_throughput:
        return list(servers)
    med = float(np.median(list(flush_throughput.values()))) or 1.0
    weighted: List[str] = []
    for s in servers:
        w = flush_throughput.get(s, med) / med
        reps = max(0 if w < slack else 1, round(w))
        weighted.extend([s] * reps)
    return weighted or list(servers)

"""AdamW with dtype-configurable moments.

Counterpart of ``repro/optim/adamw.py``: the same update, bias correction
from the int32 step cast to f32, decoupled weight decay only on params of
ndim >= 2, and moments held in ``state_dtype``. The checkpoint leaves
``opt_state/.step``, ``opt_state/.m/...`` and ``opt_state/.v/...`` come
from ``AdamWState``. Pure functions: ``update`` returns new tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.launch.sharding import placed_like, replicate_like
from repro_torch.models.common import (DTYPES, map_tree, tree_leaves, unzip,
                                      zip_map)


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable                        # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        """Zero moments in ``state_dtype`` beside each param; an int32 step
        on the params' device."""
        dt = DTYPES[self.state_dtype]
        device = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=map_tree(zeros, params),
                          v=map_tree(zeros, params))

    def update(self, grads, state: AdamWState, params):
        """-> (new params, new state). Every product and sum in f32, in the
        reference's order."""
        step = state.step + 1
        lr = self.lr(step)
        b1, b2 = self.b1, self.b2
        t = step.float()
        c1 = 1.0 - torch.pow(replicate_like(
            torch.tensor(b1, device=t.device), t), t)
        c2 = 1.0 - torch.pow(replicate_like(
            torch.tensor(b2, device=t.device), t), t)
        dt = DTYPES[self.state_dtype]

        def upd(g, m, v, p):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf.square()
            mhat = m_new / c1
            vhat = v_new / c2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay and p.dim() >= 2:  # no decay on norms/bias
                delta = delta + self.weight_decay * p.float()
            p_new = p.float() - lr * delta
            return (placed_like(p_new.to(p.dtype), p),
                    placed_like(m_new.to(dt), m), placed_like(v_new.to(dt), v))

        p_new, m_new, v_new = unzip(zip_map(upd, grads, state.m, state.v,
                                            params), 3)
        return p_new, AdamWState(step=step, m=m_new, v=v_new)

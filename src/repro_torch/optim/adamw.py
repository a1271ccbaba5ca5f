"""AdamW state for the training-layout checkpoint.

Counterpart of ``repro/optim/adamw.py``'s ``AdamWState`` and ``AdamW.init``:
the checkpoint leaves ``opt_state/.step``, ``opt_state/.m/...`` and
``opt_state/.v/...`` come from this NamedTuple. The update rule comes with
the training path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.common import DTYPES, map_tree, tree_leaves


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

"""Model registry: per-arch model handles + analytic param counting.
Counterpart of ``repro/models/registry.py``."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import tree_leaves


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable                      # (seed, device="cuda") -> params
    param_axes: Callable                # () -> logical axes tree
    forward: Callable                   # (params, tokens, enc_input=None) -> logits
    init_cache: Callable                # (batch, max_seq, device, rules)
    decode_step: Callable               # (params, cache, tokens, pos, enc_input=None)
    prefill: Callable                   # (params, cache, tokens, enc_input=None)


def build_model(cfg) -> Model:
    transformer.model_descs(cfg)        # raises for kinds the port lacks

    def init(seed: int = 0, device="cuda"):
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return transformer.init_params(cfg, gen)

    return Model(
        cfg=cfg,
        init=init,
        param_axes=lambda: transformer.param_axes(cfg),
        forward=lambda params, tokens, enc_input=None: transformer.forward(
            cfg, params, tokens, enc_input),
        init_cache=lambda batch, max_seq, device="cuda", rules=None:
            transformer.init_cache(cfg, batch, max_seq,
                                   resolve_device(device), rules),
        decode_step=lambda params, cache, tokens, pos, enc_input=None:
            transformer.decode_step(cfg, params, cache, tokens, pos,
                                    enc_input),
        prefill=lambda params, cache, tokens, enc_input=None:
            transformer.prefill(cfg, params, cache, tokens, enc_input),
    )


def count_params(cfg, active_only: bool = False) -> int:
    """Analytic parameter count from the descriptor tree.

    active_only: count routed-expert params at the top_k/num_experts fraction
    (MoE "activated parameters")."""
    total = 0
    for d in tree_leaves(transformer.model_descs(cfg)):
        n = math.prod(d.shape)
        if active_only and "experts" in d.axes:
            n = int(n * cfg.top_k / max(cfg.num_experts, 1))
        total += n
    return total

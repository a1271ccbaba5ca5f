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
    forward: Callable                   # (params, tokens) -> logits
    init_cache: Callable                # (batch, max_seq, device="cuda") -> cache
    decode_step: Callable               # (params, cache, tokens, pos) -> (logits, cache)
    prefill: Callable                   # (params, cache, tokens) -> (logits, cache)


def build_model(cfg) -> Model:
    transformer.model_descs(cfg)        # raises for kinds the port lacks

    def init(seed: int = 0, device="cuda"):
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        return transformer.init_params(cfg, gen)

    return Model(
        cfg=cfg,
        init=init,
        forward=lambda params, tokens: transformer.forward(cfg, params,
                                                           tokens),
        init_cache=lambda batch, max_seq, device="cuda":
            transformer.init_cache(cfg, batch, max_seq,
                                   resolve_device(device)),
        decode_step=lambda params, cache, tokens, pos:
            transformer.decode_step(cfg, params, cache, tokens, pos),
        prefill=lambda params, cache, tokens:
            transformer.prefill(cfg, params, cache, tokens),
    )


def count_params(cfg) -> int:
    """Analytic parameter count from the descriptor tree."""
    return sum(math.prod(d.shape)
               for d in tree_leaves(transformer.model_descs(cfg)))

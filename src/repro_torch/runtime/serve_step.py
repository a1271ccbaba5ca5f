"""Serving steps: batched single-token decode + prefill.
Counterpart of ``repro/runtime/serve_step.py``."""
from __future__ import annotations

import torch

from repro_torch.models.common import padded_vocab


def make_decode_step(cfg, model):
    def decode_step(params, cache, tokens, pos):
        """tokens: (B,1) int; pos: int -> (logits (B,1,V), cache)."""
        return model.decode_step(params, cache, tokens, pos)
    return decode_step


def make_prefill(cfg, model):
    def prefill(params, cache, tokens, enc_input=None):
        return model.prefill(params, cache, tokens, enc_input)
    return prefill


def greedy_token(cfg, logits):
    """Mask vocab padding, take argmax. logits: (B,1,Vp) -> (B,1) int32."""
    v = cfg.vocab_size
    if padded_vocab(cfg) != v:
        logits = logits.clone()
        logits[..., v:] = -torch.inf
    return torch.argmax(logits, dim=-1).to(torch.int32)

"""Serving steps: batched single-token decode + prefill.
Counterpart of ``repro/runtime/serve_step.py``.

Given a rule set, ``make_prefill`` and ``make_decode_step`` are the sharded
serving entry points, the counterparts of ``launch/dryrun.py``'s jitted
``prefill_fn`` / ``decode_fn``: the step runs under ``use_rules(rules)``
on params placed by ``param_axes`` (``launch/sharding.py::place_tree``)
and a cache placed by ``cache_axes`` (``model.init_cache(..., rules=)``),
places plain tokens (and ``enc_input``) by ``batch_axes``, and returns the
logits and the cache in ``cache_axes``'s placements."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.launch import sharding
from repro_torch.models.common import padded_vocab


def _placed_inputs(rules, inputs):
    """``inputs`` (a dict of (B, ...) tensors; None entries dropped) placed
    by ``batch_axes`` when ``rules`` is given and they are plain."""
    inputs = {k: v for k, v in inputs.items() if v is not None}
    if rules is None:
        return inputs
    plain = {k: v for k, v in inputs.items() if not sharding.is_dtensor(v)}
    return {**inputs, **sharding.place_tree(
        rules, sharding.batch_axes(plain), plain)}


def _scope(rules):
    """``use_rules(rules)`` when given; else the caller's scope as it is."""
    return (contextlib.nullcontext() if rules is None
            else sharding.use_rules(rules))


def make_decode_step(cfg, model, rules=None):
    def decode_step(params, cache, tokens, pos):
        """tokens: (B,1) int; pos: int -> (logits (B,1,V), cache)."""
        tokens = _placed_inputs(rules, {"tokens": tokens})["tokens"]
        with _scope(rules):
            return model.decode_step(params, cache, tokens, pos)
    return decode_step


def make_prefill(cfg, model, rules=None):
    def prefill(params, cache, tokens, enc_input=None):
        inputs = _placed_inputs(rules, {"tokens": tokens,
                                        "enc_input": enc_input})
        with _scope(rules):
            return model.prefill(params, cache, inputs["tokens"],
                                 inputs.get("enc_input"))
    return prefill


def greedy_token(cfg, logits):
    """Mask vocab padding, take argmax. logits: (B,1,Vp) -> (B,1) int32.
    The mask is out of place (``torch.where``), as the reference's: a
    DTensor's logits keep their vocab split."""
    v = cfg.vocab_size
    vp = padded_vocab(cfg)
    if vp != v:
        keep = sharding.replicate_like(
            torch.arange(vp, device=logits.device) < v, logits)
        logits = torch.where(keep, logits, -torch.inf)
    return torch.argmax(logits, dim=-1).to(torch.int32)

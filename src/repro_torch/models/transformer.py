"""Decoder-only transformer built from stacked layer segments.

Counterpart of ``repro/models/transformer.py`` for the layer kinds ``attn``
and ``attn_local`` (global and sliding-window self-attention with a dense
MLP), ``moe``, ``moe_local`` and ``moe_nope`` (global, sliding-window and
NoPE global self-attention with a mixture-of-experts FFN), ``rglru`` (the
Griffin recurrent block with a dense MLP), and ``mlstm`` and ``slstm`` (the
xLSTM blocks). A model
= embedding -> [segments] -> final norm -> unembedding, where each segment
repeats a fixed ``unit`` of layer kinds; the reference scans over the
stacked layer dimension, the port loops over it in Python.

Caches are updated in place: ``prefill`` and ``decode_step`` write into the
cache tensors they are given and return the same cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (apply_norm, apply_rope,
                                       cfg_param_dtype, embed_descs,
                                       embed_tokens, init_tree, map_tree,
                                       norm_descs, stack_descs, unembed)
from repro_torch.models.mlp import apply_mlp, mlp_descs


@dataclasses.dataclass(frozen=True)
class Kind:
    descs: Callable            # (cfg) -> descriptor tree
    apply: Callable            # (cfg, p, x, ext) -> x
    init_cache: Callable       # (cfg, batch, max_seq, device) -> cache tree
    decode: Callable           # (cfg, p, x, cache, ext) -> (x, cache)
    prefill: Callable          # (cfg, p, x, cache, ext) -> (x, cache)


# ---------------------------------------------------------------------------
# attention kinds (self-attn + dense or MoE FFN)


def _make_attn_kind(*, window_attr=None, rope=True, local_theta=False,
                    ffn="dense"):
    def descs(cfg):
        d = {"norm1": norm_descs(cfg), "attn": attn.attn_descs(cfg),
             "norm2": norm_descs(cfg)}
        if ffn == "dense":
            d["mlp"] = mlp_descs(cfg)
        else:
            d["moe"] = moe_mod.moe_descs(cfg)
        return d

    def _window(cfg):
        return getattr(cfg, window_attr) if window_attr else 0

    def _theta(cfg):
        return cfg.rope_theta_local if local_theta else cfg.rope_theta

    def _acfg(cfg):
        # NoPE layers attend without rotary embeddings
        return cfg if rope else dataclasses.replace(cfg, pos_embed="none")

    def _ffn(cfg, p, x):
        h = apply_norm(cfg, p["norm2"], x)
        h = apply_mlp(cfg, p["mlp"], h) if ffn == "dense" \
            else moe_mod.apply_moe(cfg, p["moe"], h)
        return x + h

    def apply(cfg, p, x, ext):
        h = apply_norm(cfg, p["norm1"], x)
        h = attn.self_attention(_acfg(cfg), p["attn"], h, ext["positions"],
                                window=_window(cfg), rope_theta=_theta(cfg))
        return _ffn(cfg, p, x + h)

    def init_cache(cfg, batch, max_seq, device):
        return {"kv": attn.init_self_cache(cfg, batch, max_seq,
                                           window=_window(cfg),
                                           device=device)}

    def decode(cfg, p, x, cache, ext):
        h = apply_norm(cfg, p["norm1"], x)
        h, kv = attn.decode_self_attention(_acfg(cfg), p["attn"], h,
                                           cache["kv"], ext["pos"],
                                           window=_window(cfg),
                                           rope_theta=_theta(cfg))
        return _ffn(cfg, p, x + h), {"kv": kv}

    def prefill(cfg, p, x, cache, ext):
        h = apply_norm(cfg, p["norm1"], x)
        q, k, v = attn._project_qkv(cfg, p["attn"], h)
        if rope and cfg.pos_embed == "rope":
            q = apply_rope(q, ext["positions"], _theta(cfg))
            k = apply_rope(k, ext["positions"], _theta(cfg))
        o = kops.flash_attention(q, k, v, causal=True, window=_window(cfg),
                                 softcap=cfg.logit_softcap)
        x = _ffn(cfg, p, x + attn._out_proj(cfg, p["attn"], o))
        # write the (possibly windowed) tail of k/v into the ring cache
        kc, vc = cache["kv"]["k"], cache["kv"]["v"]
        buf, s = kc.shape[1], k.shape[1]
        if s >= buf:
            # ring alignment: slot of token t is t % buf
            shift = s % buf
            kc.copy_(torch.roll(k[:, -buf:], shift, dims=1))
            vc.copy_(torch.roll(v[:, -buf:], shift, dims=1))
        else:
            kc[:, :s] = k
            vc[:, :s] = v
        return x, cache

    return Kind(descs, apply, init_cache, decode, prefill)


# ---------------------------------------------------------------------------
# recurrent kind (RG-LRU block + dense FFN)


def _rglru_descs(cfg):
    return {"block": rglru_mod.rglru_descs(cfg), "norm2": norm_descs(cfg),
            "mlp": mlp_descs(cfg)}


def _rglru_apply(cfg, p, x, ext):
    x = rglru_mod.apply_rglru_block(cfg, p["block"], x)
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h)


def _rglru_cache(cfg, batch, max_seq, device):
    return {"rec": rglru_mod.init_rglru_cache(cfg, batch, device)}


def _rglru_decode(cfg, p, x, cache, ext):
    x, c = rglru_mod.decode_rglru_block(cfg, p["block"], x, cache["rec"])
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h), {"rec": c}


# prefill runs the decode block over the whole prompt (from the zero state
# of a fresh cache) to obtain the final state, as the reference does
_rglru_prefill = _rglru_decode


# ---------------------------------------------------------------------------
# xLSTM kinds (the blocks carry their own FFN or none)


def _mlstm_cache(cfg, batch, max_seq, device):
    return {"rec": xlstm_mod.init_mlstm_cache(cfg, batch, device)}


def _mlstm_decode(cfg, p, x, cache, ext):
    x, _ = xlstm_mod.decode_mlstm_block(cfg, p, x, cache["rec"])
    return x, cache


def _slstm_cache(cfg, batch, max_seq, device):
    return xlstm_mod.init_slstm_cache(cfg, batch, device)


def _slstm_decode(cfg, p, x, cache, ext):
    return xlstm_mod.decode_slstm_block(cfg, p, x, cache)


KINDS: Dict[str, Kind] = {
    "attn": _make_attn_kind(),
    "attn_local": _make_attn_kind(window_attr="window_size", local_theta=True),
    "moe": _make_attn_kind(ffn="moe"),
    # llama4's chunked local layers use the global rope_theta
    "moe_local": _make_attn_kind(window_attr="window_size", ffn="moe"),
    "moe_nope": _make_attn_kind(rope=False, ffn="moe"),
    "rglru": Kind(_rglru_descs, _rglru_apply, _rglru_cache, _rglru_decode,
                  _rglru_prefill),
    # prefill runs the decode block over the whole prompt, as for rglru
    "mlstm": Kind(xlstm_mod.mlstm_descs,
                  lambda cfg, p, x, ext: xlstm_mod.apply_mlstm_block(cfg, p,
                                                                     x),
                  _mlstm_cache, _mlstm_decode, _mlstm_decode),
    "slstm": Kind(xlstm_mod.slstm_descs,
                  lambda cfg, p, x, ext: xlstm_mod.apply_slstm_block(cfg, p,
                                                                     x),
                  _slstm_cache, _slstm_decode, _slstm_decode),
}


# ---------------------------------------------------------------------------
# model assembly


def model_descs(cfg):
    kinds = {k for unit, _ in cfg.segments for k in unit}
    if kinds - set(KINDS) or cfg.mtp_depth or cfg.num_encoder_layers \
            or cfg.cross_source:
        raise NotImplementedError(
            f"{cfg.name}: the port builds layer kinds {sorted(KINDS)} "
            f"without MTP or encoders; config has {sorted(kinds)}")
    d: Dict[str, Any] = {"embed": embed_descs(cfg), "segments": {}}
    for i, (unit, reps) in enumerate(cfg.segments):
        seg = {str(j): KINDS[k].descs(cfg) for j, k in enumerate(unit)}
        d["segments"][f"seg{i}"] = stack_descs(seg, reps)
    d["final_norm"] = norm_descs(cfg)
    return d


def init_params(cfg, gen: torch.Generator):
    """Random params on ``gen``'s device, drawn from ``gen``."""
    return init_tree(model_descs(cfg), gen, cfg_param_dtype(cfg), gen.device)


def _layer(tree, r: int):
    """Layer ``r`` of a stacked segment tree (views, no copies)."""
    return map_tree(lambda a: a[r], tree)


def _positions(b: int, s: int, start: int, device):
    return torch.arange(start, start + s, dtype=torch.int32,
                        device=device).expand(b, s)


def forward(cfg, params, tokens):
    """Training / scoring forward. tokens: (B, S) -> logits (B, S, V)."""
    b, s = tokens.shape
    ext = {"positions": _positions(b, s, 0, tokens.device)}
    x = embed_tokens(cfg, params["embed"], tokens, ext["positions"])
    for i, (unit, reps) in enumerate(cfg.segments):
        seg_params = params["segments"][f"seg{i}"]
        for r in range(reps):
            p_layer = _layer(seg_params, r)
            for j, kname in enumerate(unit):
                x = KINDS[kname].apply(cfg, p_layer[str(j)], x, ext)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], x)


def init_cache(cfg, batch: int, max_seq: int, device="cuda"):
    cache: Dict[str, Any] = {}
    for i, (unit, reps) in enumerate(cfg.segments):
        seg = {str(j): KINDS[k].init_cache(cfg, batch, max_seq, device)
               for j, k in enumerate(unit)}
        cache[f"seg{i}"] = map_tree(
            lambda a: a.expand((reps,) + a.shape).clone(), seg)
    return cache


def _run_cached(cfg, params, cache, x, ext, method: str):
    for i, (unit, reps) in enumerate(cfg.segments):
        seg_params = params["segments"][f"seg{i}"]
        seg_cache = cache[f"seg{i}"]
        for r in range(reps):
            p_layer, c_layer = _layer(seg_params, r), _layer(seg_cache, r)
            for j, kname in enumerate(unit):
                x, _ = getattr(KINDS[kname], method)(
                    cfg, p_layer[str(j)], x, c_layer[str(j)], ext)
    return x


def decode_step(cfg, params, cache, tokens, pos: int):
    """One-token decode. tokens: (B, 1); pos = tokens already cached.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    b = tokens.shape[0]
    ext = {"positions": _positions(b, 1, pos, tokens.device), "pos": pos}
    x = embed_tokens(cfg, params["embed"], tokens, ext["positions"])
    x = _run_cached(cfg, params, cache, x, ext, "decode")
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], x), cache


def prefill(cfg, params, cache, tokens):
    """Fill caches for tokens[0..S) in place; returns last-position logits
    (B, 1, V) and the cache."""
    b, s = tokens.shape
    ext = {"positions": _positions(b, s, 0, tokens.device)}
    x = embed_tokens(cfg, params["embed"], tokens, ext["positions"])
    x = _run_cached(cfg, params, cache, x, ext, "prefill")
    x = apply_norm(cfg, params["final_norm"], x[:, -1:])
    return unembed(cfg, params["embed"], x), cache

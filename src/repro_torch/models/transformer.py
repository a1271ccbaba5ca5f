"""Multi-family transformer built from stacked layer segments.

Counterpart of ``repro/models/transformer.py`` for the layer kinds ``attn``
and ``attn_local`` (global and sliding-window self-attention with a dense
MLP), ``moe``, ``moe_local`` and ``moe_nope`` (global, sliding-window and
NoPE global self-attention with a mixture-of-experts FFN), ``mla_dense``
and ``mla_moe`` (DeepSeek-V3's multi-head latent attention with a dense or
MoE FFN), ``rglru`` (the Griffin recurrent block with a dense MLP),
``mlstm`` and ``slstm`` (the xLSTM blocks), ``cross`` (self-attention,
cross-attention to encoder or vision states and a dense MLP: whisper's
decoder, llama-3.2-vision's cross layers) and ``enc`` (bidirectional
self-attention with a dense MLP: whisper's encoder). A model
= embedding -> [segments] -> final norm -> unembedding, where each segment
repeats a fixed ``unit`` of layer kinds; the reference scans over the
stacked layer dimension, the port loops over it in Python. A config with
an encoder (``num_encoder_layers``) also carries ``enc_proj``, the stacked
``encoder`` and ``enc_final_norm``; a vision config (``cross_source``
without an encoder) only ``enc_proj``: ``_encode`` turns the stub
frontend's ``enc_input`` into the context the cross layers attend to. A
config with ``mtp_depth`` also carries DeepSeek-V3's
multi-token-prediction module (``mtp``) in its tree, as the reference's
does; only ``forward_with_mtp`` (training) reads it, so serving never
touches it.

Caches are updated in place: ``prefill`` and ``decode_step`` write into the
cache tensors they are given and return the same cache. Under a rule set
(``launch/sharding.py::use_rules``) they take params placed by
``param_axes`` and a cache placed by ``cache_axes`` as DTensors (the
reference's ``in_shardings`` in ``launch/dryrun.py``): each write goes into
a rank's own block of the cache (``sharding.write_slice``), and the cache
comes back in ``cache_axes``'s placements (its ``out_shardings``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch import sharding
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (P, apply_norm, apply_rope, cfg_dtype,
                                       cfg_param_dtype, embed_descs,
                                       embed_tokens, init_tree, map_tree,
                                       norm_descs, sincos_positions,
                                       stack_descs, tree_leaves, unembed)
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


def _ffn_descs(cfg, attn_descs, ffn):
    d = {"norm1": norm_descs(cfg), "attn": attn_descs,
         "norm2": norm_descs(cfg)}
    if ffn == "dense":
        d["mlp"] = mlp_descs(cfg)
    else:
        d["moe"] = moe_mod.moe_descs(cfg)
    return d


def _ffn(cfg, p, x, ffn):
    """The residual FFN half of a block: x + FFN(norm2(x))."""
    h = apply_norm(cfg, p["norm2"], x)
    h = apply_mlp(cfg, p["mlp"], h) if ffn == "dense" \
        else moe_mod.apply_moe(cfg, p["moe"], h)
    return x + h


def _make_attn_kind(*, window_attr=None, rope=True, local_theta=False,
                    ffn="dense", causal=True):
    def descs(cfg):
        return _ffn_descs(cfg, attn.attn_descs(cfg), ffn)

    def _window(cfg):
        return getattr(cfg, window_attr) if window_attr else 0

    def _theta(cfg):
        return cfg.rope_theta_local if local_theta else cfg.rope_theta

    def _acfg(cfg):
        # NoPE layers attend without rotary embeddings
        return cfg if rope else dataclasses.replace(cfg, pos_embed="none")

    def apply(cfg, p, x, ext):
        h = apply_norm(cfg, p["norm1"], x)
        h = attn.self_attention(_acfg(cfg), p["attn"], h, ext["positions"],
                                window=_window(cfg), causal=causal,
                                rope_theta=_theta(cfg))
        return _ffn(cfg, p, x + h, ffn)

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
        return _ffn(cfg, p, x + h, ffn), {"kv": kv}

    def prefill(cfg, p, x, cache, ext):
        h = apply_norm(cfg, p["norm1"], x)
        q, k, v = attn._project_qkv(cfg, p["attn"], h)
        if rope and cfg.pos_embed == "rope":
            q = apply_rope(q, ext["positions"], _theta(cfg))
            k = apply_rope(k, ext["positions"], _theta(cfg))
        if attn._cp_eligible(cfg, q.shape[1]):
            q = sharding.constrain(q, ("batch", "seq", None, None))
        o = kops.flash_attention(q, k, v, causal=causal,
                                 window=_window(cfg),
                                 softcap=cfg.logit_softcap)
        x = _ffn(cfg, p, x + attn._out_proj(cfg, p["attn"], o), ffn)
        # write the (possibly windowed) tail of k/v into the ring cache
        buf, s = cache["kv"]["k"].shape[1], k.shape[1]
        for c, t in ((cache["kv"]["k"], k), (cache["kv"]["v"], v)):
            if s >= buf:
                # ring alignment: slot of token t is t % buf, so the tail's
                # last ``shift`` tokens wrap round to slots 0 .. shift - 1
                shift, tail = s % buf, t[:, s - buf:]
                sharding.write_slice(c, tail[:, buf - shift:], 1, 0)
                sharding.write_slice(c, tail[:, :buf - shift], 1, shift)
            else:
                sharding.write_slice(c, t, 1, 0)
        return x, cache

    return Kind(descs, apply, init_cache, decode, prefill)


# ---------------------------------------------------------------------------
# MLA kinds (multi-head latent attention + dense or MoE FFN)


def _make_mla_kind(ffn):
    def descs(cfg):
        return _ffn_descs(cfg, mla_mod.mla_descs(cfg), ffn)

    def apply(cfg, p, x, ext):
        h = apply_norm(cfg, p["norm1"], x)
        h = mla_mod.mla_attention(cfg, p["attn"], h, ext["positions"])
        return _ffn(cfg, p, x + h, ffn)

    def init_cache(cfg, batch, max_seq, device):
        return {"mla": mla_mod.init_mla_cache(cfg, batch, max_seq, device)}

    def decode(cfg, p, x, cache, ext):
        h = apply_norm(cfg, p["norm1"], x)
        h, _ = mla_mod.decode_mla_attention(cfg, p["attn"], h, cache["mla"],
                                            ext["pos"])
        return _ffn(cfg, p, x + h, ffn), cache

    def prefill(cfg, p, x, cache, ext):
        h = apply_norm(cfg, p["norm1"], x)
        h, c_kv, k_rope = mla_mod.mla_attend(cfg, p["attn"], h,
                                             ext["positions"])
        x = _ffn(cfg, p, x + h, ffn)
        # the latent cache from position 0
        sharding.write_slice(cache["mla"]["c_kv"], c_kv, 1, 0)
        sharding.write_slice(cache["mla"]["k_rope"], k_rope, 1, 0)
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


# ---------------------------------------------------------------------------
# cross-attention kind (vision layers / whisper decoder)


def _cross_descs(cfg):
    return {"norm1": norm_descs(cfg), "attn": attn.attn_descs(cfg),
            "norm_c": norm_descs(cfg), "xattn": attn.attn_descs(cfg),
            "norm2": norm_descs(cfg), "mlp": mlp_descs(cfg)}


def _cross_apply(cfg, p, x, ext):
    h = apply_norm(cfg, p["norm1"], x)
    x = x + attn.self_attention(cfg, p["attn"], h, ext["positions"])
    h = apply_norm(cfg, p["norm_c"], x)
    x = x + attn.cross_attention(cfg, p["xattn"], h, ext["ctx"])
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h)


def _cross_cache(cfg, batch, max_seq, device):
    return {"kv": attn.init_self_cache(cfg, batch, max_seq, device=device),
            "xkv": attn.init_cross_cache(cfg, batch, max(cfg.encoder_seq, 1),
                                         device=device)}


def _cross_decode(cfg, p, x, cache, ext):
    h = apply_norm(cfg, p["norm1"], x)
    h, _ = attn.decode_self_attention(cfg, p["attn"], h, cache["kv"],
                                      ext["pos"])
    x = x + h
    h = apply_norm(cfg, p["norm_c"], x)
    x = x + attn.decode_cross_attention(cfg, p["xattn"], h, cache["xkv"])
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h), cache


def _cross_prefill(cfg, p, x, cache, ext):
    """Causal self-attention over the prompt (its K / V into the self cache
    from position 0), then cross-attention over the context, whose K / V
    fill the cross cache that every decode step reads."""
    h = apply_norm(cfg, p["norm1"], x)
    q, k, v = attn._project_qkv(cfg, p["attn"], h)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, ext["positions"], cfg.rope_theta)
        k = apply_rope(k, ext["positions"], cfg.rope_theta)
    if attn._cp_eligible(cfg, q.shape[1]):
        q = sharding.constrain(q, ("batch", "seq", None, None))
    o = kops.flash_attention(q, k, v, causal=True)
    x = x + attn._out_proj(cfg, p["attn"], o)
    xk, xv = attn.prefill_cross_cache(cfg, p["xattn"], ext["ctx"])
    for c, t in ((cache["kv"]["k"], k), (cache["kv"]["v"], v),
                 (cache["xkv"]["k"], xk), (cache["xkv"]["v"], xv)):
        sharding.write_slice(c, t, 1, 0)
    h = apply_norm(cfg, p["norm_c"], x)
    x = x + attn.cross_attend(cfg, p["xattn"], h, xk, xv)
    h = apply_norm(cfg, p["norm2"], x)
    return x + apply_mlp(cfg, p["mlp"], h), cache


KINDS: Dict[str, Kind] = {
    "attn": _make_attn_kind(),
    "attn_local": _make_attn_kind(window_attr="window_size", local_theta=True),
    "moe": _make_attn_kind(ffn="moe"),
    # llama4's chunked local layers use the global rope_theta
    "moe_local": _make_attn_kind(window_attr="window_size", ffn="moe"),
    "moe_nope": _make_attn_kind(rope=False, ffn="moe"),
    "mla_dense": _make_mla_kind("dense"),
    "mla_moe": _make_mla_kind("moe"),
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
    "cross": Kind(_cross_descs, _cross_apply, _cross_cache, _cross_decode,
                  _cross_prefill),
    "enc": _make_attn_kind(causal=False),
}


# ---------------------------------------------------------------------------
# model assembly


def model_descs(cfg):
    kinds = {k for unit, _ in cfg.segments for k in unit}
    if kinds - set(KINDS):
        raise NotImplementedError(
            f"{cfg.name}: the port builds layer kinds {sorted(KINDS)}; "
            f"config has {sorted(kinds)}")
    d: Dict[str, Any] = {"embed": embed_descs(cfg), "segments": {}}
    for i, (unit, reps) in enumerate(cfg.segments):
        seg = {str(j): KINDS[k].descs(cfg) for j, k in enumerate(unit)}
        d["segments"][f"seg{i}"] = stack_descs(seg, reps)
    d["final_norm"] = norm_descs(cfg)
    if cfg.mtp_depth:
        # DeepSeek-V3's multi-token-prediction module (depth 1): one more
        # layer of the trunk's last kind, fed by a projection of
        # [norm(h_t) ; norm(emb(t+1))]; shares the embedding / unembedding
        last_kind = cfg.segments[-1][0][-1]
        d["mtp"] = {
            "h_norm": norm_descs(cfg),
            "e_norm": norm_descs(cfg),
            "proj": P((2 * cfg.d_model, cfg.d_model), (None, "embed"),
                      "fanin"),
            "layer": stack_descs({"0": KINDS[last_kind].descs(cfg)}, 1),
            "final_norm": norm_descs(cfg),
        }
    if cfg.num_encoder_layers or cfg.cross_source:
        d["enc_proj"] = P((cfg.encoder_dim, cfg.d_model),
                          ("enc_dim", "embed"), "fanin")
    if cfg.num_encoder_layers:
        d["encoder"] = stack_descs({"0": KINDS["enc"].descs(cfg)},
                                   cfg.num_encoder_layers)
        d["enc_final_norm"] = norm_descs(cfg)
    return d


def init_params(cfg, gen: torch.Generator):
    """Random params on ``gen``'s device, drawn from ``gen``."""
    return init_tree(model_descs(cfg), gen, cfg_param_dtype(cfg), gen.device)


def param_axes(cfg):
    """The params' tree with each leaf's logical axes (a tuple of names)."""
    return map_tree(lambda d: d.axes, model_descs(cfg))


def _layer(tree, r: int):
    """Layer ``r`` of a stacked segment tree (views, no copies)."""
    return map_tree(lambda a: a[r], tree)


def _positions(like, s: int, start: int):
    """Positions start .. start+s-1 for every row of ``like`` (B, ...): a
    DTensor in the batch's placement when ``like`` is one."""
    pos = torch.arange(start, start + s, dtype=torch.int32,
                       device=like.device).expand(like.shape[0], s)
    return sharding.batch_like(pos, like)


def _encode(cfg, params, enc_input):
    """enc_input: (B, S_enc, encoder_dim) stub frontend output ->
    (B, S_enc, d): the projection in the compute dtype, then (whisper) the
    sincos table rounded to that dtype, the encoder stack and its final
    norm."""
    dt = cfg_dtype(cfg)
    x = torch.matmul(enc_input.to(dt), params["enc_proj"].to(dt))
    if not cfg.num_encoder_layers:
        return x
    s = x.shape[1]
    table = sharding.replicate_like(
        torch.tensor(sincos_positions(s, cfg.d_model), device=x.device), x)
    x = x + table.to(x.dtype)[None]
    ext = {"positions": _positions(x, s, 0), "ctx": None}
    for r in range(cfg.num_encoder_layers):
        x = KINDS["enc"].apply(cfg, _layer(params["encoder"], r)["0"], x,
                               ext)
    return apply_norm(cfg, params["enc_final_norm"], x)


def _ext(cfg, params, positions, enc_input):
    ctx = _encode(cfg, params, enc_input) if enc_input is not None else None
    return {"positions": positions, "ctx": ctx}


def _trunk(cfg, params, tokens, enc_input):
    """The embedding and every segment's layers over tokens (B, S): the
    residual stream (B, S, d) before the final norm, and the layers' ext
    (positions 0 .. S-1, the encoded context)."""
    ext = _ext(cfg, params, _positions(tokens, tokens.shape[1], 0),
               enc_input)
    x = embed_tokens(cfg, params["embed"], tokens, ext["positions"])
    x = sharding.constrain(x, ("batch", None, None))
    for i, (unit, reps) in enumerate(cfg.segments):
        seg_params = params["segments"][f"seg{i}"]
        for r in range(reps):
            p_layer = _layer(seg_params, r)
            for j, kname in enumerate(unit):
                x = KINDS[kname].apply(cfg, p_layer[str(j)], x, ext)
            # the reference's constraint on each scan step's carry
            x = sharding.constrain(x, ("batch", None, None))
    return x, ext


def forward(cfg, params, tokens, enc_input=None):
    """Training / scoring forward. tokens: (B, S) -> logits (B, S, V).
    enc_input: (B, S_enc, encoder_dim) for configs with cross layers."""
    x, _ = _trunk(cfg, params, tokens, enc_input)
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], x)


def forward_with_mtp(cfg, params, tokens, enc_input=None):
    """Training forward with DeepSeek-V3's MTP head (depth 1): (logits
    (B, S, V) over positions 0 .. S-1, predicting token t+1; mtp_logits
    (B, S-1, V) over positions 0 .. S-2, predicting token t+2 from the
    trunk's h_t and the embedding of token t+1), as the reference's."""
    h_final, ext = _trunk(cfg, params, tokens, enc_input)
    logits = unembed(cfg, params["embed"],
                     apply_norm(cfg, params["final_norm"], h_final))
    mp = params["mtp"]
    positions = ext["positions"][:, 1:]
    h = apply_norm(cfg, mp["h_norm"], h_final[:, :-1])
    e = apply_norm(cfg, mp["e_norm"], embed_tokens(
        cfg, params["embed"], tokens[:, 1:], positions))
    hm = sharding.constrain(_mtp_project(h, e, mp["proj"]),
                            ("batch", None, None))
    # one more layer of the trunk's last kind, at positions 1 .. S-1
    last_kind = cfg.segments[-1][0][-1]
    hm = KINDS[last_kind].apply(cfg, _layer(mp["layer"], 0)["0"], hm,
                                {"positions": positions, "ctx": ext["ctx"]})
    mtp_logits = unembed(cfg, params["embed"],
                         apply_norm(cfg, mp["final_norm"], hm))
    return logits, mtp_logits


def _mtp_project(h, e, proj):
    """[h ; e] (B, S, 2d) @ proj (2d, d). On DTensors each rank projects its
    rows in plain torch (``kops.shard_map``, proj whole): DTensor's own
    concatenation along the features gave the gradient a placement that
    the embedding's backward could not take (torch 2.11)."""
    if sharding.is_dtensor(h):
        rows = ("batch", None, None)
        return kops.shard_map(
            lambda a, b, w: (_mtp_project(a, b, w),), (h, e, proj),
            (rows, rows, (None, None)), [(rows, tuple(h.shape))],
            partial_grads=[(2, a) for a in
                           sharding.batch_mesh_axes(h.shape)])[0]
    hcat = torch.cat([h, e], dim=-1)
    return torch.matmul(hcat, proj.to(hcat.dtype))


def init_cache(cfg, batch: int, max_seq: int, device="cuda", rules=None):
    """The decode cache of every layer, fresh (zeros; the xLSTM layers'
    stabilizers m at NEG_INF), stacked by segment. With a
    rule set, DTensors placed by ``cache_axes`` on its mesh (``device`` is
    then the mesh's), each rank allocating only its own block."""
    if rules is not None:
        shapes = init_cache(cfg, batch, max_seq, "meta")
        # every leaf of a fresh cache holds one value: zeros, or NEG_INF
        # (the mLSTM's and the sLSTM's stabilizer m)
        values = map_tree(_fill_value, init_cache(cfg, 1, 1, "cpu"))
        return sharding.full_tree(rules, sharding.cache_axes(cfg, shapes),
                                  shapes, values)
    cache: Dict[str, Any] = {}
    for i, (unit, reps) in enumerate(cfg.segments):
        seg = {str(j): KINDS[k].init_cache(cfg, batch, max_seq, device)
               for j, k in enumerate(unit)}
        cache[f"seg{i}"] = map_tree(
            lambda a: a.expand((reps,) + a.shape).clone(), seg)
    return cache


def _fill_value(leaf):
    """The one value a fresh cache leaf holds."""
    value = leaf.reshape(-1)[0]
    if not bool((leaf == value).all()):
        raise ValueError("a fresh cache leaf holds more than one value")
    return value.item()


def _placed_cache(cfg, cache):
    """The cache as a serving step returns it: under a rule set, a DTensor
    cache in ``cache_axes``'s placements (the reference's
    ``out_shardings``; the in-place writes keep them, so this moves
    nothing unless a caller placed it otherwise); else as it is."""
    rules = sharding.active_rules()
    if rules is None or not any(sharding.is_dtensor(a)
                                for a in tree_leaves(cache)):
        return cache
    return sharding.place_tree(rules, sharding.cache_axes(cfg, cache), cache)


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


def decode_step(cfg, params, cache, tokens, pos: int, enc_input=None):
    """One-token decode. tokens: (B, 1); pos = tokens already cached.
    Returns (logits (B, 1, V), cache), the cache updated in place.

    Cross layers read the context's K / V from the cache that ``prefill``
    filled, so decode encodes nothing: ``enc_input`` is taken for the
    reference's signature, whose decode encodes it and leaves the result
    unread."""
    ext = {"positions": _positions(tokens, 1, pos), "pos": pos}
    x = embed_tokens(cfg, params["embed"], tokens, ext["positions"])
    x = _run_cached(cfg, params, cache, x, ext, "decode")
    x = apply_norm(cfg, params["final_norm"], x)
    return unembed(cfg, params["embed"], x), _placed_cache(cfg, cache)


def prefill(cfg, params, cache, tokens, enc_input=None):
    """Fill caches for tokens[0..S) in place (cross layers: the context
    encoded from ``enc_input`` into their K / V cache); returns
    last-position logits (B, 1, V) and the cache."""
    ext = _ext(cfg, params, _positions(tokens, tokens.shape[1], 0),
               enc_input)
    x = embed_tokens(cfg, params["embed"], tokens, ext["positions"])
    x = _run_cached(cfg, params, cache, x, ext, "prefill")
    x = apply_norm(cfg, params["final_norm"], x[:, -1:])
    return unembed(cfg, params["embed"], x), _placed_cache(cfg, cache)

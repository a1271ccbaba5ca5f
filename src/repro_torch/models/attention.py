"""Attention: GQA/MQA/MHA self-attention (global / sliding-window),
cross-attention.

Counterpart of ``repro/models/attention.py``, with its context-parallel
constraint on q (``_cp_eligible``) under an active rule set. Training/prefill
runs the fused
flash-attention op from ``repro_torch.kernels.ops`` (the CUDA kernel on the
card, the chunked online softmax on the CPU); cross-attention runs it
non-causally over the encoder / vision states. Decode attends one query
token against a fixed-size ring-buffer KV cache (self-attention) or the
context's K / V cache (cross-attention) in plain PyTorch, as the reference
does in plain jnp.

Unlike the reference, whose caches are immutable arrays (donated to the
jitted decode step), the port writes the new token's K/V into the cache
tensors in place. Under a rule set the caches are DTensors split by
``launch/sharding.py::cache_axes`` (the sequence over the model axis):
each rank writes only its own block (``sharding.write_slice``), and the
attention over the cache gathers K / V along the sequence
(``_cache_attend``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch import sharding
from repro_torch.models.common import P, apply_rope, cfg_dtype

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# parameter descriptors


def attn_descs(cfg):
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    return {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim"), "fanin"),
        "wk": P((d, kv, hd), ("embed", "kv_heads", "head_dim"), "fanin"),
        "wv": P((d, kv, hd), ("embed", "kv_heads", "head_dim"), "fanin"),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed"), "fanin"),
    }


# ---------------------------------------------------------------------------
# projections


def _proj(x, w):
    """x: (B, S, d) @ w: (d, heads, hd) -> (B, S, heads, hd), contiguous."""
    d, heads, hd = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, heads * hd)).view(
        *x.shape[:-1], heads, hd)


def _project_qkv(cfg, p, x, ctx=None):
    """q from x; k/v from ctx (cross) or x (self)."""
    src = x if ctx is None else ctx
    return _proj(x, p["wq"]), _proj(src, p["wk"]), _proj(src, p["wv"])


def _out_proj(cfg, p, o):
    h, hd, d = p["wo"].shape
    return torch.matmul(o.reshape(*o.shape[:-2], h * hd),
                        p["wo"].to(o.dtype).reshape(h * hd, d))


# ---------------------------------------------------------------------------
# train / prefill


def _cp_eligible(cfg, seq: int) -> bool:
    """Context parallelism for archs whose head count cannot shard over the
    model axis (e.g. gemma3's 8 heads on a 16-wide axis): shard q over the
    sequence instead, so attention splits n ways instead of running
    replicated on every model rank. K / V stay replicated (kv_heads are
    unsharded), so each rank scans the full K / V against its query block;
    causal and window masks use absolute positions (the block's
    ``q_offset``) and need no ring exchange. As the reference decides it."""
    rules = sharding.active_rules()
    if rules is None:
        return False
    m = rules.sizes.get("model", 1)
    return cfg.num_heads % m != 0 and seq % m == 0 and seq > 1


def self_attention(cfg, p, x, positions, *, window: int = 0,
                   causal: bool = True, rope_theta: Optional[float] = None):
    """x: (B, S, d); positions: (B, S) int. window=0 -> global."""
    q, k, v = _project_qkv(cfg, p, x)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    if _cp_eligible(cfg, q.shape[1]):
        q = sharding.constrain(q, ("batch", "seq", None, None))
    o = kops.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cfg.logit_softcap)
    return _out_proj(cfg, p, o)


def cross_attention(cfg, p, x, ctx):
    """x: (B, S, d); ctx: (B, S_ctx, d) encoder/vision states (no mask)."""
    return cross_attend(cfg, p, x, *prefill_cross_cache(cfg, p, ctx))


def cross_attend(cfg, p, x, k, v):
    """Cross-attention of x over the context's projected k / v (B, S_ctx,
    KV, D): the flash kernel, non-causal, no window, no softcap; q split
    over its sequence where ``_cp_eligible``, as the reference's
    ``cross_attention`` does."""
    q = _proj(x, p["wq"])
    if _cp_eligible(cfg, q.shape[1]):
        q = sharding.constrain(q, ("batch", "seq", None, None))
    o = kops.flash_attention(q, k, v, causal=False, window=0, softcap=0.0)
    return _out_proj(cfg, p, o)


# ---------------------------------------------------------------------------
# decode (single new token against a KV cache)


def init_self_cache(cfg, batch: int, max_seq: int, *, window: int = 0,
                    device="cuda"):
    """Ring-buffer KV cache. Local-attention layers only allocate the window."""
    size = min(window, max_seq) if window else max_seq
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, size, kv, hd)
    return {"k": torch.zeros(shape, dtype=cfg_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=cfg_dtype(cfg), device=device)}


def init_cross_cache(cfg, batch: int, ctx_len: int, device="cuda"):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, ctx_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=cfg_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=cfg_dtype(cfg), device=device)}


def decode_self_attention(cfg, p, x, cache, pos: int, *, window: int = 0,
                          rope_theta: Optional[float] = None):
    """x: (B, 1, d); pos = number of tokens already cached.

    The new token's KV is written in place at ``pos % cache_size`` (ring
    semantics for windowed layers); attention runs over the whole buffer
    with validity and window masking by absolute position.
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(cfg, p, x)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    if cfg.pos_embed == "rope":
        pos_b = sharding.batch_like(
            torch.full((b, 1), pos, dtype=torch.int32, device=x.device), x)
        q = apply_rope(q, pos_b, theta)
        k_new = apply_rope(k_new, pos_b, theta)

    size = cache["k"].shape[1]
    slot = pos % size
    sharding.write_slice(cache["k"], k_new, 1, slot)
    sharding.write_slice(cache["v"], v_new, 1, slot)

    # absolute position held by each ring slot after the write
    idx = torch.arange(size, device=x.device)
    n_written = pos + 1
    wraps = torch.div(n_written + size - 1 - idx, size, rounding_mode="floor")
    abs_pos = idx + (wraps - 1) * size
    valid = (abs_pos >= 0) & (abs_pos < n_written)
    if window:
        valid &= abs_pos >= (pos - window + 1)
    valid = sharding.replicate_like(valid, q)

    o = _cache_attend(cfg, q, cache["k"], cache["v"], valid)
    return _out_proj(cfg, p, o), cache


def decode_cross_attention(cfg, p, x, cache):
    """x: (B, 1, d) against the context's K / V cache (every key valid).
    Runs in a profiler range "xattn_cache", which ``chip_smoke.py``'s
    decode profile reads for the cache attention's device time."""
    with torch.profiler.record_function("xattn_cache"):
        q = _proj(x, p["wq"])
        valid = sharding.replicate_like(
            torch.ones(cache["k"].shape[1], dtype=torch.bool,
                       device=x.device), q)
        o = _cache_attend(cfg, q, cache["k"], cache["v"], valid)
        return _out_proj(cfg, p, o)


def prefill_cross_cache(cfg, p, ctx):
    """The context's (k, v): (B, S_ctx, KV, D) each."""
    return _proj(ctx, p["wk"]), _proj(ctx, p["wv"])


def _cache_attend(cfg, q, k, v, valid):
    """q: (B,1,H,D); k/v: (B,S,KV,D); valid: (S,) bool. f32 softmax. On
    DTensors each rank attends its own rows of the batch in plain torch
    (``kops.shard_map``): a cache split over S is gathered along S, and
    q's heads (which need not divide into KV groups on each rank) too."""
    if sharding.is_dtensor(q):
        rows = ("batch", None, None, None)
        return kops.shard_map(lambda *a: (_cache_attend(cfg, *a),),
                              (q, k, v, valid), (rows, rows, rows, (None,)),
                              [(rows, q.shape)])[0]
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg * (hd ** -0.5), k.float())
    if cfg.logit_softcap:
        s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
    s = torch.where(valid[None, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)

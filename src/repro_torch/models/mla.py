"""Multi-head Latent Attention (DeepSeek-V2/V3).

Counterpart of ``repro/models/mla.py``. Queries go through a low-rank
bottleneck (q_lora_rank); keys and values share a compressed latent c_kv
(kv_lora_rank) plus one decoupled RoPE key per token. The decode cache
holds only (c_kv, k_rope): kv_lora_rank + qk_rope_head_dim values a token
instead of 2 x heads x head_dim.

Prefill reconstructs per-head K and V from the latent and runs the fused
flash-attention op at the q/k head dim dn + dr (192 at full width), which
zero-pads V up to it and slices the output back to dv. Decode uses the
*absorbed* form: W_uk is folded into the query, so the scores are taken in
the latent space (q_abs . c_kv, in f32, plus the rope term), and W_uv is
applied once after the softmax. Both scale the scores by (dn + dr)^-0.5.

Unlike the reference, whose caches are immutable arrays, the port writes
the new token's latent and rope key into the cache tensors in place,
through ``sharding.write_slice`` (under a rule set, into each rank's own
block of the cache placed by ``cache_axes``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch import sharding
from repro_torch.launch.sharding import active_rules, is_dtensor
from repro_torch.models.attention import NEG_INF, _out_proj, _proj
from repro_torch.models.common import (P, apply_norm, apply_rope, cfg_dtype,
                                       norm_descs)


def mla_descs(cfg):
    d = cfg.d_model
    h = cfg.num_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": P((d, rq), ("embed", "q_lora"), "fanin"),
        "q_norm": norm_descs(cfg, rq),
        "wq_b": P((rq, h, dn + dr), ("q_lora", "heads", "head_dim"), "fanin"),
        "wkv_a": P((d, rkv + dr), ("embed", "kv_lora"), "fanin"),
        "kv_norm": norm_descs(cfg, rkv),
        "wk_b": P((rkv, h, dn), ("kv_lora", "heads", "head_dim"), "fanin"),
        "wv_b": P((rkv, h, dv), ("kv_lora", "heads", "head_dim"), "fanin"),
        "wo": P((h, dv, d), ("heads", "head_dim", "embed"), "fanin"),
    }


def _project_q(cfg, p, x, positions):
    """x: (B, S, d) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr)."""
    dn = cfg.qk_nope_head_dim
    cq = apply_norm(cfg, p["q_norm"], torch.matmul(x, p["wq_a"].to(x.dtype)))
    q = _proj(cq, p["wq_b"])
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _compress_kv(cfg, p, x, positions):
    """x: (B, S, d) -> c_kv (B, S, rkv) normed, k_rope (B, S, dr)."""
    rkv = cfg.kv_lora_rank
    ckv = torch.matmul(x, p["wkv_a"].to(x.dtype))
    c_kv = apply_norm(cfg, p["kv_norm"], ckv[..., :rkv])
    k_rope = apply_rope(ckv[:, :, None, rkv:], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_attend(cfg, p, x, positions):
    """Training / prefill path: (output (B, S, d), c_kv, k_rope), the latent
    and rope key as the cache keeps them."""
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c_kv, k_rope = _compress_kv(cfg, p, x, positions)
    k_nope, v = _proj(c_kv, p["wk_b"]), _proj(c_kv, p["wv_b"])
    o = _attend_heads(q_nope, q_rope, k_nope, k_rope, v)
    return _out_proj(cfg, p, o), c_kv, k_rope


def _attend_heads(q_nope, q_rope, k_nope, k_rope, v):
    """Causal attention of q = [q_nope ; q_rope] over k = [k_nope ; k_rope
    broadcast to every head] and v, through the fused op (which pads v's
    head dim to q's and slices the output back): (B, S, H, dv). On
    DTensors each rank assembles q / k and attends its rows and heads in
    plain torch (``kops.shard_map``); k_rope's gradient is each rank's
    part over the heads it holds."""
    if is_dtensor(q_nope):
        heads, rows = ("batch", None, "heads", None), ("batch", None, None)
        split = active_rules().spec(heads, tuple(q_nope.shape))[2]
        return kops.shard_map(
            lambda *a: (_attend_heads(*a),),
            (q_nope, q_rope, k_nope, k_rope, v),
            (heads, heads, heads, rows, heads),
            [(heads, tuple(v.shape))],
            partial_grads=() if split is None else [(3, split)])[0]
    h = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(-1, -1, h, -1)],
                  dim=-1)
    return kops.flash_attention(q, k, v, causal=True)


def mla_attention(cfg, p, x, positions):
    """x: (B, S, d) -> (B, S, d), causal."""
    return mla_attend(cfg, p, x, positions)[0]


# ---------------------------------------------------------------------------
# decode with the compressed cache (absorbed products)


def init_mla_cache(cfg, batch: int, max_seq: int, device="cuda"):
    dt = cfg_dtype(cfg)
    return {"c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                dtype=dt, device=device),
            "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                                  dtype=dt, device=device)}


def decode_mla_attention(cfg, p, x, cache, pos: int):
    """x: (B, 1, d); pos = number of tokens already cached. Writes the new
    token's latent and rope key at ``pos % cache_size`` in place
    (``sharding.write_slice``: on DTensors, into each rank's own block of
    the cache placed by ``cache_axes``) and attends over slots 0..pos (the
    ring never wraps here)."""
    b = x.shape[0]
    pos_b = sharding.batch_like(
        torch.full((b, 1), pos, dtype=torch.int32, device=x.device), x)
    q_nope, q_rope = _project_q(cfg, p, x, pos_b)           # (B,1,H,dn/dr)
    c_new, kr_new = _compress_kv(cfg, p, x, pos_b)          # (B,1,rkv/dr)

    slot = pos % cache["c_kv"].shape[1]
    sharding.write_slice(cache["c_kv"], c_new, 1, slot)
    sharding.write_slice(cache["k_rope"], kr_new, 1, slot)
    o = _absorbed_attend(cfg, q_nope, q_rope, cache["c_kv"], cache["k_rope"],
                         p["wk_b"], p["wv_b"], pos)
    return _out_proj(cfg, p, o), cache


def _absorbed_attend(cfg, q_nope, q_rope, c_kv, k_rope, wk_b, wv_b, pos):
    """The absorbed attention of new tokens q_nope / q_rope (B,1,H,dn/dr)
    over the latent cache c_kv (B,S,rkv) and k_rope (B,S,dr), slots
    0..pos valid -> (B,1,H,dv). On DTensors each rank runs it in plain
    torch (``kops.shard_map``) on its rows of the batch and its heads
    (the cache's sequence, which the model axis splits, gathered), so a
    mesh of one device computes what the eager path computes."""
    if sharding.is_dtensor(q_nope):
        rows = ("batch", None, "heads", None)
        seq = ("batch", None, None)
        w_axes = (None, "heads", None)
        b, _, h, _ = q_nope.shape
        return kops.shard_map(
            lambda *a: (_absorbed_attend(cfg, *a, pos),),
            (q_nope, q_rope, c_kv, k_rope, wk_b, wv_b),
            (rows, rows, seq, seq, w_axes, w_axes),
            [(rows, (b, 1, h, cfg.v_head_dim))])[0]
    dt = q_nope.dtype
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    size = c_kv.shape[1]
    c_kv, k_rope = c_kv.float(), k_rope.float()
    # absorb W_uk into q: q_abs (B, 1, H, rkv)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, wk_b.to(dt))
    scale = (dn + dr) ** -0.5
    s = torch.einsum("bshr,btr->bhst", q_abs.float(), c_kv) * scale
    s = s + torch.einsum("bshk,btk->bhst", q_rope.float(), k_rope) * scale
    valid = torch.arange(size, device=q_nope.device) <= pos
    w = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    # attend in latent space, then decompress once per new token
    o_lat = torch.einsum("bhst,btr->bshr", w, c_kv)
    return torch.einsum("bshr,rhk->bshk", o_lat.to(dt), wv_b.to(dt))

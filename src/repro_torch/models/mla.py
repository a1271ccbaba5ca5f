"""Multi-head Latent Attention (DeepSeek-V2/V3).

Counterpart of ``repro/models/mla.py``. Queries go through a low-rank
bottleneck (q_lora_rank); keys and values share a compressed latent c_kv
(kv_lora_rank) plus one decoupled RoPE key per token. The decode cache
holds only (c_kv, k_rope): kv_lora_rank + qk_rope_head_dim values a token
instead of 2 x heads x head_dim.

Prefill reconstructs per-head K and V from the latent and runs the fused
flash-attention op at the q/k head dim dn + dr (192 at full width), V
zero-padded up to it and the output sliced back to dv. Decode uses the
*absorbed* form: W_uk is folded into the query, so the scores are taken in
the latent space (q_abs . c_kv, in f32, plus the rope term), and W_uv is
applied once after the softmax. Both scale the scores by (dn + dr)^-0.5.

Unlike the reference, whose caches are immutable arrays, the port writes
the new token's latent and rope key into the cache tensors in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
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
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c_kv, k_rope = _compress_kv(cfg, p, x, positions)
    k_nope, v = _proj(c_kv, p["wk_b"]), _proj(c_kv, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        -1, -1, cfg.num_heads, -1)], dim=-1)
    # pad v's head dim to the q/k dim for the fused kernel, slice after
    vp = F.pad(v, (0, dn + dr - dv)) if dn + dr > dv else v
    o = kops.flash_attention(q, k, vp, causal=True)[..., :dv]
    return _out_proj(cfg, p, o), c_kv, k_rope


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
    token's latent and rope key at ``pos % cache_size`` in place and
    attends over slots 0..pos (the ring never wraps here)."""
    b = x.shape[0]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    pos_b = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _project_q(cfg, p, x, pos_b)           # (B,1,H,dn/dr)
    c_new, kr_new = _compress_kv(cfg, p, x, pos_b)          # (B,1,rkv/dr)

    size = cache["c_kv"].shape[1]
    slot = pos % size
    cache["c_kv"][:, slot] = c_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, slot] = kr_new[:, 0].to(cache["k_rope"].dtype)
    c_kv = cache["c_kv"].float()
    k_rope = cache["k_rope"].float()

    # absorb W_uk into q: q_abs (B, 1, H, rkv)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"].to(x.dtype))
    scale = (dn + dr) ** -0.5
    s = torch.einsum("bshr,btr->bhst", q_abs.float(), c_kv) * scale
    s = s + torch.einsum("bshk,btk->bhst", q_rope.float(), k_rope) * scale
    valid = torch.arange(size, device=x.device) <= pos
    w = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    # attend in latent space, then decompress once per new token
    o_lat = torch.einsum("bhst,btr->bshr", w, c_kv)
    o = torch.einsum("bshr,rhk->bshk", o_lat.to(x.dtype),
                     p["wv_b"].to(x.dtype))                 # (B,1,H,dv)
    return _out_proj(cfg, p, o), cache

"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Counterpart of ``repro/models/rglru.py``. Block: norm -> [gate branch:
linear+GELU] x [input branch: linear -> causal conv4 -> gated linear
recurrence] -> output projection. The recurrence is
  r_t = sigmoid(W_r xi_t);  i_t = sigmoid(W_i xi_t)
  log_a_t = -c * softplus(Lambda) * r_t          (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * xi_t)
run by ``kernels.ops.rg_lru`` (the CUDA kernel on the card, the sequential
plain version on the CPU). Under autograd (training) the scan's backward is
a reverse scan: the CUDA kernel ``rg_lru_bwd`` on the card, fed the f32
carry the forward kernel then also writes, and ``ref.rg_lru_bwd`` on the
CPU; the gates' gradients are autograd's.

Unlike the reference, whose caches are immutable arrays, the decode path
writes the new state into the cache tensors it is given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.common import P, apply_norm, cfg_dtype, norm_descs
from repro_torch.models.xlstm import _causal_conv, _conv_descs

_C = 8.0


def rglru_descs(cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "norm": norm_descs(cfg),
        "w_gate_branch": P((d, w), ("embed", "ffn"), "fanin"),
        "w_input": P((d, w), ("embed", "ffn"), "fanin"),
        "conv": _conv_descs(w, cfg.conv1d_width),
        "w_r": P((w, w), ("ffn", "ffn_out"), "fanin"),
        "w_i": P((w, w), ("ffn", "ffn_out"), "fanin"),
        "lam": P((w,), ("ffn",), "normal", 0.6),
        "w_out": P((w, d), ("ffn", "embed"), "fanin"),
    }


def _recurrence_inputs(cfg, p, xn, conv_state=None):
    """(a, gx) cast to the compute dtype before the scan, the GELU gate and
    the conv's new state, as the reference computes them."""
    gate = F.gelu(torch.matmul(xn, p["w_gate_branch"].to(xn.dtype)),
                  approximate="tanh")
    xi = torch.matmul(xn, p["w_input"].to(xn.dtype))
    xi, new_conv = _causal_conv(p["conv"], xi, conv_state)
    r = torch.sigmoid(torch.matmul(xi, p["w_r"].to(xn.dtype)).float())
    i = torch.sigmoid(torch.matmul(xi, p["w_i"].to(xn.dtype)).float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gx = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) \
        * (i * xi.float())
    return a.to(xn.dtype), gx.to(xn.dtype), gate, new_conv


def apply_rglru_block(cfg, p, x):
    xn = apply_norm(cfg, p["norm"], x)
    a, gx, gate, _ = _recurrence_inputs(cfg, p, xn)
    h, _ = kops.rg_lru(a, gx)
    return x + torch.matmul(h * gate, p["w_out"].to(x.dtype))


def init_rglru_cache(cfg, batch, device="cuda"):
    w = cfg.lru_width or cfg.d_model
    dt = cfg_dtype(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=dt, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dt,
                            device=device),
    }


def decode_rglru_block(cfg, p, x, cache):
    """x: (B, S, d) from the state in ``cache`` (S = 1 when decoding, the
    prompt when prefilling). Returns (out, cache), the cache updated in
    place."""
    xn = apply_norm(cfg, p["norm"], x)
    a, gx, gate, new_conv = _recurrence_inputs(cfg, p, xn, cache["conv"])
    h, h_last = kops.rg_lru(a, gx, cache["h"])
    out = x + torch.matmul(h * gate, p["w_out"].to(x.dtype))
    cache["h"].copy_(h_last)
    cache["conv"].copy_(new_conv)
    return out, cache

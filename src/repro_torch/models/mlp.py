"""Dense MLPs: gated (SwiGLU/GeGLU) and plain two-layer.
Counterpart of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.models.common import P, activation


def mlp_descs(cfg, d_ff=None):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    descs = {
        "w_up": P((d, f), ("embed", "ffn"), "fanin"),
        "w_down": P((f, d), ("ffn", "embed"), "fanin"),
    }
    if cfg.mlp_gated:
        descs["w_gate"] = P((d, f), ("embed", "ffn"), "fanin")
    return descs


def apply_mlp(cfg, p, x):
    up = torch.matmul(x, p["w_up"].to(x.dtype))
    if cfg.mlp_gated:
        gate = torch.matmul(x, p["w_gate"].to(x.dtype))
        h = activation(cfg, gate) * up
    else:
        h = activation(cfg, up)
    return torch.matmul(h, p["w_down"].to(x.dtype))

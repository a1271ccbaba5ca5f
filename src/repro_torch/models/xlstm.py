"""xLSTM building blocks. Counterpart of ``repro/models/xlstm.py``; so far
only the causal depthwise convolution (``_conv_descs``, ``_causal_conv``),
which the RG-LRU block shares with the mLSTM block. The mLSTM and sLSTM
blocks come with the xlstm slice."""
from __future__ import annotations

import torch

from repro_torch.models.common import P


def _conv_descs(dim, width):
    return {"kernel": P((width, dim), (None, "embed"), "fanin"),
            "bias": P((dim,), ("embed",), "zeros")}


def _causal_conv(p, x, state=None):
    """x: (B,S,D). state: (B,W-1,D) trailing inputs from the previous step.
    Returns (y, new_state). The ``width`` shifted products are summed in
    x's dtype in index order, from Python's 0, as the reference does."""
    w = p["kernel"].shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * p["kernel"][i].to(x.dtype)
            for i in range(w))
    y = y + p["bias"].to(x.dtype)
    new_state = xp[:, -(w - 1):]
    return y, new_state

"""Gradient utilities: global-norm clipping and int8 compression with error
feedback.

Counterpart of ``repro/optim/grad.py`` over nested dicts of tensors:
``global_norm`` and ``clip_by_global_norm``, and the int8 gradient
compression (``compress_int8``, ``decompress_int8``,
``compress_error_feedback``): one symmetric scale per leaf,
max|x| / 127 floored at 1e-12 (not the checkpoint's 2048-element blocks).
The scale divides as a tensor, never as a Python scalar: torch on the card
divides by a Python scalar as a product with its reciprocal, one ulp off
the IEEE quotient the reference computes.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.common import map_tree, tree_leaves, unzip, zip_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-key order) of each leaf's f32
    sum of squares."""
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return map_tree(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def compress_int8(tree):
    """Per-leaf symmetric int8 quantization. Returns (q_tree, scale_tree)
    with f32 0-d scales."""
    def q(x):
        xf = x.float()
        s = torch.clamp_min(xf.abs().max(), 1e-12) / torch.tensor(
            127.0, device=xf.device)
        return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s
    return unzip(map_tree(q, tree), 2)


def decompress_int8(q_tree, scale_tree, dtype=torch.float32):
    return zip_map(lambda q, s: (q.float() * s).to(dtype), q_tree, scale_tree)


def compress_error_feedback(tree, residual):
    """int8 compress (tree + residual); returns (q, scales, new_residual)."""
    biased = zip_map(lambda g, r: g.float() + r.float(), tree, residual)
    q, s = compress_int8(biased)
    recon = decompress_int8(q, s)
    return q, s, zip_map(lambda b, r: b - r, biased, recon)

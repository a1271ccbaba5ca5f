"""Gradient utilities: global-norm clipping.

Counterpart of ``repro/optim/grad.py``'s ``global_norm`` and
``clip_by_global_norm`` over nested dicts of tensors. The reference's int8
gradient compression (``compress_int8``, ``compress_error_feedback``) is
not ported yet.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.common import map_tree, tree_leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted-key order) of each leaf's f32
    sum of squares."""
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return map_tree(lambda x: (x.float() * scale).to(x.dtype), tree), norm

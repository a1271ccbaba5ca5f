"""Shared building blocks: param descriptors, norms, RoPE, embeddings.

Counterpart of ``repro/models/common.py``. Parameters are plain nested dicts
of tensors. Every module declares its parameters as a tree of ``P``
descriptors; ``init_tree`` materializes them with an explicit
``torch.Generator``. Layers of a segment are stacked along a leading
dimension (``stack_descs``), so leaf paths and shapes match the reference's
and a checkpoint written by one package restores in the other.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import replicate_like, whole

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter descriptor: shape + logical axes + init scheme."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones | fanin
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError((self.shape, self.axes))


def _materialize(desc: P, gen: torch.Generator, dtype, device) -> torch.Tensor:
    if desc.init == "zeros":
        return torch.zeros(desc.shape, dtype=dtype, device=device)
    if desc.init == "ones":
        return torch.ones(desc.shape, dtype=dtype, device=device)
    if desc.init == "fanin":
        fan_in = desc.shape[-2] if len(desc.shape) >= 2 else desc.shape[-1]
        std = desc.scale / math.sqrt(max(fan_in, 1))
    elif desc.init == "normal":
        std = desc.scale
    else:
        raise ValueError(desc.init)
    x = torch.randn(desc.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of nested dicts and tuples (NamedTuples
    keep their type)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        kids = [map_tree(fn, v) for v in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return fn(tree)


def zip_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (the last
    tree's keys), -> the tree of its results. Module-level recursion, not a
    closure that calls itself: such a closure is a reference cycle, and the
    tensors it holds would outlive the call until the garbage collector
    runs (a whole train state a step, on the card)."""
    ref = trees[-1]
    if isinstance(ref, dict):
        return {k: zip_map(fn, *(t[k] for t in trees)) for k in ref}
    return fn(*trees)


def unzip(tree, n: int):
    """A tree of nested dicts whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        kids = {k: unzip(v, n) for k, v in tree.items()}
        return tuple({k: kid[i] for k, kid in kids.items()} for i in range(n))
    return tree


def tree_leaves(tree):
    """Leaves of nested dicts (in sorted-key order, the reference's order)
    and tuples (in field order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def init_tree(tree, gen: torch.Generator, dtype, device) -> Any:
    """Materialize a descriptor tree, leaves drawn in sorted-key order."""
    if isinstance(tree, dict):
        return {k: init_tree(tree[k], gen, dtype, device) for k in sorted(tree)}
    return _materialize(tree, gen, dtype, device)


def stack_descs(tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked (layer) dimension of size n to every descriptor."""
    return map_tree(lambda d: P((n,) + d.shape, (axis_name,) + d.axes,
                                d.init, d.scale), tree)


# ---------------------------------------------------------------------------
# numerics


def norm_descs(cfg, dim: Optional[int] = None):
    dim = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": P((dim,), ("embed",), "ones"),
                "bias": P((dim,), ("embed",), "zeros")}
    return {"scale": P((dim,), ("embed",), "ones")}


def apply_norm(cfg, p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    if cfg.norm == "layernorm":
        x = x - x.mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
        return (x * p["scale"].float() + p["bias"].float()).to(dt)
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def activation(cfg, x):
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# ---------------------------------------------------------------------------
# rotary position embeddings


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                    # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    Half-split (not interleaved) rotation, computed in f32."""
    half = x.shape[-1] // 2
    freqs = replicate_like(rope_freqs(x.shape[-1], theta, x.device), x)
    angles = positions[..., :, None].float() * freqs    # (..., seq, half)
    cos = torch.cos(angles)[..., :, None, :]            # (..., seq, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=4)
def sincos_positions(seq: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal table (whisper encoder), f32 (seq, dim), read-only.
    Computed once a shape (the reference's jit folds it into a constant):
    whisper's 1500 x 1280 takes ~40 ms of host time, every prefill."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * i / dim)
    table = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    table = table.astype(np.float32)
    table.flags.writeable = False
    return table


# ---------------------------------------------------------------------------
# embedding / unembedding


def padded_vocab(cfg) -> int:
    """Vocab padded to a multiple of 256 (the reference's sharding-friendly
    size); serving masks the padded logits."""
    return ((cfg.vocab_size + 255) // 256) * 256


def embed_descs(cfg):
    v = padded_vocab(cfg)
    d = {"tokens": P((v, cfg.d_model), ("vocab", "embed"), "normal", 0.02)}
    if not cfg.tie_embeddings:
        d["unembed"] = P((cfg.d_model, v), ("embed", "vocab"), "fanin")
    if cfg.pos_embed == "learned":
        d["positions"] = P((cfg.max_position, cfg.d_model), (None, "embed"),
                           "normal", 0.02)
    return d


def embed_tokens(cfg, p, tokens, positions=None):
    # over DTensors the lookup takes the ids whole on every rank, so that
    # its backward (an accumulating index_put) scatters a whole gradient:
    # torch 2.11's DTensor rule for index_put fails on batch-split values
    x = p["tokens"].to(cfg_dtype(cfg))[whole(tokens)]
    if cfg.embed_scale:
        x = x * replicate_like(torch.tensor(math.sqrt(cfg.d_model),
                                            dtype=x.dtype, device=x.device),
                               x)
    if cfg.pos_embed == "learned":
        if positions is None:
            raise ValueError("learned position embeddings need positions")
        x = x + p["positions"].to(x.dtype)[whole(positions)]
    return x


def unembed(cfg, p, x):
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", x, p["tokens"].to(x.dtype))
    return torch.einsum("...d,dv->...v", x, p["unembed"].to(x.dtype))


def cfg_dtype(cfg):
    return DTYPES[cfg.compute_dtype]


def cfg_param_dtype(cfg):
    return DTYPES[cfg.param_dtype]

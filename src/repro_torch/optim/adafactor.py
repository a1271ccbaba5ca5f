"""Adafactor (factored second moments), the optimizer of the largest configs.

Counterpart of ``repro/optim/adafactor.py``. For a leaf of rank >= 2 the
second moment is kept as a row vector (the leaf's shape without its last
dim) and a column vector (without its second-to-last dim), factored over
the trailing two dims of the leaf as stored: a stacked (L, d, H, hd)
projection gives vr (L, d, H) and vc (L, d, hd), a stacked (L, d) norm
scale vr (L,) and vc (d,). Rank-0/1 leaves keep an unfactored vr and a
zero-size ``(0,)`` vc; with ``momentum == 0`` m is a zero-size ``(0,)``
sentinel too, as in the reference, so the checkpoint leaves
``opt_state/.step``, ``.vr``, ``.vc`` and ``.m`` match it path for path.

The update, leaf by leaf in f32: beta2 = 1 - t^-decay from the int32 step;
vr / vc from the mean of g^2 + eps over the last / second-to-last dim;
u = g / (sqrt(r) sqrt(vc) + eps) with r = vr / max(mean(vr), eps); u
divided by max(1, RMS(u) / clip_threshold), the RMS taken over the whole
leaf (every layer of a stacked segment); momentum kept in
``momentum_dtype``; decoupled weight decay only on leaves of ndim >= 2.
The reference's ``CHUNKED_UPDATE_MIN`` is 2^62, so its layer-chunked
``lax.map`` path never runs there; it has no counterpart here. Plain torch
ops (the reference has no kernel here), deterministic on the card: the
training restart is held bit for bit. Pure functions: ``update`` returns
new tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.launch.sharding import placed_like
from repro_torch.models.common import (DTYPES, map_tree, tree_leaves, unzip,
                                      zip_map)


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any      # row second moment (the full v for rank < 2)
    vc: Any      # column second moment (a (0,) sentinel for rank < 2)
    m: Any       # momentum (a (0,) sentinel when disabled)


def _factored(p) -> bool:
    return p.dim() >= 2


@dataclasses.dataclass(frozen=True)
class Adafactor:
    lr: Callable                  # step -> lr
    decay: float = 0.8            # beta2_t = 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    momentum: float = 0.0         # 0 disables the first moment
    momentum_dtype: str = "bfloat16"

    def init(self, params) -> AdafactorState:
        """Zero moments beside each param; an int32 step on the params'
        device."""
        f32 = torch.float32

        def zeros(shape, p, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=p.device)

        def vr(p):
            return zeros(p.shape[:-1] if _factored(p) else p.shape, p)

        def vc(p):
            return zeros(p.shape[:-2] + p.shape[-1:] if _factored(p)
                         else (0,), p)

        def m(p):
            return zeros(p.shape, p, DTYPES[self.momentum_dtype]) \
                if self.momentum else zeros((0,), p)

        device = tree_leaves(params)[0].device
        return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                               device=device),
                              vr=map_tree(vr, params),
                              vc=map_tree(vc, params),
                              m=map_tree(m, params))

    def update(self, grads, state: AdafactorState, params):
        """-> (new params, new state), in the reference's order of
        operations."""
        step = state.step + 1
        beta2 = 1.0 - step.float() ** (-self.decay)
        lr = self.lr(step)

        def upd(g, vr, vc, m, p):
            gf = g.float()
            g2 = gf.square() + self.eps
            if _factored(p):
                vr_new = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
                vc_new = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
                r = vr_new / torch.clamp_min(
                    vr_new.mean(dim=-1, keepdim=True), self.eps)
                u = gf / (torch.sqrt(r)[..., None]
                          * torch.sqrt(vc_new)[..., None, :] + self.eps)
            else:
                vr_new = beta2 * vr + (1 - beta2) * g2
                vc_new = vc
                u = gf / (torch.sqrt(vr_new) + self.eps)
            # update clipping by the leaf's RMS
            rms = torch.sqrt(u.square().mean() + 1e-30)
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            if self.momentum:
                m_new = self.momentum * m.float() + (1 - self.momentum) * u
                u = m_new
                m_out = m_new.to(m.dtype)
            else:
                m_out = m
            if self.weight_decay and p.dim() >= 2:
                u = u + self.weight_decay * p.float()
            p_new = p.float() - lr * u
            return (placed_like(p_new.to(p.dtype), p), placed_like(vr_new, vr),
                    placed_like(vc_new, vc), placed_like(m_out, m))

        p_new, vr_new, vc_new, m_new = unzip(zip_map(
            upd, grads, state.vr, state.vc, state.m, params), 4)
        return p_new, AdafactorState(step=step, vr=vr_new, vc=vc_new,
                                     m=m_new)

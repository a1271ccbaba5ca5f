"""Carry a numpy tree (the JAX package's params or train state, fetched to
the host) into the port's tree of tensors, with the same paths and shapes.

bfloat16 arrays (numpy's ``ml_dtypes.bfloat16``, which torch cannot read)
are carried bit for bit through their int16 view. The other direction needs
no converter: the serializer's payloads are the bridge.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.adafactor import AdafactorState
from repro_torch.optim.adamw import AdamWState

# the port's counterpart of each NamedTuple the reference's checkpoints
# hold: a JAX train_loop checkpoint is {"params", "opt_state": AdamWState
# or AdafactorState, "data"}; the fields (and so the leaf paths) in the
# reference's order
_NAMEDTUPLES = {"AdamWState": AdamWState, "AdafactorState": AdafactorState}


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dicts / lists / NamedTuples of numpy arrays -> the same tree of
    tensors on ``device``. ``dtype``, if given, casts floating leaves."""
    device = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            cls = _NAMEDTUPLES.get(type(t).__name__)
            if cls is None or cls._fields != t._fields:
                raise TypeError(f"no port counterpart for {type(t).__name__}"
                                f"{t._fields}")
            return cls(*(walk(c) for c in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(c) for c in t)
        if t is None:
            return None
        return _tensor(t, device, dtype)

    return walk(tree)

"""PyTorch + CUDA port of the burst-buffer reproduction (``repro``).

The JAX package ``repro`` is the reference; this package imports nothing
from it and never imports ``jax``. ``core/`` is a copy of ``repro/core``
(the burst buffer itself, pure Python); the model, checkpoint and serving
layers are PyTorch, and every Pallas TPU kernel on a ported path is a CUDA
kernel under ``kernels/csrc`` built for Hopper (sm_90a).

Entry points take ``device=`` and default to ``"cuda"``; they raise when
CUDA is absent unless the caller asks for ``"cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent — there is no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU")
    return dev

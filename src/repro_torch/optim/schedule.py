"""LR schedules (step -> lr) as plain callables.

Counterpart of ``repro/optim/schedule.py``. The step is an int32 tensor;
the lr comes back as an f32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        s = step.float()
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return lr


def constant(lr_value: float):
    def lr(step):
        return torch.tensor(lr_value, dtype=torch.float32, device=step.device)
    return lr

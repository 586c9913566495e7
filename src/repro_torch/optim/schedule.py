"""LR schedules (multiplier form: schedule(step) in [0, 1]), on step tensors.

A port of the JAX package's ``optim/schedule.py``.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(warmup_steps: int, total_steps: int, min_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return fn

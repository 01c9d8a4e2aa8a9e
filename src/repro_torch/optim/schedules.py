"""LR schedule: cosine with linear warmup (counterpart of
``repro.optim.schedules.cosine``), evaluated in float32 as the reference
evaluates it."""
from __future__ import annotations

import math

import torch


def cosine(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def fn(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return fn

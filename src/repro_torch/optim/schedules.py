"""LR schedules (counterparts of ``repro.optim.schedules``): cosine with
linear warmup, and WSD (warmup, stable plateau, exponential decay over the
last ``decay_frac``; MiniCPM's), each evaluated in float32 as the
reference evaluates it."""
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


def wsd(base_lr: float, warmup: int, total: int, decay_frac: float = 0.1,
        min_ratio: float = 0.01):
    """Warmup -> stable plateau -> sharp decay over the last decay_frac."""
    decay_start = int(total * (1.0 - decay_frac))

    def fn(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        t = ((step - decay_start)
             / max(total - decay_start, 1)).clamp(0.0, 1.0)
        dec = base_lr * torch.pow(torch.tensor(min_ratio, dtype=torch.float32),
                                  t)
        out = torch.where(step < decay_start,
                          torch.tensor(base_lr, dtype=torch.float32), dec)
        return torch.where(step < warmup, warm, out)
    return fn


def get_schedule(name: str, base_lr: float, warmup: int, total: int):
    if name == "wsd":
        return wsd(base_lr, warmup, total)
    return cosine(base_lr, warmup, total)

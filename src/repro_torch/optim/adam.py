"""AdamW and SGD with momentum written out by hand (counterparts of
``repro.optim.adam.AdamW`` and ``SGDM``), not ``torch.optim``: the
reference's AdamW clips to a global gradient norm, uses b2 = 0.95, folds
weight decay into the step and applies bias correction by division; its
SGDM keeps an fp32 momentum ``m = m * momentum + g`` and steps ``p - lr *
m``, with no clip and no weight decay. The port must take the same steps.
AdamW's ``moment_dtype="bfloat16"`` keeps m and v in bf16 (half the
state's bytes): each step computes them in fp32 from the stored values
and casts them back, as the reference does.

Parameters, gradients and moments are flat lists of tensors (the order of
``nn.param.flatten``); the update returns new tensors and leaves its inputs
as they were.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum() for l in leaves))


@dataclass(frozen=True)
class AdamW:
    schedule: Callable  # step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"
    grad_clip: float = 1.0

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        dt = (torch.bfloat16 if self.moment_dtype == "bfloat16"
              else torch.float32)
        return {"m": [torch.zeros_like(p, dtype=dt) for p in params],
                "v": [torch.zeros_like(p, dtype=dt) for p in params],
                "step": 0}

    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]):
        """One step. Returns (new params, new state, {"lr", "grad_norm"})."""
        step = state["step"] + 1
        lr = self.schedule(step)
        gnorm = global_norm(grads)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        stepf = torch.tensor(step, dtype=torch.float32)
        bc1 = 1.0 - self.b1 ** stepf
        bc2 = 1.0 - self.b2 ** stepf
        b1, b2 = self.b1, self.b2
        new_p: List[torch.Tensor] = []
        new_m: List[torch.Tensor] = []
        new_v: List[torch.Tensor] = []
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            g = g.float() * scale
            m32 = m.float() * b1 + (1 - b1) * g
            v32 = v.float() * b2 + (1 - b2) * g.square()
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = (mhat / (vhat.sqrt() + self.eps)
                     + self.weight_decay * p.float())
            new_p.append((p.float() - lr * delta).to(p.dtype))
            new_m.append(m32.to(m.dtype))
            new_v.append(v32.to(v.dtype))
        return (new_p, {"m": new_m, "v": new_v, "step": step},
                {"lr": lr, "grad_norm": gnorm})


@dataclass(frozen=True)
class SGDM:
    schedule: Callable  # step -> lr
    momentum: float = 0.9

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
                "step": 0}

    def update(self, grads: Sequence[torch.Tensor], state: dict,
               params: Sequence[torch.Tensor]):
        """One step. Returns (new params, new state, {"lr"}): the
        reference reports no gradient norm for SGDM."""
        step = state["step"] + 1
        lr = self.schedule(step)
        new_p: List[torch.Tensor] = []
        new_m: List[torch.Tensor] = []
        for p, g, m in zip(params, grads, state["m"]):
            m32 = m * self.momentum + g.float()
            new_p.append((p.float() - lr * m32).to(p.dtype))
            new_m.append(m32)
        return new_p, {"m": new_m, "step": step}, {"lr": lr}

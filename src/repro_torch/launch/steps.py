"""Step factories for serving (counterpart of ``repro.launch.steps``).

The steps run without autograd (``torch.no_grad``). The reference's
``**kw`` (its sharding axis names) has no counterpart without a mesh.
``make_train_step`` waits for the LM training step (ROADMAP.md queue A,
item A.14.1).
"""
from __future__ import annotations

import torch

from repro_torch.models.registry import ModelBundle


def make_train_step(bundle: ModelBundle, optimizer):
    raise NotImplementedError(
        "the LM training step (loss_fn, gradient accumulation, the flash "
        "backward) is not ported yet (ROADMAP.md queue A, item A.14.1)")


def make_prefill_step(bundle: ModelBundle):
    @torch.no_grad()
    def step(params, batch):
        return bundle.prefill_fn(params, batch)
    return step


def make_decode_step(bundle: ModelBundle):
    @torch.no_grad()
    def step(params, cache, batch):
        return bundle.decode_fn(params, cache, batch)
    return step

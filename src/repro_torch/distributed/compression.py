"""Gradient compression with error feedback (copy of
``repro.distributed.compression``; off by default).

int8 symmetric quantization per tensor with an error-feedback accumulator:
   q = round(g / s), s = max|g| / 127;  e' = g - q*s  (carried to next step)
The compressed payload is what would cross the wire (4x smaller than
f32). ``torch.round`` rounds half to even, as ``jnp.round`` does.

A tree is a tensor, or a dict or list of trees (the trainer passes its
gradients as a list in ``nn.param.flatten`` order); a payload tree has a
``(q, scale)`` tuple at each leaf.
"""
from __future__ import annotations

from typing import Tuple

import torch


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists are nodes, a
    tensor or a tuple is a leaf), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def compress_tree(grads, error):
    """Returns (quantized payload tree, new error-feedback tree)."""
    if error is None:
        error = _map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                     grads)

    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = compress(corrected)
        return (q, s), corrected - decompress(q, s)

    out = _map(one, grads, error)
    return _map(lambda o: o[0], out), _map(lambda o: o[1], out)


def decompress_tree(payload):
    return _map(lambda qs: decompress(*qs), payload)


def payload_bytes(payload) -> int:
    total = []
    _map(lambda qs: total.extend(t.numel() * t.element_size() for t in qs),
         payload)
    return sum(total)

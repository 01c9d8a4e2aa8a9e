"""Parameter specs, a standalone init, and the weight bridge to the JAX
reference (counterpart of ``repro.nn.param``).

A model declares its parameters as ``{"layers": [{name: PSpec}]}``. The
port keeps parameters as the same tree of plain tensors, scalars (GIN's
0-d ``eps``) included. Leaves are visited
in the reference's pytree order (layers in order, names sorted), so
``flatten`` lists them as ``jax.tree.leaves`` does.

* ``init_params(spec, seed, device)`` draws the reference's init law — a
  fan-in scaled normal for weights, zeros for biases (``repro.nn.param``'s
  ``_init_leaf``) — from a ``torch.Generator``. It gives other numbers than
  ``jax.random`` from the same seed.
* ``params_from_numpy`` / ``params_to_numpy`` carry a tree between the two
  packages as numpy arrays, so a run can start from the reference's
  ``materialize(spec, PRNGKey(seed))``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class PSpec:
    """Shape and init law of one parameter tensor."""

    shape: Tuple[int, ...]
    init: str = "normal"             # normal | zeros


def tree_paths(tree) -> List[Tuple[int, str]]:
    """(layer, name) of every leaf, in the reference's pytree order."""
    return [(l, k) for l, layer in enumerate(tree["layers"])
            for k in sorted(layer)]


def flatten(tree) -> list:
    return [tree["layers"][l][k] for l, k in tree_paths(tree)]


def unflatten(like, leaves) -> dict:
    """A tree shaped like ``like`` holding ``leaves`` (in flatten order)."""
    layers = [{} for _ in like["layers"]]
    for (l, k), leaf in zip(tree_paths(like), leaves):
        layers[l][k] = leaf
    return {"layers": layers}


def _init_leaf(spec: PSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=torch.float32)
    fan_in = (spec.shape[0] if len(spec.shape) >= 2
              else spec.shape[-1] if spec.shape else 1)
    std = 1.0 / np.sqrt(max(fan_in, 1))
    return torch.randn(spec.shape, generator=gen, dtype=torch.float32) * std


def init_params(spec_tree, seed: int, device) -> dict:
    """Real parameters from a spec tree, drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and then moved to ``device``, so
    a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    leaves = [_init_leaf(s, gen).to(device) for s in flatten(spec_tree)]
    return unflatten(spec_tree, leaves)


def params_from_numpy(tree, device) -> dict:
    """``{"layers": [{name: np.ndarray}]}`` -> the same tree of float32
    tensors on ``device``."""
    return {"layers": [
        {k: torch.from_numpy(np.array(v, np.float32)).to(device)
         for k, v in layer.items()}
        for layer in tree["layers"]]}


def params_to_numpy(tree) -> dict:
    return {"layers": [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                       for layer in tree["layers"]]}

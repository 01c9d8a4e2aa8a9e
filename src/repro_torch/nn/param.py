"""Parameter specs, standalone inits, and the weight bridge to the JAX
reference (counterpart of ``repro.nn.param``).

A model declares its parameters as a tree of :class:`PSpec`: nested dicts
(the LM zoo, with layers stacked on dim 0) or the GNN's
``{"layers": [{name: PSpec}]}``. The port keeps parameters as the same tree
of plain tensors, scalars (GIN's 0-d ``eps``) included. Leaves are visited
in the reference's pytree order (dict keys sorted, lists in order,
recursively), so ``flatten`` lists them as ``jax.tree.leaves`` does.

* ``_init_leaf`` is the reference's init law: ``zeros``, ``ones``,
  ``embed`` (a normal times ``scale``) and ``normal``, a normal times
  ``scale / sqrt(fan_in)`` with fan-in ``shape[0]`` for a matrix and
  ``prod(shape[1:-1])`` for a stacked leaf of 3 or more dims.
* ``materialize(spec, seed, dtype, device)`` (the LM zoo's) draws from a
  ``torch.Generator`` on ``device`` itself, which keeps an 8B-parameter
  init on the card. ``init_params(spec, seed, device)`` (the GNN
  trainer's) is ``materialize`` on the CPU in float32, then moved, so a
  seed gives the same weights on every device. Both give other numbers
  than ``jax.random`` from the same seed.
* ``params_from_numpy`` / ``params_to_numpy`` carry a tree between the two
  packages as numpy arrays, so a run can start from the reference's
  ``materialize(spec, PRNGKey(seed))``. numpy has no bfloat16: the bridge
  carries float32 and casts on the torch side.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class PSpec:
    """Shape and init law of one parameter tensor. ``axes`` are the
    reference's logical axis names; the port shards nothing and keeps them
    only so that its specs read as the reference's."""

    shape: Tuple[int, ...]
    axes: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"             # normal | zeros | ones | embed
    scale: float = 1.0               # stddev multiplier


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def tree_paths(tree) -> List[Tuple[int, str]]:
    """(layer, name) of every leaf of a GNN tree, in pytree order."""
    return [(l, k) for l, layer in enumerate(tree["layers"])
            for k in sorted(layer)]


def flatten(tree) -> list:
    """Every leaf, in ``jax.tree.leaves`` order."""
    return _leaves(tree)


def _fill(like, it):
    if isinstance(like, dict):
        return {k: _fill(like[k], it) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(x, it) for x in like)
    return next(it)


def unflatten(like, leaves) -> dict:
    """A tree shaped like ``like`` holding ``leaves`` (in flatten order).
    (A module-level walk: a nested recursive function would make a
    reference cycle through the iterator that keeps every leaf alive until
    the garbage collector runs.)"""
    return _fill(like, iter(leaves))


def param_count(spec_tree) -> int:
    return int(sum(int(np.prod(s.shape)) for s in flatten(spec_tree)))


def stack_layers(spec_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked-layers dim to every leaf."""
    return _map(lambda s: PSpec((n,) + s.shape,
                                None if s.axes is None
                                else (axis_name,) + s.axes,
                                s.init, s.scale), spec_tree)


def _std(spec: PSpec) -> float:
    """Standard deviation of a drawn leaf (``embed`` or ``normal``)."""
    if spec.init == "embed":
        return spec.scale
    if spec.init != "normal":
        raise ValueError(f"unknown init law {spec.init!r}")
    shape = spec.shape
    fan_in = shape[0] if len(shape) >= 2 else (shape[-1] if shape else 1)
    if len(shape) >= 3:  # stacked layers dim first
        fan_in = int(np.prod(shape[1:-1])) or shape[-1]
    return spec.scale / np.sqrt(max(fan_in, 1))


def _init_leaf(spec: PSpec, gen: torch.Generator,
               device=None) -> torch.Tensor:
    """One leaf in float32, drawn from ``gen`` on ``device``."""
    if spec.init in ("zeros", "ones"):
        fill = torch.zeros if spec.init == "zeros" else torch.ones
        return fill(spec.shape, dtype=torch.float32, device=device)
    std = _std(spec)
    return torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(std)


def materialize(spec_tree, seed: int, dtype: torch.dtype, device) -> dict:
    """Real parameters from a spec tree, drawn in float32 from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` and cast to
    ``dtype``, leaves in flatten order. A stacked leaf (3 or more dims) is
    drawn one layer at a time into its ``dtype`` tensor, so no float32
    copy of a whole stack is held (Llama-3-8B's MLP stack would take 7.5
    GB)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = []
    for s in flatten(spec_tree):
        if len(s.shape) < 3 or s.init in ("zeros", "ones"):
            leaves.append(_init_leaf(s, gen, device).to(dtype))
            continue
        out = torch.empty(s.shape, dtype=dtype, device=device)
        std = _std(s)
        for i in range(s.shape[0]):
            out[i] = torch.randn(s.shape[1:], generator=gen,
                                 dtype=torch.float32, device=device).mul_(std)
        leaves.append(out)
    return unflatten(spec_tree, leaves)


def init_params(spec_tree, seed: int, device) -> dict:
    """Real float32 parameters from a spec tree, drawn on the CPU (by
    ``materialize``) and then moved to ``device``, so a seed gives the same
    weights on every device."""
    return _map(lambda t: t.to(device),
                materialize(spec_tree, seed, torch.float32, "cpu"))


def params_from_numpy(tree, device, dtype: torch.dtype = torch.float32):
    """A tree of numpy arrays -> the same tree of ``dtype`` tensors on
    ``device`` (carried as float32)."""
    return _map(lambda v: torch.from_numpy(np.array(v, np.float32)).to(
        device=device, dtype=dtype), tree)


def params_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays (bfloat16 and
    float16 leaves are carried as float32)."""
    def one(v):
        v = v.detach().cpu()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.float()
        return v.numpy()
    return _map(one, tree)

"""Model registry (counterpart of ``repro.models.registry``): resolves an
ArchConfig into a ModelBundle of its parameter spec, an init, ``loss_fn``,
``prefill_fn`` / ``decode_fn`` and its cache spec, plus per-shape input
specs.

The port builds the ``dense``, ``moe`` and ``vlm`` families
(``models/lm.py``) and the ``ssm`` family (``models/rwkv.py``), each of
which trains and serves; the other families raise on ``build``, naming
their ROADMAP.md items.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import lm, rwkv
from repro_torch.nn.param import PSpec, materialize

# families the port does not build yet -> their ROADMAP.md item
_NOT_PORTED = {"hybrid": "A.14.4 (the hybrid family with mamba2)",
               "audio": "A.14.5 (whisper)"}


@dataclass(frozen=True)
class InputSpec:
    spec: PSpec
    dtype: Any
    kind: str  # tokens | labels | embeds | index


@dataclass
class ModelBundle:
    """An arch's spec, init, loss and serving functions.

    ``decode_fn`` donates the dense and MoE families' KV cache: it writes
    the step's k and v into the given cache's tensors in place and returns
    that same dict (the reference returns new arrays; the port saves
    copying the whole cache every step), so a caller that needs the cache
    from before a step keeps a clone. The ssm family's decode returns a new state and
    leaves the given one as it was."""
    cfg: ArchConfig
    param_spec: Any
    loss_fn: Callable        # (params, batch) -> (loss, metrics)
    prefill_fn: Callable     # (params, batch) -> (logits, cache)
    decode_fn: Callable      # (params, cache, batch) -> (logits, cache)
    #                          (dense: the same cache, updated in place)
    cache_spec: Optional[Callable] = None   # (batch, seq) -> PSpec tree

    def init_params(self, seed: int, dtype: torch.dtype = torch.bfloat16,
                    device=None):
        """Parameters drawn on ``device`` (None: ``"cuda"``) from a
        ``torch.Generator`` seeded with ``seed``, by the reference's init
        laws, in ``dtype``."""
        return materialize(self.param_spec, seed, dtype,
                           resolve_device(device))


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md queue A, item {_NOT_PORTED[cfg.family]})")
    if cfg.family not in ("dense", "moe", "vlm", "ssm"):
        raise ValueError(f"unknown family {cfg.family!r}")


def build(cfg: ArchConfig) -> ModelBundle:
    _check_family(cfg)
    if cfg.family in ("dense", "moe", "vlm"):
        return ModelBundle(
            cfg, lm.param_spec(cfg),
            loss_fn=lambda p, b: lm.loss_fn(p, cfg, b),
            prefill_fn=lambda p, b: lm.prefill(p, cfg, b),
            decode_fn=lambda p, c, b: lm.decode_step(p, cfg, c, b),
            cache_spec=lambda batch, seq: lm.cache_spec(cfg, batch, seq))
    return ModelBundle(
        cfg, rwkv.param_spec(cfg),
        loss_fn=lambda p, b: rwkv.loss_fn(p, cfg, b),
        prefill_fn=lambda p, b: rwkv.prefill(p, cfg, b),
        decode_fn=lambda p, c, b: rwkv.decode_step(p, cfg, c, b),
        cache_spec=lambda batch, seq: rwkv.state_spec(cfg, batch, seq))


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, InputSpec]:
    """The inputs of one step at ``shape``. A VLM's sequence of S positions
    is its P patch embeddings, (B, P, d) bf16, then S - P text tokens
    (and as many labels)."""
    _check_family(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": InputSpec(PSpec((B, 1), ("batch", None)),
                                    torch.int32, "tokens"),
                "pos": InputSpec(PSpec((), ()), torch.int32, "index")}
    out = {}
    if cfg.family == "vlm":
        P = cfg.vlm.num_patches
        out["patch_embeds"] = InputSpec(
            PSpec((B, P, cfg.d_model), ("batch", None, None)),
            torch.bfloat16, "embeds")
        S -= P
    out["tokens"] = InputSpec(PSpec((B, S), ("batch", None)), torch.int32,
                              "tokens")
    if shape.kind == "train":
        out["labels"] = InputSpec(PSpec((B, S), ("batch", None)),
                                  torch.int32, "labels")
    return out


def sample_inputs(cfg: ArchConfig, shape: ShapeSpec, rng: np.random.Generator,
                  device=None):
    """Concrete inputs drawn by numpy's ``rng`` in the reference's order
    (the reference's draws from the same generator): token ids as int32,
    patch embeddings as standard normals rounded to bf16, on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name, ispec in input_specs(cfg, shape).items():
        if ispec.kind in ("tokens", "labels"):
            ids = rng.integers(0, cfg.vocab_size, size=ispec.spec.shape)
        elif ispec.kind == "embeds":
            out[name] = torch.from_numpy(rng.standard_normal(
                ispec.spec.shape)).to(device=dev, dtype=ispec.dtype)
            continue
        else:  # index
            ids = np.asarray(shape.seq_len - 1)
        out[name] = torch.from_numpy(ids.astype(np.int32)).to(dev)
    return out

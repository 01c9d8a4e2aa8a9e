"""RWKV-6 (Finch) causal LM for serving (counterpart of
``repro.models.rwkv``): attention-free, its state O(1) in sequence length.

The parameters stay stacked with the layers on dim 0; ``forward`` loops
over the layers where the reference ``lax.scan``s. Prefill returns each
layer's token-shift and WKV states, stacked, and decode carries them.
``loss_fn`` waits for RWKV's training step and its WKV6 backward kernel
(ROADMAP.md queue A, item A.14.1b).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layer_params
from repro_torch.nn import layers as L
from repro_torch.nn.param import PSpec, stack_layers
from repro_torch.nn.rwkv6 import (channelmix, channelmix_spec, timemix,
                                  timemix_spec)


def layer_spec(cfg: ArchConfig):
    d = cfg.d_model
    return {
        "ln1": L.norm_spec(d, "layernorm"),
        "tm": timemix_spec(d, cfg.rwkv),
        "ln2": L.norm_spec(d, "layernorm"),
        "cm": channelmix_spec(d, cfg.d_ff),
    }


def param_spec(cfg: ArchConfig):
    vp = L.pad_vocab(cfg.vocab_size)
    return {
        "embed": L.embedding_spec(vp, cfg.d_model, cfg.tie_embeddings),
        "ln_in": L.norm_spec(cfg.d_model, "layernorm"),
        "layers": stack_layers(layer_spec(cfg), cfg.n_layers),
        "ln_f": L.norm_spec(cfg.d_model, "layernorm"),
    }


def state_spec(cfg: ArchConfig, batch: int, seq: int):
    del seq  # recurrent: state size independent of context length
    d = cfg.d_model
    hs = cfg.rwkv.head_size
    H = d // hs
    n = cfg.n_layers
    return {
        "tm_shift": PSpec((n, batch, d), ("layers", "batch", "embed"),
                          "zeros"),
        "wkv": PSpec((n, batch, H, hs, hs),
                     ("layers", "batch", "heads", None, None), "zeros"),
        "cm_shift": PSpec((n, batch, d), ("layers", "batch", "embed"),
                          "zeros"),
    }


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, *, state=None):
    """Returns (hidden (B, S, d), the new stacked states)."""
    x = L.embed_tokens(params["embed"], tokens)
    x = L.apply_norm(params["ln_in"], x, cfg.norm_eps)
    new = {"tm_shift": [], "wkv": [], "cm_shift": []}
    for l in range(cfg.n_layers):
        p = layer_params(params["layers"], l)
        st = None if state is None else layer_params(state, l)
        y, tm = timemix(p["tm"], L.apply_norm(p["ln1"], x, cfg.norm_eps),
                        cfg.rwkv, state=None if st is None else
                        {"shift": st["tm_shift"], "wkv": st["wkv"]})
        x = x + y
        y, cm = channelmix(p["cm"], L.apply_norm(p["ln2"], x, cfg.norm_eps),
                           state=None if st is None else
                           {"shift": st["cm_shift"]})
        x = x + y
        new["tm_shift"].append(tm["shift"])
        new["wkv"].append(tm["wkv"])
        new["cm_shift"].append(cm["shift"])
    x = L.apply_norm(params["ln_f"], x, cfg.norm_eps)
    return x, {k: torch.stack(v) for k, v in new.items()}


def loss_fn(params, cfg: ArchConfig, batch):
    raise NotImplementedError(
        "RWKV-6's training step is not ported yet: it needs a backward of "
        "the wkv6_chunk kernel (ROADMAP.md queue A, item A.14.1b)")


def prefill(params, cfg: ArchConfig, batch):
    """Returns (last-token logits (B, 1, V) fp32, states)."""
    x, states = forward(params, cfg, batch["tokens"])
    return L.logits_fn(params["embed"], x[:, -1:], cfg.vocab_size), states


def decode_step(params, cfg: ArchConfig, state, batch):
    """batch: {"tokens": (B, 1), ...}. Returns (logits (B, 1, V) fp32, new
    states)."""
    x, state = forward(params, cfg, batch["tokens"], state=state)
    return L.logits_fn(params["embed"], x, cfg.vocab_size), state

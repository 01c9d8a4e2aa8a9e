"""RWKV-6 (Finch) causal LM, training and serving (counterpart of
``repro.models.rwkv``): attention-free, its state O(1) in sequence length.

The parameters stay stacked with the layers on dim 0; ``forward`` loops
over the layers where the reference ``lax.scan``s, and in ``"train"`` mode
runs each layer under ``torch.utils.checkpoint`` when ``cfg.remat ==
"full"`` (the reference's ``jax.checkpoint``): a layer keeps only its
input, and the backward recomputes it, the ``wkv6_chunk`` launch too.
Prefill returns each layer's token-shift and WKV states, stacked, and
decode carries them.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _layer(cfg: ArchConfig, p, x: torch.Tensor, st):
    """One block: time-mix and channel-mix, each after its norm, each
    added to the residual. Returns (x, its token-shift and WKV states)."""
    y, tm = timemix(p["tm"], L.apply_norm(p["ln1"], x, cfg.norm_eps),
                    cfg.rwkv, state=None if st is None else
                    {"shift": st["tm_shift"], "wkv": st["wkv"]})
    x = x + y
    y, cm = channelmix(p["cm"], L.apply_norm(p["ln2"], x, cfg.norm_eps),
                       state=None if st is None else
                       {"shift": st["cm_shift"]})
    return x + y, (tm["shift"], tm["wkv"], cm["shift"])


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
            mode: str = "train", state=None):
    """Returns (hidden (B, S, d), the new stacked states). ``mode`` is the
    reference's (``"train"``, ``"prefill"``, ``"decode"``): only
    ``"train"`` with ``cfg.remat == "full"`` differs, by its remat."""
    x = L.embed_tokens(params["embed"], tokens)
    x = L.apply_norm(params["ln_in"], x, cfg.norm_eps)
    new = {"tm_shift": [], "wkv": [], "cm_shift": []}
    for l in range(cfg.n_layers):
        p = layer_params(params["layers"], l)
        st = None if state is None else layer_params(state, l)
        if mode == "train" and cfg.remat == "full":
            x, sts = checkpoint(_layer, cfg, p, x, st, use_reentrant=False)
        else:
            x, sts = _layer(cfg, p, x, st)
        for name, t in zip(("tm_shift", "wkv", "cm_shift"), sts):
            new[name].append(t)
    x = L.apply_norm(params["ln_f"], x, cfg.norm_eps)
    return x, {k: torch.stack(v) for k, v in new.items()}


def loss_fn(params, cfg: ArchConfig, batch):
    """Causal-LM loss: the mean token cross-entropy of the fp32 logits
    against ``batch["labels"]``. Returns (ce, {"loss", "ce"}), fp32
    scalars."""
    x, _ = forward(params, cfg, batch["tokens"], mode="train")
    logits = L.logits_fn(params["embed"], x, cfg.vocab_size)
    ce = L.cross_entropy(logits, batch["labels"])
    return ce, {"loss": ce, "ce": ce}


def prefill(params, cfg: ArchConfig, batch):
    """Returns (last-token logits (B, 1, V) fp32, states)."""
    x, states = forward(params, cfg, batch["tokens"], mode="prefill")
    return L.logits_fn(params["embed"], x[:, -1:], cfg.vocab_size), states


def decode_step(params, cfg: ArchConfig, state, batch):
    """batch: {"tokens": (B, 1), ...}. Returns (logits (B, 1, V) fp32, new
    states)."""
    x, state = forward(params, cfg, batch["tokens"], mode="decode",
                       state=state)
    return L.logits_fn(params["embed"], x, cfg.vocab_size), state

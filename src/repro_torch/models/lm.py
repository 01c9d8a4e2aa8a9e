"""Decoder-only LM, the dense (MiniCPM-2B, StarCoder2-7B, Yi-9B,
Llama-3-8B), MoE (OLMoE-1B-7B, Grok-1) and VLM-backbone (LLaVA-NeXT-34B)
families: training, prefill and decode (counterpart of
``repro.models.lm``).

The parameters stay stacked with the layers on dim 0, as the reference
keeps them and the weight bridge carries them; ``forward`` loops over the
layers where the reference ``lax.scan``s, and in ``"train"`` mode runs each
layer under ``torch.utils.checkpoint`` when ``cfg.remat == "full"`` (the
reference's ``jax.checkpoint``): a layer keeps only its input, and the
backward recomputes it (the MoE layer's routing too, from the same
inputs). Gradients reach the stacked leaves through the layers' views.
Each layer returns its aux loss (the MoE layer's load-balance loss, 0 for
a dense MLP); ``forward`` averages it over the layers and ``loss_fn`` adds
0.01 x that mean, as the reference does.

The VLM backbone takes precomputed patch embeddings (``embeds_prefix``,
(B, P, d), the vision tower and projector being a stub in the reference
too): they are cast to the embeddings' dtype and put ahead of the text
tokens, and positions run over the whole sequence, so a decode step after a
prefixed prefill of S text tokens is at position P + S. ``loss_fn`` leaves
the prefix's positions unsupervised: their hidden states are dropped
before the logits.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import layers as L
from repro_torch.nn.attention import attend, attention_spec
from repro_torch.nn.moe import moe_ffn, moe_spec
from repro_torch.nn.param import PSpec, stack_layers


def _norm_kind(cfg: ArchConfig) -> str:
    return "layernorm" if cfg.act == "gelu" else "rmsnorm"


def layer_spec(cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    sp = {
        "ln1": L.norm_spec(d, _norm_kind(cfg)),
        "attn": attention_spec(d, cfg.n_heads, cfg.n_kv_heads, hd),
        "ln2": L.norm_spec(d, _norm_kind(cfg)),
    }
    if cfg.moe is not None:
        sp["moe"] = moe_spec(d, cfg.d_ff, cfg.moe)
    else:
        sp["mlp"] = L.mlp_spec(d, cfg.d_ff, cfg.act)
    return sp


def param_spec(cfg: ArchConfig):
    vp = L.pad_vocab(cfg.vocab_size)
    return {
        "embed": L.embedding_spec(vp, cfg.d_model, cfg.tie_embeddings),
        "layers": stack_layers(layer_spec(cfg), cfg.n_layers),
        "ln_f": L.norm_spec(cfg.d_model, _norm_kind(cfg)),
    }


def cache_spec(cfg: ArchConfig, batch: int, seq: int):
    """KV cache spec tree, layers stacked on dim 0."""
    kv = PSpec((cfg.n_layers, batch, seq, cfg.n_kv_heads,
                cfg.resolved_head_dim),
               ("layers", "batch", "seq_kv", "kv_heads", None), "zeros")
    return {"k": kv, "v": kv}


def layer_params(tree, l: int):
    """Layer ``l``'s slice of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, l) for k, v in tree.items()}
    return tree[l]


def _layer(cfg: ArchConfig, p, x: torch.Tensor, positions: torch.Tensor,
           mode: str, cache_l):
    """One block: attention and the MLP (or the MoE FFN), each after its
    norm, each added to the residual. Returns (x, the attention's cache,
    the MoE layer's aux loss, None for a dense MLP)."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps)
    a, c = attend(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                  head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                  positions=positions, mode=mode, cache=cache_l)
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm_eps)
    if cfg.moe is not None:
        m, aux = moe_ffn(p["moe"], h, cfg.moe)
    else:
        m, aux = L.apply_mlp(p["mlp"], h, cfg.act), None
    return x + m, c, aux


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
            embeds_prefix=None, mode: str = "prefill", cache=None, pos0=None):
    """Returns (hidden (B, S, d), cache, the layers' mean aux loss).
    ``"train"`` returns no cache; ``"prefill"`` builds a new stacked cache
    at capacity S; ``"decode"`` writes one position (``pos0``) of ``cache``
    in place and returns it."""
    x = L.embed_tokens(params["embed"], tokens)
    if embeds_prefix is not None:
        if (embeds_prefix.dim() != 3
                or embeds_prefix.shape[0] != x.shape[0]
                or embeds_prefix.shape[2] != x.shape[2]):
            raise ValueError(
                f"embeds_prefix has shape {tuple(embeds_prefix.shape)}; "
                f"expected ({x.shape[0]}, P, {x.shape[2]})")
        x = torch.cat([embeds_prefix.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if mode == "decode":
        positions = torch.as_tensor(pos0, device=x.device).reshape(
            -1, 1).expand(B, 1)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    new_k, new_v, aux = [], [], []
    for l in range(cfg.n_layers):
        p = layer_params(params["layers"], l)
        cache_l = (None if cache is None
                   else {"k": cache["k"][l], "v": cache["v"][l]})
        if mode == "train" and cfg.remat == "full":
            x, c, a = checkpoint(_layer, cfg, p, x, positions, mode,
                                 cache_l, use_reentrant=False)
        else:
            x, c, a = _layer(cfg, p, x, positions, mode, cache_l)
        aux.append(a)
        if mode == "prefill":
            new_k.append(c["k"])
            new_v.append(c["v"])
    x = L.apply_norm(params["ln_f"], x, cfg.norm_eps)
    if mode == "prefill":
        cache = {"k": torch.stack(new_k), "v": torch.stack(new_v)}
    aux = (torch.stack(aux).mean() if cfg.moe is not None
           else torch.zeros((), dtype=torch.float32, device=x.device))
    return x, cache, aux


def loss_fn(params, cfg: ArchConfig, batch):
    """Causal-LM loss: the mean token cross-entropy of the text tokens'
    logits against ``batch["labels"]`` (the VLM's patch-embedding prefix is
    unsupervised), plus 0.01 x the layers' mean MoE auxiliary loss, 0 for
    the dense family. Returns (loss, {"loss", "ce", "aux"}), fp32
    scalars."""
    prefix = batch.get("patch_embeds")
    x, _, aux = forward(params, cfg, batch["tokens"], embeds_prefix=prefix,
                        mode="train")
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    logits = L.logits_fn(params["embed"], x, cfg.vocab_size)
    ce = L.cross_entropy(logits, batch["labels"])
    loss = ce + 0.01 * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def prefill(params, cfg: ArchConfig, batch):
    """Returns (last-token logits (B, 1, V) fp32, cache of P + S
    positions, P the length of ``batch["patch_embeds"]`` where given)."""
    x, cache, _ = forward(params, cfg, batch["tokens"],
                          embeds_prefix=batch.get("patch_embeds"),
                          mode="prefill")
    return L.logits_fn(params["embed"], x[:, -1:], cfg.vocab_size), cache


def decode_step(params, cfg: ArchConfig, cache, batch):
    """batch: {"tokens": (B, 1), "pos": scalar}. Returns (logits (B, 1, V)
    fp32, the cache, updated in place)."""
    x, cache, _ = forward(params, cfg, batch["tokens"], mode="decode",
                          cache=cache, pos0=batch["pos"])
    return L.logits_fn(params["embed"], x, cfg.vocab_size), cache

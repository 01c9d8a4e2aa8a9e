"""Zamba2-style hybrid: a Mamba2 backbone and ONE weight-shared attention
block called every ``shared_attn_period`` backbone layers (counterpart of
``repro.models.zamba2``).

The backbone's parameters stay stacked (G, period, ...), as the reference
keeps them and the weight bridge carries them; the shared block is one
unstacked set. ``forward`` loops over the G = n_layers / period groups,
and within a group over its Mamba2 layers, where the reference nests two
``lax.scan``s; after each group it runs the shared block (rmsnorm,
attention, rmsnorm, a gated-silu MLP, whatever ``cfg.act`` says, as in the
reference). In ``"train"`` mode with ``cfg.remat == "full"`` only each
Mamba2 layer runs under ``torch.utils.checkpoint``; the shared block stays
outside it, as in the reference, so its flash forward launches once a
group.

The decode state is the reference's (``state_spec``): each Mamba2 layer's
conv and SSM states, (G, period, B, ...), and each group's call of the
shared block its own KV cache, (G, B, S, KH, D). Prefill returns all four;
a decode step writes k and v into the given state's tensors in place (as
the dense family's decode does) and returns new conv and SSM states.
Simplification of the reference kept here: the shared block takes the
hidden state alone (no concat with the embeddings, no per-call LoRA).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layer_params
from repro_torch.nn import layers as L
from repro_torch.nn.attention import attend, attention_spec
from repro_torch.nn.mamba2 import CONV_K, mamba2_block, mamba2_spec
from repro_torch.nn.param import PSpec, stack_layers


def _groups(cfg: ArchConfig) -> tuple[int, int]:
    period = cfg.hybrid.shared_attn_period
    assert cfg.n_layers % period == 0, (cfg.n_layers, period)
    return cfg.n_layers // period, period


def param_spec(cfg: ArchConfig):
    G, period = _groups(cfg)
    mamba_layer = {"ln": L.norm_spec(cfg.d_model, "rmsnorm"),
                   "mamba": mamba2_spec(cfg.d_model, cfg.hybrid)}
    shared = {
        "ln1": L.norm_spec(cfg.d_model, "rmsnorm"),
        "attn": attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim),
        "ln2": L.norm_spec(cfg.d_model, "rmsnorm"),
        "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, "silu"),
    }
    vp = L.pad_vocab(cfg.vocab_size)
    return {
        "embed": L.embedding_spec(vp, cfg.d_model, cfg.tie_embeddings),
        "backbone": stack_layers(stack_layers(mamba_layer, period,
                                              "layers_inner"), G, "layers"),
        "shared": shared,
        "ln_f": L.norm_spec(cfg.d_model, "rmsnorm"),
    }


def state_spec(cfg: ArchConfig, batch: int, seq: int):
    """Decode state: each Mamba2 layer's conv and SSM states, and each
    call of the shared block its KV cache."""
    h = cfg.hybrid
    G, period = _groups(cfg)
    d_in = h.ssm_expand * cfg.d_model
    H = d_in // h.ssm_headdim
    conv_dim = d_in + 2 * h.ssm_state
    kv = PSpec((G, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim),
               ("layers", "batch", "seq_kv", "kv_heads", None), "zeros")
    return {
        "conv": PSpec((G, period, batch, CONV_K - 1, conv_dim),
                      ("layers", "layers_inner", "batch", None, "heads"),
                      "zeros"),
        "ssm": PSpec((G, period, batch, H, h.ssm_headdim, h.ssm_state),
                     ("layers", "layers_inner", "batch", "heads", None, None),
                     "zeros"),
        "k": kv, "v": kv,
    }


def _mamba_layer(cfg: ArchConfig, p, x: torch.Tensor, mode: str, st):
    """One backbone layer: rmsnorm, the Mamba2 block, the residual."""
    y, new = mamba2_block(p["mamba"], L.apply_norm(p["ln"], x, cfg.norm_eps),
                          cfg.hybrid, mode=mode, state=st)
    return x + y, new


def _shared_block(cfg: ArchConfig, p, x: torch.Tensor, positions, mode: str,
                  cache):
    """The shared block: attention and a gated-silu MLP, each after its
    rmsnorm, each added to the residual. Returns (x, the attention's
    cache)."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps)
    a, c = attend(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                  head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                  positions=positions, mode=mode, cache=cache)
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + L.apply_mlp(p["mlp"], h, "silu"), c


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
            mode: str = "train", state=None, pos0=None):
    """Returns (hidden (B, S, d), the new state). ``"train"`` returns no
    state; ``"prefill"`` the four leaves of ``state_spec`` at capacity S;
    ``"decode"`` one step from ``state`` at position ``pos0``."""
    x = L.embed_tokens(params["embed"], tokens)
    B, S, _ = x.shape
    if mode == "decode":
        positions = torch.as_tensor(pos0, device=x.device).reshape(
            -1, 1).expand(B, 1)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
    G, period = _groups(cfg)
    remat = mode == "train" and cfg.remat == "full"
    conv, ssm, ks, vs = [], [], [], []
    for g in range(G):
        p_g = layer_params(params["backbone"], g)
        for i in range(period):
            p_l = layer_params(p_g, i)
            st = (None if state is None else
                  {"conv": state["conv"][g, i], "ssm": state["ssm"][g, i]})
            if remat:
                x, new = checkpoint(_mamba_layer, cfg, p_l, x, mode, st,
                                    use_reentrant=False)
            else:
                x, new = _mamba_layer(cfg, p_l, x, mode, st)
            if mode != "train":
                conv.append(new["conv"])
                ssm.append(new["ssm"])
        cache_g = (None if state is None else
                   {"k": state["k"][g], "v": state["v"][g]})
        x, c = _shared_block(cfg, params["shared"], x, positions, mode,
                             cache_g)
        if mode == "prefill":
            ks.append(c["k"])
            vs.append(c["v"])
    x = L.apply_norm(params["ln_f"], x, cfg.norm_eps)
    if mode == "train":
        return x, None

    def stacked(ts):
        return torch.stack(ts).unflatten(0, (G, period))
    new_state = {"conv": stacked(conv), "ssm": stacked(ssm)}
    if mode == "prefill":
        new_state.update(k=torch.stack(ks), v=torch.stack(vs))
    else:  # decode wrote its step into the given caches
        new_state.update(k=state["k"], v=state["v"])
    return x, new_state


def loss_fn(params, cfg: ArchConfig, batch):
    """Causal-LM loss: the mean token cross-entropy of the fp32 logits
    against ``batch["labels"]``. Returns (ce, {"loss", "ce"}), fp32
    scalars."""
    x, _ = forward(params, cfg, batch["tokens"], mode="train")
    logits = L.logits_fn(params["embed"], x, cfg.vocab_size)
    ce = L.cross_entropy(logits, batch["labels"])
    return ce, {"loss": ce, "ce": ce}


def prefill(params, cfg: ArchConfig, batch):
    """Returns (last-token logits (B, 1, V) fp32, the state)."""
    x, state = forward(params, cfg, batch["tokens"], mode="prefill")
    return L.logits_fn(params["embed"], x[:, -1:], cfg.vocab_size), state


def decode_step(params, cfg: ArchConfig, state, batch):
    """batch: {"tokens": (B, 1), "pos": scalar}. Returns (logits (B, 1, V)
    fp32, the state: k and v the given tensors, updated in place; conv and
    ssm new)."""
    x, state = forward(params, cfg, batch["tokens"], mode="decode",
                       state=state, pos0=batch["pos"])
    return L.logits_fn(params["embed"], x, cfg.vocab_size), state

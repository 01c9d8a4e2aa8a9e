"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.whisper``). The audio conv frontend is a stub, as in the
reference: the encoder takes precomputed frame embeddings (B, enc_len, d).

The parameters stay stacked with the layers on dim 0 (``encoder`` and
``decoder``), as the reference keeps them and the weight bridge carries
them; ``encode`` and ``decode`` loop over the layers where the reference
``lax.scan``s. Every layer is pre-LayerNorm with a gelu MLP; positions are
fixed sinusoids (fp32, cast to the activations' dtype), defined past
Whisper's own 448-token text context.

* The encoder's self-attention is non-causal (``attend``'s ``x_kv`` = its
  input) and runs through the flash kernels. It is never under remat, as
  the reference's encoder scan has no ``jax.checkpoint``.
* Each decoder layer runs causal self-attention, then cross-attention to
  the encoder's output (non-causal, Sq != Sk, through the flash kernels),
  then the MLP. In ``"train"`` mode with ``cfg.remat == "full"`` each
  decoder layer runs under ``torch.utils.checkpoint``.
* ``"prefill"`` returns four caches stacked by layer: ``self_k`` /
  ``self_v`` at capacity S and ``cross_k`` / ``cross_v`` over the
  encoder's frames, the cross k and v projected once (the reference
  projects them twice, to the same values). A decode step writes self k
  and v into the given cache's tensors in place (as the dense family's
  decode does) and reads the cross cache through ``attend_cached``
  (``decode_attention``, plain PyTorch as in the reference), never
  writing it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import layer_params
from repro_torch.nn import layers as L
from repro_torch.nn.attention import attend, attend_cached, attention_spec
from repro_torch.nn.param import PSpec, stack_layers


def _enc_layer_spec(cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "ln1": L.norm_spec(d, "layernorm"),
        "attn": attention_spec(d, cfg.n_heads, cfg.n_kv_heads, hd),
        "ln2": L.norm_spec(d, "layernorm"),
        "mlp": L.mlp_spec(d, cfg.d_ff, "gelu"),
    }


def _dec_layer_spec(cfg: ArchConfig):
    sp = _enc_layer_spec(cfg)
    sp["ln_x"] = L.norm_spec(cfg.d_model, "layernorm")
    sp["xattn"] = attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.resolved_head_dim)
    return sp


def param_spec(cfg: ArchConfig):
    vp = L.pad_vocab(cfg.vocab_size)
    return {
        "embed": L.embedding_spec(vp, cfg.d_model, cfg.tie_embeddings),
        "encoder": stack_layers(_enc_layer_spec(cfg), cfg.encdec.enc_layers),
        "ln_enc": L.norm_spec(cfg.d_model, "layernorm"),
        "decoder": stack_layers(_dec_layer_spec(cfg), cfg.n_layers),
        "ln_f": L.norm_spec(cfg.d_model, "layernorm"),
    }


def cache_spec(cfg: ArchConfig, batch: int, seq: int):
    """The decoder's self-attention caches at capacity ``seq`` and its
    cross-attention caches over the encoder's ``enc_len`` frames, layers
    stacked on dim 0."""
    hd = cfg.resolved_head_dim
    self_kv = PSpec((cfg.n_layers, batch, seq, cfg.n_kv_heads, hd),
                    ("layers", "batch", "seq_kv", "kv_heads", None), "zeros")
    cross_kv = PSpec((cfg.n_layers, batch, cfg.encdec.enc_len,
                      cfg.n_kv_heads, hd),
                     ("layers", "batch", None, "kv_heads", None), "zeros")
    return {"self_k": self_kv, "self_v": self_kv,
            "cross_k": cross_kv, "cross_v": cross_kv}


def _heads(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim)


def _enc_layer(cfg: ArchConfig, p, x: torch.Tensor, mode: str):
    """One encoder layer: bidirectional self-attention and the gelu MLP,
    each after its LayerNorm, each added to the residual."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps)
    a, _ = attend(p["attn"], h, **_heads(cfg), rope_theta=None,
                  positions=None, mode=mode, x_kv=h)
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + L.apply_mlp(p["mlp"], h, "gelu")


def encode(params, cfg: ArchConfig, frames: torch.Tensor,
           mode: str = "train") -> torch.Tensor:
    """frames: (B, enc_len, d) precomputed embeddings (the conv frontend's
    stub), cast to the parameters' dtype. Returns the encoder's output (B,
    enc_len, d). ``mode`` is the attention's: ``"train"`` keeps the flash
    gradient, ``"prefill"`` runs the forward kernel alone (the same
    bits)."""
    frames = frames.to(params["embed"]["table"].dtype)
    x = frames + L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                        frames.device).to(frames.dtype)
    for l in range(cfg.encdec.enc_layers):
        x = _enc_layer(cfg, layer_params(params["encoder"], l), x, mode)
    return L.apply_norm(params["ln_enc"], x, cfg.norm_eps)


def _dec_layer(cfg: ArchConfig, p, x: torch.Tensor, enc_out, positions,
               mode: str, cache_l):
    """One decoder layer: causal self-attention, cross-attention to
    ``enc_out`` (at decode: to ``cache_l``'s cross k and v), the gelu MLP,
    each after its LayerNorm, each added to the residual. Returns (x, the
    self-attention's cache, the cross cache), both None in training."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_eps)
    self_cache = (None if cache_l is None else
                  {"k": cache_l["self_k"], "v": cache_l["self_v"]})
    a, new_self = attend(p["attn"], h, **_heads(cfg), rope_theta=None,
                         positions=positions, mode=mode, cache=self_cache)
    x = x + a
    h = L.apply_norm(p["ln_x"], x, cfg.norm_eps)
    if mode == "decode":
        a = attend_cached(p["xattn"], h, cache_l["cross_k"],
                          cache_l["cross_v"], cfg.encdec.enc_len - 1,
                          **_heads(cfg))
        new_cross = None
    else:
        a, new_cross = attend(p["xattn"], h, **_heads(cfg), rope_theta=None,
                              positions=positions, mode=mode, x_kv=enc_out)
    x = x + a
    h = L.apply_norm(p["ln2"], x, cfg.norm_eps)
    return x + L.apply_mlp(p["mlp"], h, "gelu"), new_self, new_cross


def _sin_pos_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position embeddings at arbitrary positions (B, S) ->
    (B, S, d) fp32."""
    ang = positions[..., None].float() * L.sinusoid_freqs(d,
                                                          positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def decode(params, cfg: ArchConfig, tokens: torch.Tensor, enc_out, *,
           mode: str = "train", cache=None, pos0=None):
    """The decoder stack. ``enc_out``: the encoder's output (B, enc_len, d),
    None at decode (the cross cache holds it). Returns (hidden (B, S, d),
    cache): None in ``"train"``; in ``"prefill"`` a new stacked cache
    (``cache_spec``'s four leaves at capacity S); in ``"decode"`` the given
    cache, its self k and v written at ``pos0`` in place."""
    x = L.embed_tokens(params["embed"], tokens)
    B, S, _ = x.shape
    if mode == "decode":
        positions = torch.as_tensor(pos0, device=x.device).reshape(
            -1, 1).expand(B, 1)
        x = x + _sin_pos_at(positions, cfg.d_model).to(x.dtype)
    else:
        positions = torch.arange(S, device=x.device)[None, :]
        x = x + L.sinusoidal_positions(S, cfg.d_model,
                                       x.device).to(x.dtype)[None]
    remat = mode == "train" and cfg.remat == "full"
    new = {"self_k": [], "self_v": [], "cross_k": [], "cross_v": []}
    for l in range(cfg.n_layers):
        p = layer_params(params["decoder"], l)
        cache_l = None if cache is None else layer_params(cache, l)
        if remat:
            x, c_self, c_cross = checkpoint(_dec_layer, cfg, p, x, enc_out,
                                            positions, mode, cache_l,
                                            use_reentrant=False)
        else:
            x, c_self, c_cross = _dec_layer(cfg, p, x, enc_out, positions,
                                            mode, cache_l)
        if mode == "prefill":
            for kind, c in (("self", c_self), ("cross", c_cross)):
                new[f"{kind}_k"].append(c["k"])
                new[f"{kind}_v"].append(c["v"])
    x = L.apply_norm(params["ln_f"], x, cfg.norm_eps)
    if mode == "prefill":
        cache = {k: torch.stack(v) for k, v in new.items()}
    return x, cache


def loss_fn(params, cfg: ArchConfig, batch):
    """The decoder's token cross-entropy over ``batch["frames"]``: the
    mean of the fp32 logits' cross-entropy against ``batch["labels"]``.
    Returns (ce, {"loss", "ce"}), fp32 scalars (no auxiliary term)."""
    enc = encode(params, cfg, batch["frames"])
    x, _ = decode(params, cfg, batch["tokens"], enc, mode="train")
    logits = L.logits_fn(params["embed"], x, cfg.vocab_size)
    ce = L.cross_entropy(logits, batch["labels"])
    return ce, {"loss": ce, "ce": ce}


def prefill(params, cfg: ArchConfig, batch):
    """batch: {"frames": (B, enc_len, d), "tokens": (B, S)}. Returns
    (last-token logits (B, 1, V) fp32, the four caches)."""
    enc = encode(params, cfg, batch["frames"], mode="prefill")
    x, cache = decode(params, cfg, batch["tokens"], enc, mode="prefill")
    return L.logits_fn(params["embed"], x[:, -1:], cfg.vocab_size), cache


def decode_step(params, cfg: ArchConfig, cache, batch):
    """batch: {"tokens": (B, 1), "pos": scalar}. Returns (logits (B, 1, V)
    fp32, the cache: self k and v updated in place, the cross cache as it
    was)."""
    x, cache = decode(params, cfg, batch["tokens"], None, mode="decode",
                      cache=cache, pos0=batch["pos"])
    return L.logits_fn(params["embed"], x, cfg.vocab_size), cache

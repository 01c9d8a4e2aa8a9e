"""GQA attention: flash attention for training and prefill, decode
against a KV cache (counterpart of ``repro.nn.attention``).

Prefill runs ``kernels.flash_attention.flash_attention_fwd``: the CUDA
kernel on the card, its plain version on the CPU. The kernel reads kv head
h // G for query head h, so k and v go in unrepeated; that is the
reference's ``jnp.repeat(k, G, axis=2)``. Training runs
``flash_attention``, the same forward with its gradient
(``kernels.flash_attention.FlashAttention``: the forward keeps the
log-sum-exp and the backward kernel recomputes the probabilities from it,
as the reference's ``_flash_core_bwd`` does). Decode runs
``decode_attention``, plain PyTorch as in the reference (no Pallas kernel
computes it). An encoder-decoder's non-causal attention (``attend``'s
``x_kv``: the encoder's self-attention and the decoder's cross-attention)
runs through the same flash kernels, and its decode reads the cross cache
through ``attend_cached``. The reference's sharding annotations are
dropped: the port has no mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_fwd)
from repro_torch.nn.layers import apply_rope
from repro_torch.nn.param import PSpec


def attention_spec(d: int, n_heads: int, n_kv: int, head_dim: int):
    return {
        "wq": PSpec((d, n_heads, head_dim), ("embed", "heads", None)),
        "wk": PSpec((d, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wv": PSpec((d, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wo": PSpec((n_heads, head_dim, d), ("heads", None, "embed")),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Softmax attention with its gradient, never holding the (Sq, Sk)
    matrix past a call. q: (B, Sq, H, D); k, v: (B, Sk, KH, D), NOT
    repeated (kv head h // G for query head h; the reference takes them
    repeated and has chunk sizes, which the kernels do not need). Causal
    assumes q and k start at the same position."""
    return FlashAttention.apply(q, k, v, causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos,
                     n_rep: int) -> torch.Tensor:
    """One-token attention against a cache. q: (B, 1, H, D); caches (B, S,
    KH, D) with H = KH * n_rep, query head h reading kv head h // n_rep;
    positions <= pos (an int or a one-element tensor) are attended. Scores
    and softmax in fp32; p is cast to the cache's dtype for the PV
    product."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, KH, n_rep, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                     k_cache.float()) * (1.0 / (D ** 0.5))
    mask = torch.arange(S, device=q.device) <= pos
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, D).to(q.dtype)


def attend(p, x: torch.Tensor, *, n_heads: int, n_kv: int, head_dim: int,
           rope_theta: Optional[float], positions: torch.Tensor,
           mode: str = "prefill", cache: Optional[dict] = None,
           x_kv: Optional[torch.Tensor] = None):
    """Attention block (projections + core; no norm or residual). Returns
    (out, new_cache).

    Self-attention (``x_kv`` None) is causal; with ``x_kv`` (B, Sk, d) the
    keys and values are projected from it, no rope is applied and the core
    is non-causal: the encoder's bidirectional self-attention (``x_kv`` =
    x) or the decoder's cross-attention (Sq != Sk), as in the reference.

    * ``"train"``: attention over the whole sequence through
      ``flash_attention`` (the flash kernels, forward and backward); the
      cache it was given (None in the models) comes back as it was.
    * ``"prefill"``: attention over the whole sequence through the flash
      kernel; the new cache holds the unrepeated k (rope applied) and v in
      x's dtype, at capacity S. With ``x_kv`` there is no self cache: the
      cache holds x_kv's k and v, in x's dtype (the cross cache of an
      encoder-decoder, projected once).
    * ``"decode"``: one token at ``positions[0]`` against ``cache``; k and v
      are written at that position, clamped into the cache as
      ``dynamic_update_slice`` clamps it, IN PLACE into the cache's tensors
      (the reference returns new arrays; the port saves the copy), and the
      updated cache is returned. Self-attention only: a cross cache is read
      by ``decode_attention`` itself.
    """
    B = x.shape[0]
    G = n_heads // n_kv
    cross = x_kv is not None
    if cross and mode == "decode":
        raise ValueError("decode attends to a cross cache through "
                         "decode_attention, not attend(x_kv=...)")
    src = x_kv if cross else x
    q = _project(x, p["wq"])
    k = _project(src, p["wk"])
    v = _project(src, p["wv"])
    if rope_theta is not None and not cross:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        pos = positions.reshape(-1)[:1].long()   # stays on the device
        at = pos.clamp(0, cache["k"].shape[1] - 1)
        cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
        new_cache = cache
        out = decode_attention(q, cache["k"], cache["v"], pos, G)
    elif mode == "prefill":
        out = flash_attention_fwd(q, k, v, causal=not cross)
        new_cache = {"k": k.to(x.dtype), "v": v.to(x.dtype)}
    elif mode == "train":
        out = flash_attention(q, k, v, causal=not cross)
        new_cache = cache
    else:
        raise ValueError(f"unknown attention mode {mode!r}")

    out = out.reshape(B, -1, n_heads * head_dim)
    return out @ p["wo"].reshape(n_heads * head_dim, -1), new_cache


def attend_cached(p, x: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos, *, n_heads: int, n_kv: int,
                  head_dim: int) -> torch.Tensor:
    """One token (x (B, 1, d)) against a cache it does not write, every
    position <= ``pos`` attended: the query projection, ``decode_attention``
    and the output projection (an encoder-decoder's cross-attention at
    decode, the reference's inline einsums around ``decode_attention``)."""
    B = x.shape[0]
    out = decode_attention(_project(x, p["wq"]), k_cache, v_cache, pos,
                           n_heads // n_kv)
    out = out.reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"].reshape(n_heads * head_dim, -1)

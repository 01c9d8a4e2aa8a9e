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
computes it). The reference's sharding annotations are dropped: the port
has no mesh.
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
           mode: str = "prefill", cache: Optional[dict] = None):
    """Self-attention block (projections + core; no norm or residual).
    Returns (out, new_cache).

    * ``"train"``: causal attention over the whole sequence through
      ``flash_attention`` (the flash kernels, forward and backward); the
      cache it was given (None in the models) comes back as it was.
    * ``"prefill"``: causal attention over the whole sequence through the
      flash kernel; the new cache holds the unrepeated k (rope applied) and
      v in x's dtype, at capacity S.
    * ``"decode"``: one token at ``positions[0]`` against ``cache``; k and v
      are written at that position, clamped into the cache as
      ``dynamic_update_slice`` clamps it, IN PLACE into the cache's tensors
      (the reference returns new arrays; the port saves the copy), and the
      updated cache is returned.
    """
    B = x.shape[0]
    G = n_heads // n_kv
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if rope_theta is not None:
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
        out = flash_attention_fwd(q, k, v, causal=True)
        new_cache = {"k": k.to(x.dtype), "v": v.to(x.dtype)}
    elif mode == "train":
        out = flash_attention(q, k, v, causal=True)
        new_cache = cache
    else:
        raise ValueError(f"unknown attention mode {mode!r}")

    out = out.reshape(B, -1, n_heads * head_dim)
    return out @ p["wo"].reshape(n_heads * head_dim, -1), new_cache

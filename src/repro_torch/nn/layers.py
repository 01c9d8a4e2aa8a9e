"""Shared LM building blocks: norms, RoPE, embeddings, MLPs (counterpart of
``repro.nn.layers``).

``*_spec`` returns a PSpec tree; the apply functions take the parameter
tree. The reference's ``shard(...)`` annotations are no-ops without a
mesh, and the port has none: they are dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.param import PSpec


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a shardable multiple (logits beyond v are masked)."""
    return ((v + multiple - 1) // multiple) * multiple


def norm_spec(d: int, kind: str = "rmsnorm"):
    if kind == "rmsnorm":
        return {"scale": PSpec((d,), ("embed",), "ones")}
    return {"scale": PSpec((d,), ("embed",), "ones"),
            "bias": PSpec((d,), ("embed",), "zeros")}


def apply_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm, or LayerNorm when ``p`` has a bias; fp32 inside, cast back
    to x's dtype."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotary embedding. x: (..., S, H, D); positions
    broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions[..., None].float() * freqs              # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def embedding_spec(vocab_padded: int, d: int, tie: bool):
    spec = {"table": PSpec((vocab_padded, d), ("vocab", "embed"), "embed",
                           0.02)}
    if not tie:
        spec["unembed"] = PSpec((d, vocab_padded), ("embed", "vocab"),
                                "normal")
    return spec


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def logits_fn(p, x: torch.Tensor, real_vocab: int) -> torch.Tensor:
    """fp32 logits over the padded vocab, -1e30 added past ``real_vocab``.
    The product runs in x's dtype (fp32 accumulation on the card) and is
    widened after it: in bf16 it rounds once where the reference's
    ``preferred_element_type=float32`` keeps fp32."""
    table = p.get("unembed")
    if table is None:
        table = p["table"].T
    logits = (x @ table).float()
    if logits.shape[-1] != real_vocab:
        logits[..., real_vocab:] += -1e30
    return logits


def mlp_spec(d: int, f: int, act: str):
    if act == "silu":  # gated
        return {"wi_gate": PSpec((d, f), ("embed", "ffn")),
                "wi_up": PSpec((d, f), ("embed", "ffn")),
                "wo": PSpec((f, d), ("ffn", "embed"))}
    return {"wi": PSpec((d, f), ("embed", "ffn")),
            "wo": PSpec((f, d), ("ffn", "embed"))}


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated silu, or ``wi`` then gelu (tanh form, as ``jax.nn.gelu``) or
    squared relu (any other act), then ``wo``."""
    if act == "silu":
        h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = x @ p["wi"]
        h = (F.gelu(h, approximate="tanh") if act == "gelu"
             else torch.relu(h).square())
    return h @ p["wo"]

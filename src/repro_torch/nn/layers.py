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


def sinusoid_freqs(d: int, device=None) -> torch.Tensor:
    """The d / 2 frequencies of Whisper's sinusoidal positions, in fp32 as
    the reference forms them: exp(-i log(10000) / (d / 2 - 1)), the log
    and the quotient taken in fp32."""
    half = d // 2
    step = torch.tensor(10_000.0, device=device).log() / (half - 1)
    return torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=device) * step)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings (n, d) fp32:
    sin of each position times each frequency, then cos."""
    ang = (torch.arange(n, dtype=torch.float32, device=device)[:, None]
           * sinusoid_freqs(d, device)[None, :])
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embedding_spec(vocab_padded: int, d: int, tie: bool):
    spec = {"table": PSpec((vocab_padded, d), ("vocab", "embed"), "embed",
                           0.02)}
    if not tie:
        spec["unembed"] = PSpec((d, vocab_padded), ("embed", "vocab"),
                                "normal")
    return spec


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def _parts(t: torch.Tensor, dtype: torch.dtype) -> tuple:
    """fp32 ``t`` beside a ``dtype`` operand: on the card, ``dtype`` hi +
    lo (16 significant bits for bf16), whose products with it sum to the
    product with ``t`` as far as fp32 keeps; else ``t`` alone."""
    if t.device.type != "cuda" or t.dtype == dtype:
        return (t,)
    hi = t.to(dtype)
    return hi, torch.sub(t, hi).to(dtype)


def _mm_f32(a_parts, b_parts) -> torch.Tensor:
    """The sum of a @ b over the 2-D ``a_parts`` and ``b_parts``, with fp32
    sums and an fp32 result. On the CPU the operands are widened and the
    product taken in fp32; on the card bf16 operands go to the tensor
    cores with an fp32 result (``torch.mm``'s ``out_dtype``)."""
    out = None
    for a in a_parts:
        for b in b_parts:
            y = (a.float() @ b.float() if a.device.type != "cuda"
                 else torch.mm(a, b, out_dtype=torch.float32))
            out = y if out is None else out.add_(y)
    return out


class _Logits(torch.autograd.Function):
    """x @ table in fp32 from bf16 x and table, -1e30 added past
    ``real_vocab``. The gradients take the fp32 cotangent as it is (on the
    card, as its two bf16 parts) and come back in bf16."""

    @staticmethod
    def forward(ctx, x, table, real_vocab: int):
        ctx.save_for_backward(x, table)
        out = _mm_f32((x.reshape(-1, x.shape[-1]),), (table,))
        if out.shape[-1] != real_vocab:
            out[:, real_vocab:] += -1e30
        return out.view(*x.shape[:-1], out.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g = _parts(g.reshape(-1, g.shape[-1]), table.dtype)
        dx = dt = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32(g, (table.T,)).to(x.dtype).view(x.shape)
        if ctx.needs_input_grad[1]:
            dt = _mm_f32((x.reshape(-1, x.shape[-1]).T,), g).to(table.dtype)
        return dx, dt, None


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w (w 2-D) with fp32 sums and an fp32 result, as the reference's
    ``preferred_element_type=float32``: the logits' product (``_Logits``)
    without a mask, its gradients included (the MoE router's)."""
    if x.dtype == w.dtype == torch.float32:
        return x @ w
    return _Logits.apply(x, w, w.shape[-1])


def logits_fn(p, x: torch.Tensor, real_vocab: int) -> torch.Tensor:
    """fp32 logits over the padded vocab, -1e30 added past ``real_vocab``:
    the product of x and the table in their dtype with fp32 sums and an
    fp32 result, as the reference's ``preferred_element_type=float32``."""
    table = p.get("unembed")
    if table is None:
        table = p["table"].T
    if x.dtype == table.dtype == torch.float32:
        logits = x @ table
        if logits.shape[-1] != real_vocab:
            logits[..., real_vocab:] += -1e30
        return logits
    return _Logits.apply(x, table, real_vocab)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, logsumexp - logit[label]. logits (..., V)
    fp32, labels (...) integer."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()


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

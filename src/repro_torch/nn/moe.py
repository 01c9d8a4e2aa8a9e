"""Mixture-of-Experts layer: top-k routing and a static-capacity grouped
matmul (counterpart of ``repro.nn.moe``, its mesh-free ``_moe_ffn_spmd``).

A token-to-expert dispatch is a bipartite-graph aggregate, HitGNN's own
operation: each (token, slot) pair is an edge from a token to an expert.
The layer runs in four parts that can be called alone:

* ``route``: the router's product (bf16 operands, fp32 sums and result,
  ``nn.layers.matmul_f32``), the softmax, the top-k experts in the
  reference's order (``jax.lax.top_k`` puts the lower index first among
  equal probabilities, so the port takes a stable descending sort; a plain
  ``torch.topk`` picks another order on ties), the renormalised weights and
  the load-balance aux loss over every token of the call;
* ``rank``: each pair's rank within its expert, counted per batch row over
  the pairs in token-major order, against a capacity C = ``capacity(S)``
  per batch row; a pair ranked C or later is dropped (Switch-style), and
  the rows the dispatch writes and the combine reads;
* ``dispatch`` and ``expert_ffn``: the kept pairs' tokens written into a
  static buffer of C rows an (expert, batch row), zeros where no pair
  landed, and the gated-silu experts over it as three batched products;
* ``combine``: each token's K rows read back, a dropped pair's row
  masked, weighted by the router's weights cast to the tokens' dtype and
  summed.

The buffer is laid out expert-major, (E, B, C) rows of d, with
``OVERFLOW_ROWS`` overflow rows after them, where the reference keeps
(B, E, C + 1): each kept pair lands in the same (expert, batch row, rank)
place as in the reference, and the experts' products read (E, B * C, d)
without a transpose. A dropped pair writes the overflow row its index
modulo ``OVERFLOW_ROWS`` names, which no product reads: spread, so that
the stores of thousands of dropped pairs do not queue on one row (the
reference sends them all to one slot C). The combine reads a dropped pair from a
row of its own (the pair's index modulo the buffer's rows) and masks it,
as the reference masks its clamped read, so the gradient of those reads
lands on many rows rather than summing one long run into one.

Determinism: no sum in the forward or backward depends on the order of
colliding writes. The dispatch is ``index_put_`` without accumulation
(its only colliding writes land in the overflow rows) and its backward a
gather; the combine's backward is ``index_put_(accumulate=True)`` through
autograd's indexing (a stable sort of the rows, each run summed in order
on the card). ``torch.utils.checkpoint`` recomputes the routing from the
same inputs by the same ops, so it routes as the forward did.

A decode step (S = 1) gets C = 8 rows an (expert, batch row): every
expert runs over its mostly empty rows and reads all of its weights, as
the reference's layer does at S = 1.

The reference's expert-parallel ``_moe_ffn_ep`` (a ``shard_map`` over a
TPU mesh's ``"model"`` axis) is not ported: the port has no LM mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoESpec
from repro_torch.nn.layers import matmul_f32
from repro_torch.nn.param import PSpec

# rows past the buffer that dropped pairs write, spread by pair index
OVERFLOW_ROWS = 1024


def moe_spec(d: int, f: int, m: MoESpec):
    e = m.num_experts
    ef = m.expert_d_ff or f
    return {
        "router": PSpec((d, e), ("embed", None)),
        "wi_gate": PSpec((e, d, ef), ("experts", "embed", "expert_ffn")),
        "wi_up": PSpec((e, d, ef), ("experts", "embed", "expert_ffn")),
        "wo": PSpec((e, ef, d), ("experts", "expert_ffn", "embed")),
    }


def capacity(n_tokens: int, m: MoESpec) -> int:
    c = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def ranked_probs(router_w: torch.Tensor, x: torch.Tensor):
    """x: (N, d) -> (the router's probabilities (N, E) fp32, and
    ``torch.sort``'s (values, indices) of them in descending order, the
    lower index first among equal ones)."""
    probs = torch.softmax(matmul_f32(x, router_w), dim=-1)
    return probs, torch.sort(probs, dim=-1, descending=True, stable=True)


def route(router_w: torch.Tensor, x: torch.Tensor, m: MoESpec):
    """x: (N, d) -> (weights (N, K) fp32, experts (N, K) int64, aux fp32
    scalar). The experts come in descending probability, the lower index
    first among equal ones; the aux loss is E * sum(mean(probs) *
    mean(assign) / K) over the N tokens."""
    K, E = m.top_k, m.num_experts
    probs, top = ranked_probs(router_w, x)
    weights, experts = top.values[:, :K], top.indices[:, :K]
    weights = weights / weights.sum(-1, keepdim=True)
    frac_prob = probs.mean(0)
    assign = torch.zeros_like(probs).scatter_(1, experts, 1.0)
    frac_tok = assign.mean(0) / K
    aux = E * (frac_prob * frac_tok).sum()
    return weights, experts, aux


class Slots(NamedTuple):
    """Where each (token, slot) pair of a (B, S, K) call goes: ``write``
    the buffer row the dispatch writes (an overflow row, E * B * C or
    past it, for a dropped pair), ``read`` the row the combine reads,
    ``keep`` whether the pair was kept; all (B, S, K). ``C`` rows an
    (expert, batch row)."""
    write: torch.Tensor
    read: torch.Tensor
    keep: torch.Tensor
    C: int


def rank(experts: torch.Tensor, m: MoESpec, C: int) -> Slots:
    """experts: (B, S, K). Each pair's rank within its expert, counted per
    batch row over the pairs in token-major order (a running count of a
    one-hot); a pair ranked C or later is dropped. The one-hot is laid out
    (B, E, S * K), so that the count runs along its innermost dim: along
    an outer dim the card's scan takes a thread a column (on an H100, 7.1
    ms a call at 1 x 32,768 pairs of 64 experts; this way 0.1 ms at 4 x
    32,768)."""
    B, S, K = experts.shape
    E = m.num_experts
    flat_e = experts.reshape(B, S * K)
    hot = flat_e[:, None, :] == torch.arange(E, device=experts.device)[:, None]
    pos = hot.cumsum(2, dtype=torch.int32)
    r = pos.gather(1, flat_e[:, None, :])[:, 0] - 1
    keep = r < C
    b = torch.arange(B, device=experts.device)[:, None]
    row = (flat_e * B + b) * C + r
    n_rows = E * B * C
    spread = torch.arange(B * S * K, device=experts.device).view(B, S * K)
    write = torch.where(keep, row, n_rows + spread % OVERFLOW_ROWS)
    read = torch.where(keep, row, spread % n_rows)
    return Slots(write.view(B, S, K), read.view(B, S, K), keep.view(B, S, K),
                 C)


def dispatch(x: torch.Tensor, slots: Slots, E: int) -> torch.Tensor:
    """x: (B, S, d) -> the (E, B * C, d) buffer: each kept pair's token in
    its row, zeros elsewhere. Each token is written K times from one read
    (``index_put_`` broadcasts it over its K rows)."""
    B, S, d = x.shape
    n_rows = E * B * slots.C
    buf = x.new_zeros((n_rows + OVERFLOW_ROWS, d)).index_put(
        (slots.write.reshape(B * S, -1),), x.reshape(B * S, 1, d))
    return buf[:n_rows].view(E, B * slots.C, d)


def expert_ffn(p, buf: torch.Tensor) -> torch.Tensor:
    """The gated-silu experts over the (E, rows, d) buffer: three batched
    products over the experts, in the buffer's dtype."""
    h = F.silu(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    return torch.bmm(h, p["wo"])


def combine(out_buf: torch.Tensor, weights: torch.Tensor,
            slots: Slots) -> torch.Tensor:
    """out_buf: (E, B * C, d); weights: (B, S, K). Each token's K rows,
    a dropped pair's row zeroed (as the reference masks its gathered
    rows, so a non-finite value in the row it read does not reach the
    sum), times the weights cast to the rows' dtype, summed over K:
    (B, S, d)."""
    d = out_buf.shape[-1]
    rows = out_buf.reshape(-1, d)[slots.read]               # (B, S, K, d)
    rows = torch.where(slots.keep[..., None], rows, 0.0)
    return (rows * weights.to(rows.dtype)[..., None]).sum(2)


def moe_ffn(p, x: torch.Tensor, m: MoESpec):
    """x: (B, S, d) or (N, d), taken as one batch row. Returns (out, aux
    loss). The capacity is per batch row, ``capacity(S)``; the routing
    (and so the aux loss) sees all B * S tokens."""
    orig_shape = x.shape
    d = x.shape[-1]
    if x.dim() == 2:
        x = x[None]
    B, S, _ = x.shape
    K, E = m.top_k, m.num_experts
    weights, experts, aux = route(p["router"], x.reshape(-1, d), m)
    slots = rank(experts.view(B, S, K), m, capacity(S, m))
    out_buf = expert_ffn(p, dispatch(x, slots, E))
    out = combine(out_buf, weights.view(B, S, K), slots)
    return out.reshape(orig_shape), aux

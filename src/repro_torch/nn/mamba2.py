"""Mamba2 (SSD, state-space duality) block: chunk-parallel for training
and prefill, one recurrent step for decode (counterpart of
``repro.nn.mamba2``).

The reference's SSD is plain JAX, not a Pallas kernel, and so is this: plain
PyTorch, cuBLAS's batched products on the card. Shapes: x (B, S, d); d_inner
= expand * d; H = d_inner / headdim heads of P = headdim; state N =
ssm_state.

``ssd_chunked`` cuts the sequence into chunks of L = the largest length at
most ``chunk`` that divides S (the reference's rule, so a ragged prompt
chunks as it does there). Within a chunk the decay matrix exp(cum_t -
cum_j), t >= j, turns the recurrence into products; the port forms it for
every chunk at once, and carries only the (B, H, P, N) state from chunk to
chunk, where the reference scans the whole chunk body. The sums run in
another order (allclose, not bitwise). Two differences are kept on purpose:

* the exponent is masked to -inf above the diagonal BEFORE the ``exp``.
  The reference takes ``exp`` of the whole (L, L) matrix and then zeroes
  the upper triangle; its forward is the same (exp(-inf) = 0 and every
  kept entry is equal), but past a summed log-decay of ~88.7 the upper
  triangle's ``exp`` is inf in fp32 and its gradient 0 x inf = NaN, which
  reaches ``dt``. Here the gradient stays finite;
* the reference's three-operand einsums are a scaling and one product:
  without ``opt_einsum`` ``torch.einsum`` contracts left to right and
  would form a (B, L, H, P, N) outer product first.

dtypes are the reference's: xdt, B, C, the state and y in fp32, the conv
summed term by term in the input's dtype, dt = softplus(fp32 + dt_bias),
the D skip in fp32 before the cast to x's dtype, and the gated RMSNorm with
its own eps of 1e-5. The reference's ``shard(...)`` annotations are
dropped: the port has no mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import HybridSpec
from repro_torch.nn.param import PSpec

CONV_K = 4  # causal depthwise conv width


def mamba2_spec(d: int, h: HybridSpec):
    d_in = h.ssm_expand * d
    n = h.ssm_state
    nheads = d_in // h.ssm_headdim
    conv_dim = d_in + 2 * n
    return {
        # in_proj -> [z (d_in), x (d_in), B (n), C (n), dt (nheads)]
        "w_in": PSpec((d, 2 * d_in + 2 * n + nheads), ("embed", "heads")),
        "conv_w": PSpec((CONV_K, conv_dim), (None, "heads")),
        "conv_b": PSpec((conv_dim,), ("heads",), "zeros"),
        "a_log": PSpec((nheads,), (None,), "ones"),
        "dt_bias": PSpec((nheads,), (None,), "zeros"),
        "d_skip": PSpec((nheads,), (None,), "ones"),
        "norm_scale": PSpec((d_in,), ("heads",), "ones"),
        "w_out": PSpec((d_in, d), ("heads", "embed")),
    }


def _split_proj(p, x: torch.Tensor, d_in: int, n: int, nheads: int):
    """(z, x, B, C, dt), views of one product of x and ``w_in``."""
    return torch.split(x @ p["w_in"], [d_in, d_in, n, n, nheads], dim=-1)


def _causal_conv(p, u: torch.Tensor, conv_state=None):
    """Depthwise causal conv of width 4, then silu. u: (B, S, C). Returns
    (y, new_state), the state the last CONV_K - 1 inputs (B, K - 1, C), a
    copy (a view would keep the whole (B, S + K - 1, C) input alive)."""
    B, S, C = u.shape
    if conv_state is None:
        conv_state = u.new_zeros((B, CONV_K - 1, C))
    ext = torch.cat([conv_state.to(u.dtype), u], dim=1)
    y = torch.zeros_like(u)
    for i in range(CONV_K):
        y = y + ext[:, i:i + S] * p["conv_w"][i]
    return F.silu(y + p["conv_b"]), ext[:, -(CONV_K - 1):].clone()


def conv_dt(p, xc: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
            dt: torch.Tensor, conv_state=None) -> tuple:
    """x, B and C through the causal conv (one input, split after), and
    dt = softplus(fp32 dt + dt_bias). Returns (x, B, C, dt, the conv's new
    state)."""
    out, new_state = _causal_conv(p, torch.cat([xc, Bm, Cm], dim=-1),
                                  conv_state)
    n = Bm.shape[-1]
    xc, Bm, Cm = torch.split(out, [out.shape[-1] - 2 * n, n, n], dim=-1)
    return xc, Bm, Cm, F.softplus(dt.float() + p["dt_bias"]), new_state


def chunk_len(S: int, chunk: int) -> int:
    """The reference's chunk: the largest L <= ``chunk`` dividing S."""
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L


def ssd_operands(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, L: int) -> tuple:
    """fp32 operands of the SSD cut into chunks of L: the log-decays la (b,
    nc, L, H), xdt = x dt (b, nc, L, H, P), B and C (b, nc, L, N)."""
    b, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = S // L
    A = -torch.exp(a_log.float())                           # (H,) negative
    la = (dt.float() * A).reshape(b, nc, L, H)              # log-decay <= 0
    xdt = (xh * dt[..., None]).float().reshape(b, nc, L, H, P)
    return (la, xdt, Bm.float().reshape(b, nc, L, N),
            Cm.float().reshape(b, nc, L, N))


def ssd_intra(la: torch.Tensor, xdt: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor) -> tuple:
    """The state-free terms of every chunk at once (``ssd_operands``'
    shapes). Returns (y_intra (b, nc, L, H, P), cum (b, nc, L, H) the
    inclusive cumulative log-decay, u (b, nc, H, P, N) each chunk's
    contribution to the state at its end)."""
    L = la.shape[2]
    cum = torch.cumsum(la, dim=2)
    cum_t = cum.transpose(2, 3)                              # (b,nc,H,L)
    keep = torch.ones((L, L), dtype=torch.bool, device=la.device).tril()
    # exp(cum_t - cum_j) for t >= j, the exponent masked before the exp
    lmat = (cum_t[..., :, None] - cum_t[..., None, :]).masked_fill(
        ~keep, float("-inf")).exp()                          # (b,nc,H,t,j)
    cb = Cm @ Bm.transpose(-1, -2)                           # (b,nc,t,j)
    x_t = xdt.permute(0, 1, 3, 2, 4)                         # (b,nc,H,L,P)
    y = (lmat * cb[:, :, None]) @ x_t                        # (b,nc,H,L,P)
    tail = (cum[:, :, -1:] - cum).exp()                      # (b,nc,L,H)
    xs = (xdt * tail[..., None]).permute(0, 1, 3, 4, 2)      # (b,nc,H,P,L)
    u = xs @ Bm[:, :, None]                                  # (b,nc,H,P,N)
    return y.permute(0, 1, 3, 2, 4), cum, u


def ssd_inter(y: torch.Tensor, cum: torch.Tensor, u: torch.Tensor,
              Cm: torch.Tensor) -> tuple:
    """The state's part: the (b, H, P, N) state carried from chunk to
    chunk from zero (the only serial walk), and each position's term
    exp(cum_t) C_t . (the state entering its chunk) added to ``y``.
    Returns (y (b, nc, L, H, P), the final state)."""
    b, nc, L, H, P = y.shape
    decay = cum[:, :, -1].exp()                              # (b,nc,H)
    state = u.new_zeros(u[:, 0].shape)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * decay[:, c, :, None, None] + u[:, c]
    cs = torch.stack(entering, dim=1).flatten(2, 3) @ Cm.transpose(-1, -2)
    cs = cs.view(b, nc, H, P, L).permute(0, 1, 4, 2, 3)     # (b,nc,L,H,P)
    return y + cs * cum.exp()[..., None], state


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """Chunk-parallel SSD. xh (B, S, H, P); dt (B, S, H); Bm, Cm (B, S,
    N). Returns (y (B, S, H, P) fp32, final_state (B, H, P, N) fp32)."""
    ops = ssd_operands(xh, dt, a_log, Bm, Cm, chunk_len(xh.shape[1], chunk))
    y, cum, u = ssd_intra(*ops)
    y, state = ssd_inter(y, cum, u, ops[3])
    return y.reshape(xh.shape), state


def ssd_step(state: torch.Tensor, xh: torch.Tensor, dt: torch.Tensor,
             a_log: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor):
    """One recurrent step. state (B, H, P, N); xh (B, H, P); dt (B, H); Bm,
    Cm (B, N). Returns (y (B, H, P), new_state), fp32."""
    A = -torch.exp(a_log.float())
    decay = torch.exp(dt.float() * A)                       # (B, H)
    xdt = (xh * dt[..., None]).float()
    state = (state * decay[..., None, None]
             + xdt[..., None] * Bm.float()[:, None, None, :])
    y = (state @ Cm.float()[:, None, :, None])[..., 0]
    return y, state


def gated_norm(p, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The D skip in fp32 (y (B, S, H, P) fp32, xh its input), the cast to
    ``dtype``, the silu(z) gate, then the gated RMSNorm (fp32 inside, its
    own eps 1e-5), in ``dtype``."""
    B, S, H, P = y.shape
    y = y + xh.to(y.dtype) * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, H * P).to(dtype) * F.silu(z)
    yf = y.float()
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + 1e-5) * p["norm_scale"]).to(dtype)


def mamba2_block(p, x: torch.Tensor, h: HybridSpec, *, mode: str = "train",
                 state=None):
    """The whole Mamba2 block. x (B, S, d) (S = 1 for decode). ``state``:
    None or {"conv": (B, K - 1, conv_dim), "ssm": (B, H, P, N)}; prefill
    and training start from zeros, as in the reference. Returns (out (B, S,
    d), {"conv", "ssm"})."""
    Bsz, S, d = x.shape
    d_in = h.ssm_expand * d
    n = h.ssm_state
    P = h.ssm_headdim
    H = d_in // P

    z, xc, Bm, Cm, dt = _split_proj(p, x, d_in, n, H)
    xc, Bm, Cm, dt, new_conv = conv_dt(
        p, xc, Bm, Cm, dt, None if state is None else state["conv"])
    xh = xc.reshape(Bsz, S, H, P)

    if mode == "decode":
        ssm = (state["ssm"] if state is not None else
               x.new_zeros((Bsz, H, P, n), dtype=torch.float32))
        y, new_ssm = ssd_step(ssm, xh[:, 0], dt[:, 0], p["a_log"],
                              Bm[:, 0], Cm[:, 0])
        y = y[:, None]
    else:
        y, new_ssm = ssd_chunked(xh, dt, p["a_log"], Bm, Cm, h.ssm_chunk)

    y = gated_norm(p, y, xh, z, x.dtype)
    return y @ p["w_out"], {"conv": new_conv, "ssm": new_ssm}

"""RWKV-6 (Finch) block: time-mix with data-dependent decay + channel-mix
(counterpart of ``repro.nn.rwkv6``).

WKV6 recurrence per head (K = V = head_size):
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t in (0,1), data-dependent

* prefill and training (S > 1): ``kernels.wkv6.WKV6Chunk``, the CUDA
  kernel ``wkv6_chunk`` on the card and its plain version on the CPU, in
  chunks of 16 (the reference's ``wkv6_chunked`` default;
  ``RWKVSpec.chunk`` is not read), returning the final state that decode
  starts from; its gradient is the CUDA kernel ``wkv6_chunk_bwd`` (the
  reference differentiates ``wkv6_chunked`` by ``jax.vjp``). Serving runs
  without autograd and launches only the forward;
* decode (S = 1): ``wkv6_recurrent``, plain PyTorch.

r, k and v stay in the model's dtype and the log-decay ``lw`` in fp32, as
the reference hands them to its core.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RWKVSpec
from repro_torch.kernels.wkv6 import WKV6Chunk
from repro_torch.nn.layers import apply_norm
from repro_torch.nn.param import PSpec

_MIX = ("r", "k", "v", "w", "g")


def timemix_spec(d: int, r: RWKVSpec):
    hs = r.head_size
    H = d // hs
    lora = r.decay_lora
    sp = {
        "mu_base": PSpec((len(_MIX), d), (None, "embed"), "zeros"),
        "mix_lora_a": PSpec((d, len(_MIX) * 32), ("embed", None)),
        "mix_lora_b": PSpec((len(_MIX), 32, d), (None, None, "embed")),
        "w_base": PSpec((d,), ("embed",), "zeros"),
        "w_lora_a": PSpec((d, lora), ("embed", None)),
        "w_lora_b": PSpec((lora, d), (None, "embed")),
        "u": PSpec((H, hs), ("heads", None), "zeros"),
        "ln_scale": PSpec((d,), ("embed",), "ones"),
        "ln_bias": PSpec((d,), ("embed",), "zeros"),
    }
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        sp[nm] = PSpec((d, d), ("embed", "ffn"))
    return sp


def channelmix_spec(d: int, f: int):
    return {
        "mu_k": PSpec((d,), ("embed",), "zeros"),
        "mu_r": PSpec((d,), ("embed",), "zeros"),
        "wk": PSpec((d, f), ("embed", "ffn")),
        "wv": PSpec((f, d), ("ffn", "embed")),
        "wr": PSpec((d, d), ("embed", "ffn")),
    }


def wkv6_recurrent(r, k, v, lw, u, state):
    """Exact per-token recurrence, in fp32. r/k/v: (B, S, H, K|V); lw: (B,
    S, H, K) log-decay (<= 0); u: (H, K) or per batch (B, H, K); state: (B,
    H, K, V) or None (zeros). Returns (y (B, S, H, V) fp32, final state
    fp32)."""
    f32 = torch.float32
    r, k, v, lw = (a.to(f32) for a in (r, k, v, lw))
    uf = (u if u.dim() == 3 else u[None]).to(f32)[..., None]
    B, _, H, K = k.shape
    V = v.shape[-1]
    s = (torch.zeros((B, H, K, V), dtype=f32, device=k.device)
         if state is None else state.to(f32))
    ys = []
    for t in range(k.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B, H, K, V)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + uf * kv))
        s = torch.exp(lw[:, t])[..., None] * s + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, H, V), dtype=f32, device=k.device))
    return y, s


def _ddlerp(p, x, x_prev):
    """Finch data-dependent token-shift: one lerp per mix target."""
    dx = x_prev - x                                     # (B, S, d)
    low = torch.tanh((x + dx * 0.5) @ p["mix_lora_a"])
    low = low.unflatten(-1, (len(_MIX), 32))
    dyn = torch.einsum("bsmr,mrd->bsmd", low, p["mix_lora_b"])
    mu = p["mu_base"][None, None] + dyn                 # (B, S, 5, d)
    return x[:, :, None] + dx[:, :, None] * mu          # (B, S, 5, d)


def _shifted(x, state):
    """x one token later: the state's shift (zeros without one) first."""
    B, _, d = x.shape
    first = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
             if state is None else state["shift"][:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def timemix(p, x, spec: RWKVSpec, *, state=None):
    """x: (B, S, d). state: {"shift": (B, d), "wkv": (B, H, K, V)} or None.
    Returns (out, new_state)."""
    B, S, d = x.shape
    hs = spec.head_size
    H = d // hs
    mixed = _ddlerp(p, x, _shifted(x, state))
    xr, xk, xv, xw, xg = mixed.unbind(2)

    r = (xr @ p["wr"]).reshape(B, S, H, hs)
    k = (xk @ p["wk"]).reshape(B, S, H, hs)
    v = (xv @ p["wv"]).reshape(B, S, H, hs)
    g = xg @ p["wg"]
    # data-dependent decay (the Finch contribution): w = exp(-exp(base+lora))
    wl = p["w_base"] + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    lw = -torch.exp(wl.float()).reshape(B, S, H, hs)    # log w <= 0

    wkv = None if state is None else state["wkv"]      # None: zeros
    if S > 1:
        y, new_wkv = WKV6Chunk.apply(r, k, v, lw, p["u"].to(r.dtype), wkv)
    else:
        y, new_wkv = wkv6_recurrent(r, k, v, lw, p["u"], wkv)

    y = y.reshape(B, S, d).to(x.dtype)
    y = apply_norm({"scale": p["ln_scale"], "bias": p["ln_bias"]}, y)
    out = (y * F.silu(g)) @ p["wo"]
    return out, {"shift": x[:, -1], "wkv": new_wkv}


def channelmix(p, x, *, state=None):
    """x: (B, S, d). state: {"shift": (B, d)} or None."""
    dx = _shifted(x, state) - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    h = torch.relu(xk @ p["wk"]).square()
    out = torch.sigmoid(xr @ p["wr"]) * (h @ p["wv"])
    return out, {"shift": x[:, -1]}

"""Plain oracles of the LM zoo's kernels (the counterparts of
``repro.kernels.ref.attention_ref`` and ``wkv6_ref``), in the reference's
flattened layout: q (BH, Sq, D), k and v (BH, Sk, D); r, k, lw (BH, S, K),
v (BH, S, V), u (BH, 1, K). Each is the port's plain version in the model's
(B, S, H, D) layout with one head per row: softmax attention with the
scores materialised (``flash_attention_plain``), and the per-token WKV6
recurrence from a zero state (``nn.rwkv6.wkv6_recurrent``). Both compute
in fp32 and return q's (r's) dtype."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.nn.rwkv6 import wkv6_recurrent


def attention_ref(q, k, v, causal: bool = True):
    """Plain softmax attention."""
    return flash_attention_plain(q[:, :, None], k[:, :, None],
                                 v[:, :, None], causal)[:, :, 0]


def wkv6_ref(r, k, v, lw, u):
    """Exact WKV6 recurrence, one token at a time from a zero state."""
    y, _ = wkv6_recurrent(r[:, :, None], k[:, :, None], v[:, :, None],
                          lw[:, :, None], u, None)
    return y[:, :, 0].to(r.dtype)

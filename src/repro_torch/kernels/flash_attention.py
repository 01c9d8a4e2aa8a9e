"""Flash attention forward (counterpart of
``repro.kernels.flash_attention.flash_attention_fwd``), the LM zoo's
prefill attention.

``flash_attention_fwd`` takes a CUDA tensor to the hand-written kernel
``csrc/flash_attention_fwd.cu`` — or raises — and a CPU tensor to
``flash_attention_plain``, the same function in plain PyTorch, which the
tests hold against the reference's Pallas kernel and its oracle.

Layout: the wrappers take the model's (B, S, H, D) query and (B, S, KH, D)
keys and values, with query head h reading kv head h // G (``jnp.repeat(k,
G, axis=2)``). The kernel reads each operand through its strides and maps
the head itself, so the model's projections go in without a transpose and
the GQA repeat is never materialised. The reference's flattened (BH, S, D)
layout is the case H = KH = 1 (``kernels/ops.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import launch_counts, on_card, raise_on, stream

launch_counts.update(flash_attention_fwd=0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention_fwd_launch": ([_P] * 4 + [ctypes.POINTER(
        ctypes.c_longlong)] + [_I] * 8 + [_P], _I),
    "flash_attention_fwd_smem_bytes": ([_I], _I),
}
# element types the kernel takes, by the code csrc/typed_io.cuh uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MASK = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain version: softmax attention with the (Sq, Sk) scores and
    probabilities materialised in fp32 (the reference's ``attention_ref``),
    kv head h // G for query head h, -1e30 above the diagonal under a
    causal mask. Returns (B, Sq, H, D) in q's dtype."""
    G = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / (q.shape[-1] ** 0.5)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill_(~keep, MASK)
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, H, D)")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"{H} query heads do not share {k.shape[2]} kv "
                         f"heads evenly")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) [causal]) v: q (B, Sq, H, D), k and v (B, Sk,
    KH, D) with KH dividing H. Returns (B, Sq, H, D) in q's dtype,
    contiguous. Under ``causal`` positions are aligned at 0 (query i sees
    keys j <= i). A CUDA tensor goes through
    ``csrc/flash_attention_fwd.cu`` (float32 or bfloat16, D <= 128, the
    last dim contiguous, any other strides); a CPU tensor through
    ``flash_attention_plain``."""
    _check(q, k, v)
    if not on_card("flash_attention_fwd", q):
        return flash_attention_plain(q, k, v, causal)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_fwd takes {sorted(map(str, DTYPES))}"
                        f", not {q.dtype}")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if D > 128:
        raise ValueError(f"head dim {D} > 128: the kernel holds a head's "
                         f"rows in shared memory up to 128")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in (t.stride(0), t.stride(1),
                                                   t.stride(2))))
    with torch.cuda.device(q.device):
        status = build.bind(
            "flash_attention_fwd", _SIGNATURES).flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, B, H, H // KH, Sq, Sk, D, int(causal), DTYPES[q.dtype],
            stream(q))
    raise_on(status, "flash_attention_fwd", "flash_attention_fwd")
    launch_counts["flash_attention_fwd"] += 1
    return out


def flash_attention_fwd_smem_bytes(D: int) -> int:
    """Dynamic shared memory of one thread block at head dim ``D`` (builds
    the kernel)."""
    return build.bind("flash_attention_fwd",
                      _SIGNATURES).flash_attention_fwd_smem_bytes(D)

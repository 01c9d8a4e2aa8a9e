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

The dtype picks the kernel's route (``ROUTES``): bfloat16, the dtype the
models serve in, runs both products on the tensor cores (``wgmma``) on
operands that TMA copies into shared memory, which needs 16-byte aligned
base addresses and strides (``check_tma_operands``: the wrapper raises
rather than copy); float32 keeps the fp32 FMA kernel (``fma``), the route
of the fp32 consistency checks at the reference's tolerances.
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
    "flash_attention_fwd_smem_bytes": ([_I, _I], _I),
}
# element types the kernel takes, by the code csrc/typed_io.cuh uses, and
# the route each takes through csrc/flash_attention_fwd.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "fma", torch.bfloat16: "wgmma"}
_TMA_ALIGN = 16  # bytes: TMA's base address and stride granule
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


def check_tma_operands(*tensors: torch.Tensor) -> None:
    """Raises ValueError unless each (B, S, H, D) operand can be read by
    TMA as the wgmma route reads it: D a multiple of 8 elements, the last
    dim contiguous, the base address and the stride of every other dim
    longer than 1 multiples of 16 bytes (a dim of length 1 is never
    stepped along)."""
    for t in tensors:
        D = t.shape[-1]
        if (D * t.element_size()) % _TMA_ALIGN:
            raise ValueError(f"head dim {D} of {t.dtype} is not a multiple of "
                             f"{_TMA_ALIGN} bytes, which TMA needs")
        if t.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous")
        if t.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"an operand starts at {t.data_ptr():#x}, not on "
                             f"a {_TMA_ALIGN}-byte boundary, which TMA needs")
        for dim in range(t.dim() - 1):
            if t.shape[dim] > 1 and (t.stride(dim) * t.element_size()
                                     ) % _TMA_ALIGN:
                raise ValueError(
                    f"stride {t.stride(dim)} of dim {dim} of a "
                    f"{tuple(t.shape)} operand is not a multiple of "
                    f"{_TMA_ALIGN} bytes, which TMA needs")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) [causal]) v: q (B, Sq, H, D), k and v (B, Sk,
    KH, D) with KH dividing H. Returns (B, Sq, H, D) in q's dtype,
    contiguous. Under ``causal`` positions are aligned at 0 (query i sees
    keys j <= i). A CUDA tensor goes through
    ``csrc/flash_attention_fwd.cu`` (D <= 128, the last dim contiguous,
    any other strides; bfloat16 on the wgmma route, whose operands must
    pass ``check_tma_operands``, float32 on the FMA route); a CPU tensor
    through ``flash_attention_plain``."""
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
    if ROUTES[q.dtype] == "wgmma":
        check_tma_operands(q, k, v)
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


def flash_attention_fwd_smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one thread block at head dim ``D`` on
    ``dtype``'s route (builds the kernel)."""
    return build.bind("flash_attention_fwd",
                      _SIGNATURES).flash_attention_fwd_smem_bytes(
        D, DTYPES[dtype])

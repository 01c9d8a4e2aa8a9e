"""Flash attention (counterpart of
``repro.kernels.flash_attention.flash_attention_fwd`` and of the
reference's training attention, ``repro.nn.attention._flash_core``): the
LM zoo's prefill attention, and its gradient for training.

``flash_attention_fwd`` takes a CUDA tensor to the hand-written kernel
``csrc/flash_attention_fwd.cu`` — or raises — and a CPU tensor to
``flash_attention_plain``, the same function in plain PyTorch, which the
tests hold against the reference's Pallas kernel and its oracle. With
``return_lse`` it also returns each row's log-sum-exp, (B, H, Sq) fp32,
which ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``, plain
version ``flash_attention_bwd_plain``) reads to give dq, dk and dv, as the
reference's ``_flash_core_bwd`` does. ``FlashAttention`` joins the two in
one ``torch.autograd.Function``.

Layout: the wrappers take the model's (B, S, H, D) query and (B, S, KH, D)
keys and values, with query head h reading kv head h // G (``jnp.repeat(k,
G, axis=2)``). The kernel reads each operand through its strides and maps
the head itself, so the model's projections go in without a transpose and
the GQA repeat is never materialised. The reference's flattened (BH, S, D)
layout is the case H = KH = 1 (``kernels/ops.py``).

The dtype picks the route of both kernels (``ROUTES``): bfloat16, the
dtype the models serve and train in, runs every product on the tensor
cores (``wgmma``: the forward's two, the backward's seven) on operands that
TMA copies into shared memory, which needs 16-byte aligned base addresses
and strides (``check_tma_operands`` on q, k, v and, for the backward, o and
do: the wrappers raise rather than copy); float32 keeps the fp32 FMA
kernels (``fma``), the route of the fp32 checks at the reference's
tolerances.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import launch_counts, on_card, raise_on, stream

launch_counts.update(flash_attention_fwd=0, flash_attention_bwd=0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_LL = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "flash_attention_fwd_launch": ([_P] * 5 + [_LL] + [_I] * 8 + [_P], _I),
    "flash_attention_fwd_smem_bytes": ([_I, _I], _I),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd_launch": ([_P] * 10 + [_LL] + [_I] * 8 + [_P], _I),
    "flash_attention_bwd_smem_bytes": ([_I, _I, _I], _I),
    "flash_attention_bwd_scratch_floats": ([_I] * 4, ctypes.c_longlong),
}
# element types the kernels take, by the code csrc/typed_io.cuh uses, and
# the route each takes through csrc/flash_attention_fwd.cu and
# csrc/flash_attention_bwd.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "fma", torch.bfloat16: "wgmma"}
_TMA_ALIGN = 16  # bytes: TMA's base address and stride granule
MASK = -1e30


def _scores(q: torch.Tensor, kf: torch.Tensor, causal: bool,
            scale) -> torch.Tensor:
    """(B, H, Sq, Sk) fp32 scores q k^T ``scale`` (a float multiplies, as
    the backward does; None divides by sqrt(D), as the forward always has),
    -1e30 above the diagonal under a causal mask (positions aligned at 0);
    ``kf``: fp32, repeated to q's heads."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf)
    s = s / (q.shape[-1] ** 0.5) if scale is None else s * scale
    if causal:
        Sq, Sk = q.shape[1], kf.shape[1]
        keep = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill_(~keep, MASK)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, return_lse: bool = False):
    """Plain version: softmax attention with the (Sq, Sk) scores and
    probabilities materialised in fp32 (the reference's ``attention_ref``),
    kv head h // G for query head h, -1e30 above the diagonal under a
    causal mask. Returns (B, Sq, H, D) in q's dtype, and with
    ``return_lse`` also the rows' log-sum-exp of the scaled, masked scores,
    (B, H, Sq) fp32."""
    G = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = _scores(q, kf, causal, None)
    lse = torch.logsumexp(s, dim=-1) if return_lse else None
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd_terms(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True) -> tuple:
    """The backward's (B, H, Sq, Sk) fp32 matrices before any rounding:
    p = exp(s - lse) and ds = p (dp - delta) / sqrt(D), with delta =
    rowsum(do o) and dp = do v^T, k and v repeated to q's heads."""
    G = q.shape[2] // k.shape[2]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    kf = k.float().repeat_interleave(G, dim=2)
    p = torch.exp(_scores(q, kf, causal, scale) - lse[..., None])
    del kf
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)      # (B, H, Sq)
    ds = torch.einsum("bqhd,bkhd->bhqk", dof,
                      v.float().repeat_interleave(G, dim=2))
    ds = p * (ds - delta[..., None]) * scale
    return p, ds


def flash_attention_bwd_products(p: torch.Tensor, ds: torch.Tensor,
                                 q: torch.Tensor, k: torch.Tensor,
                                 do: torch.Tensor) -> tuple:
    """dq = ds k, dk = ds^T q and dv = p^T do in fp32 from p and ds as
    given, dk and dv summed over the G query heads of each of k's heads."""
    KH = k.shape[2]
    G = q.shape[2] // KH
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      k.float().repeat_interleave(G, dim=2))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return (dq, dk.unflatten(2, (KH, G)).sum(3),
            dv.unflatten(2, (KH, G)).sum(3))


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True):
    """Plain version of the backward, the reference's ``_flash_core_bwd``
    with the (Sq, Sk) matrices materialised in fp32: delta = rowsum(do o),
    p = exp(s - lse), ds = p (dp - delta) / sqrt(D); p rounded to do's
    dtype before dv = p^T do, ds to k's before dq = ds k and dk = ds^T q;
    dk and dv summed over the G query heads of each kv head in fp32, then
    rounded once. Returns (dq, dk, dv) in their operands' dtypes."""
    p, ds = flash_attention_bwd_terms(q, k, v, o, lse, do, causal)
    p = p.to(do.dtype).float()
    ds = ds.to(k.dtype).float()
    dq, dk, dv = flash_attention_bwd_products(p, ds, q, k, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
                        causal: bool = True, return_lse: bool = False):
    """softmax(q k^T / sqrt(D) [causal]) v: q (B, Sq, H, D), k and v (B, Sk,
    KH, D) with KH dividing H. Returns (B, Sq, H, D) in q's dtype,
    contiguous, and with ``return_lse`` also the rows' log-sum-exp, (B, H,
    Sq) fp32 (asking for it leaves the output's bits as they were). Under
    ``causal`` positions are aligned at 0 (query i sees keys j <= i). A
    CUDA tensor goes through ``csrc/flash_attention_fwd.cu`` (D <= 128, the
    last dim contiguous, any other strides; bfloat16 on the wgmma route,
    whose operands must pass ``check_tma_operands``, float32 on the FMA
    route); a CPU tensor through ``flash_attention_plain``."""
    _check(q, k, v)
    if not on_card("flash_attention_fwd", q):
        return flash_attention_plain(q, k, v, causal, return_lse)
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
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if ROUTES[q.dtype] == "wgmma":
        check_tma_operands(q, k, v)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in (t.stride(0), t.stride(1),
                                                   t.stride(2))))
    with torch.cuda.device(q.device):
        status = build.bind(
            "flash_attention_fwd", _SIGNATURES).flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), strides, B, H, H // KH,
            Sq, Sk, D, int(causal), DTYPES[q.dtype], stream(q))
    raise_on(status, "flash_attention_fwd", "flash_attention_fwd")
    launch_counts["flash_attention_fwd"] += 1
    return (out, lse) if return_lse else out


def flash_attention_fwd_smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one thread block at head dim ``D`` on
    ``dtype``'s route (builds the kernel)."""
    return build.bind("flash_attention_fwd",
                      _SIGNATURES).flash_attention_fwd_smem_bytes(
        D, DTYPES[dtype])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True):
    """dq, dk and dv of ``flash_attention_fwd`` at its output ``o`` (as it
    returned it) and log-sum-exp ``lse`` (B, H, Sq) fp32, for the output
    gradient ``do`` (B, Sq, H, D). Returns dq (B, Sq, H, D) and dk, dv (B,
    Sk, KH, D) in their operands' dtype, contiguous; dk and dv sum the G
    query heads of each kv head. A CUDA tensor goes through
    ``csrc/flash_attention_bwd.cu`` (D <= 128, the last dim contiguous, any
    other strides; bfloat16 on the wgmma route, whose q, k, v, o and do
    must pass ``check_tma_operands``, float32 on the FMA route), a CPU
    tensor through ``flash_attention_bwd_plain``."""
    _check(q, k, v)
    B, Sq, H, D = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; q is {tuple(q.shape)} {q.dtype} "
                             f"on {q.device}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be ({B}, {H}, {Sq}) float32 on "
                         f"{q.device}, not {tuple(lse.shape)} {lse.dtype} "
                         f"on {lse.device}")
    if not on_card("flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention_bwd takes {sorted(map(str, DTYPES))}"
                        f", not {q.dtype}")
    if D > 128:
        raise ValueError(f"head dim {D} > 128: the kernel holds a head's "
                         f"rows in shared memory up to 128")
    Sk, KH = k.shape[1], k.shape[2]
    q, k, v, o, do = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (q, k, v, o, do))
    if ROUTES[q.dtype] == "wgmma":
        check_tma_operands(q, k, v, o, do)
    lse = lse.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv)
        for s in (t.stride(0), t.stride(1), t.stride(2))))
    with torch.cuda.device(q.device):
        lib = build.bind("flash_attention_bwd", _BWD_SIGNATURES)
        delta = torch.empty(lib.flash_attention_bwd_scratch_floats(
            B, H, Sq, DTYPES[q.dtype]), dtype=torch.float32, device=q.device)
        status = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), strides, B, H, H // KH, Sq, Sk, D,
            int(causal), DTYPES[q.dtype], stream(q))
    raise_on(status, "flash_attention_bwd", "flash_attention_bwd")
    launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_bwd_smem_bytes(D: int, dtype: torch.dtype) -> dict:
    """Dynamic shared memory of one thread block of each of the backward's
    passes, {"dq": bytes, "dkdv": bytes}, at head dim ``D`` on ``dtype``'s
    route (builds the kernel)."""
    lib = build.bind("flash_attention_bwd", _BWD_SIGNATURES)
    return {name: lib.flash_attention_bwd_smem_bytes(D, DTYPES[dtype], i)
            for i, name in enumerate(("dq", "dkdv"))}


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient (the reference's ``_flash_core``
    and its ``custom_vjp``): the forward keeps q, k, v, the output and the
    log-sum-exp, and the backward recomputes the probabilities from them,
    so no (Sq, Sk) matrix outlives a call. k and v come unrepeated (kv head
    h // G for query head h)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fwd(q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None

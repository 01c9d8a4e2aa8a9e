"""The RWKV-6 WKV recurrence in chunks (counterpart of
``repro.kernels.wkv6.wkv6_chunk``), RWKV-6's prefill core.

``wkv6_chunk`` takes a CUDA tensor to the hand-written kernel
``csrc/wkv6_chunk.cu`` — or raises — and a CPU tensor to
``wkv6_chunk_plain``, the same function in plain PyTorch, which the tests
hold against the reference's Pallas kernel, its oracle and the model's
``wkv6_chunked``.

Both take the model's layout, r, k, v and lw (B, S, H, K) with u (H, K),
read an initial state (zeros for prefill, the TPU kernel's ``_init``) and
return the final (B, H, K, V) fp32 state beside y, which the model's
decode needs and the TPU kernel drops. The reference's flattened (BH, S,
K) layout with a (BH, 1, K) bonus is the case H = 1 with a per-batch u
(``kernels/ops.py``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import (check_tensor, launch_counts, on_card,
                                       raise_on, sm_count, stream)

launch_counts.update(wkv6_chunk=0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"wkv6_chunk_launch": ([_P] * 8 + [_I] * 4
                                     + [ctypes.c_longlong, _I, _I, _P], _I),
               "wkv6_chunk_smem_bytes": ([_I, _I, _I], _I)}
# element types of r, k, v, u and y, by the code csrc/typed_io.cuh uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)
CHUNK = 16   # the kernel's chunk length, the model's default


def wkv6_chunk_plain(r, k, v, lw, u, state=None, chunk: int = CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the TPU kernel's arithmetic in fp32: chunks of
    ``chunk`` tokens walked in order with the state carried across, a
    ragged last chunk taken as it is. r, k, lw (B, S, H, K); v (B, S, H,
    V); u (H, K) or (B, H, K); state (B, H, K, V) or None (zeros). Returns
    (y (B, S, H, V) in r's dtype, final state (B, H, K, V) fp32)."""
    B, S, H, K = k.shape
    V = v.shape[-1]
    f32 = torch.float32
    uf = (u if u.dim() == 3 else u[None]).to(f32)           # (B|1, H, K)
    s = (torch.zeros((B, H, K, V), dtype=f32, device=k.device)
         if state is None else state.to(f32).clone())
    ys = []
    for t0 in range(0, S, chunk):
        rc, kc, vc, lwc = (a[:, t0:t0 + chunk].to(f32) for a in (r, k, v, lw))
        L = kc.shape[1]
        c = torch.cumsum(lwc, dim=1)                         # inclusive
        c_excl = c - lwc
        y = torch.einsum("blhk,bhkv->blhv", rc * torch.exp(c_excl), s)
        # A[t, j] = sum_k r_tk k_jk exp(c_excl_tk - c_jk), j < t only
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                    device=k.device), diagonal=-1)
        dec = c_excl[:, :, None] - c[:, None, :]             # (B, t, j, H, K)
        m = torch.exp(dec.masked_fill_(~tri[None, :, :, None, None], -1e30))
        A = torch.einsum("blhk,bmhk,blmhk->blmh", rc, kc, m)
        y = y + torch.einsum("blmh,bmhv->blhv", A, vc)
        y = y + ((rc * uf[:, None]) * kc).sum(-1, keepdim=True) * vc
        ys.append(y)
        tail = torch.exp(c[:, -1:] - c)
        s = torch.exp(c[:, -1])[..., None] * s + torch.einsum(
            "blhk,blhv->bhkv", kc * tail, vc)
    y = (torch.cat(ys, dim=1) if ys
         else torch.zeros((B, 0, H, V), dtype=f32, device=k.device))
    return y.to(r.dtype), s


def check_aligned(**tensors: torch.Tensor) -> None:
    """Raises unless every given tensor starts on a 16-byte boundary: the
    kernel copies r, k, v and lw rows with 16-byte ``cp.async``. Rows are
    K elements (K >= 16) apart, so they are aligned once the base is."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6_chunk: {name} must start on a 16-byte "
                             f"boundary for the kernel's copies (it starts "
                             f"at {t.data_ptr() % 16} past one)")


def heads_per_block(heads: int, sms: int) -> int:
    """Heads each thread block of the kernel runs: two when the B x H
    heads outnumber the card's ``sms`` SMs, so the second head on an SM
    runs in step with the first inside one block (the same code, 128
    registers a thread) rather than as a second block; else one, which
    may take up to 255 registers a thread."""
    return 2 if heads > sms else 1


def wkv6_chunk_smem_bytes(K: int, dtype: torch.dtype, hpb: int) -> int:
    """Dynamic shared memory of one thread block of ``hpb`` heads (builds
    the kernel)."""
    return build.bind("wkv6_chunk", _SIGNATURES).wkv6_chunk_smem_bytes(
        K, DTYPES[dtype], hpb)


def _check(r, k, v, lw, u, state) -> None:
    if r.dim() != 4 or r.shape != k.shape or r.shape != lw.shape \
            or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and lw {tuple(lw.shape)} must be "
                         f"(B, S, H, K|V)")
    B, _, H, K = r.shape
    if tuple(u.shape) not in ((H, K), (B, H, K)):
        raise ValueError(f"u has shape {tuple(u.shape)}; expected ({H}, {K}) "
                         f"or ({B}, {H}, {K})")
    if state is not None and tuple(state.shape) != (B, H, K, v.shape[-1]):
        raise ValueError(f"state has shape {tuple(state.shape)}; expected "
                         f"({B}, {H}, {K}, {v.shape[-1]})")


def wkv6_chunk(r, k, v, lw, u, state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence over r, k, v, lw (B, S, H, K), u (H, K) or (B,
    H, K), from ``state`` (B, H, K, V) fp32 (None: zeros). Returns (y (B, S,
    H, V) in r's dtype, final state fp32). A CUDA tensor goes through
    ``csrc/wkv6_chunk.cu`` (r, k, v, u float32 or bfloat16 alike, lw and
    the state float32, K = V in 16, 32, 64, every tensor contiguous, r, k,
    v and lw 16-byte aligned), in chunks of 16; a CPU tensor through
    ``wkv6_chunk_plain``."""
    _check(r, k, v, lw, u, state)
    if not on_card("wkv6_chunk", r):
        return wkv6_chunk_plain(r, k, v, lw, u, state)
    B, S, H, K = r.shape
    if r.dtype not in DTYPES:
        raise TypeError(f"wkv6_chunk takes r, k, v in "
                        f"{sorted(map(str, DTYPES))}, not {r.dtype}")
    if K not in HEAD_SIZES or v.shape[-1] != K:
        raise ValueError(f"the kernel is built for K = V in {HEAD_SIZES}; "
                         f"got K {K}, V {v.shape[-1]}")
    for name, t in (("r", r), ("k", k), ("v", v), ("u", u)):
        check_tensor(name, t, r.device, r.dtype)
    check_tensor("lw", lw, r.device, torch.float32)
    if state is not None:
        check_tensor("state", state, r.device, torch.float32)
    check_aligned(r=r, k=k, v=v, lw=lw)
    y = torch.empty_like(v)
    s_out = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    if S == 0:
        s_out.copy_(state if state is not None else torch.zeros_like(s_out))
        return y, s_out
    with torch.cuda.device(r.device):
        status = build.bind("wkv6_chunk", _SIGNATURES).wkv6_chunk_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            y.data_ptr(), s_out.data_ptr(), B, S, H, K,
            H * K if u.dim() == 3 else 0, DTYPES[r.dtype],
            heads_per_block(B * H, sm_count(r)), stream(r))
    raise_on(status, "wkv6_chunk", "wkv6_chunk")
    launch_counts["wkv6_chunk"] += 1
    return y, s_out

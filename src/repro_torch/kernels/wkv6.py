"""The RWKV-6 WKV recurrence in chunks (counterpart of
``repro.kernels.wkv6.wkv6_chunk``), RWKV-6's prefill core, and its
backward, RWKV-6's training core.

``wkv6_chunk`` takes a CUDA tensor to the hand-written kernel
``csrc/wkv6_chunk.cu`` — or raises — and a CPU tensor to
``wkv6_chunk_plain``, the same function in plain PyTorch, which the tests
hold against the reference's Pallas kernel, its oracle and the model's
``wkv6_chunked``. ``wkv6_chunk_bwd`` does the same with
``csrc/wkv6_chunk_bwd.cu`` and ``wkv6_chunk_bwd_plain``: the gradient the
reference takes by ``jax.vjp`` of its ``wkv6_chunked``, which has no TPU
kernel. ``WKV6Chunk`` is the autograd op of the two.

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

launch_counts.update(wkv6_chunk=0, wkv6_chunk_bwd=0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"wkv6_chunk_launch": ([_P] * 8 + [_I] * 4
                                     + [ctypes.c_longlong, _I, _I, _P], _I),
               "wkv6_chunk_smem_bytes": ([_I, _I, _I], _I)}
_BWD_SIGNATURES = {"wkv6_chunk_bwd_launch": (
    [_P] * 15 + [_I] * 4 + [ctypes.c_longlong, _I, _P], _I),
    "wkv6_chunk_bwd_smem_bytes": ([_I, _I, _I], _I),
    "wkv6_chunk_bwd_blocks_per_sm": ([_I, _I, _I], _I)}
# element types of r, k, v, u and y, by the code csrc/typed_io.cuh uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)
CHUNK = 16   # the kernel's chunk length, the model's default
SPAN = 64    # the backward's walk step and per-block span: four chunks


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


def wkv6_chunk_bwd_plain(r, k, v, lw, u, state, dy, ds_out,
                         chunk: int = CHUNK) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward, written out chunk by chunk in fp32
    (not autograd through ``wkv6_chunk_plain``). Takes ``wkv6_chunk_plain``'s
    arguments and layouts, the output's cotangent dy (B, S, H, V) and the
    final state's ``ds_out`` (B, H, K, V) or None (zeros). Returns (dr, dk,
    dv in r's dtype, dlw fp32, du fp32 in u's shape, ds0 (B, H, K, V) fp32:
    the initial state's cotangent, None when ``state`` is None).

    A first walk keeps the state at each chunk's start (the reference's
    ``jax.checkpoint`` of its chunk scan keeps the same). The reverse walk
    carries dS, the final state's cotangent taken back to the chunk's end.
    Per chunk, with c the inclusive cumsum of lw, ce = c - lw, G_tj = dy_t .
    v_j, A and the bonus b as in the forward, and S the chunk's start state:
        dv_j = sum_{t>j} A_tj dy_t + b_j dy_j + (k_j e^(c_L - c_j)) dS
        dr'_t = e^ce_t (S dy_t) + sum_{j<t} G_tj k_j e^(ce_t - c_j)
        dk'_j = sum_{t>j} G_tj r_t e^(ce_t - c_j) + e^(c_L - c_j) (dS v_j)
        dr_t = dr'_t + G_tt u k_t,   dk_j = dk'_j + G_jj u r_j,
        du += sum_t G_tt r_t k_t,
        dS <- e^c_L dS + (r e^ce)^T dy.
    Every decay factor is e^(C_a - C_b) over the sequence's cumsum C, so lw_i
    of this chunk gets sum_{t>i} r_t dr'_t - sum_{j>=i} k_j dk'_j over the
    chunk's tokens, plus the gradient of a decay put on the state at the
    chunk's end: rowsum(dS * S_end), with S_end = e^c_L S + (k e^(c_L -
    c))^T v. Each term is the chunk's own, so no sum runs over the whole
    sequence and none cancels across it."""
    B, S, H, K = k.shape
    V = v.shape[-1]
    f32 = torch.float32
    dev = k.device
    uf = (u if u.dim() == 3 else u[None]).to(f32)           # (B|1, H, K)
    s = (torch.zeros((B, H, K, V), dtype=f32, device=dev)
         if state is None else state.to(f32))
    starts = []
    for t0 in range(0, S, chunk):
        starts.append(s)
        kc, vc, lwc = (a[:, t0:t0 + chunk].to(f32) for a in (k, v, lw))
        c = torch.cumsum(lwc, dim=1)
        s = torch.exp(c[:, -1])[..., None] * s + torch.einsum(
            "blhk,blhv->bhkv", kc * torch.exp(c[:, -1:] - c), vc)
    ds = (torch.zeros((B, H, K, V), dtype=f32, device=dev)
          if ds_out is None else ds_out.to(f32))
    dr, dk, dv, dlw = (torch.zeros((B, S, H, n), dtype=f32, device=dev)
                       for n in (K, K, V, K))
    du = torch.zeros((B, H, K), dtype=f32, device=dev)
    for ci in reversed(range(len(starts))):
        t0 = ci * chunk
        rc, kc, vc, lwc, dyc = (a[:, t0:t0 + chunk].to(f32)
                                for a in (r, k, v, lw, dy))
        L = kc.shape[1]
        c = torch.cumsum(lwc, dim=1)
        ce = c - lwc
        tail = torch.exp(c[:, -1:] - c)                      # e^(c_L - c)
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev),
                         diagonal=-1)[None, :, :, None]      # j < t
        dec = ce[:, :, None] - c[:, None, :]                 # (B, t, j, H, K)
        m = torch.exp(dec.masked_fill_(~tri[..., None], -1e30))
        A = torch.einsum("blhk,bmhk,blmhk->blmh", rc, kc, m)
        G = torch.einsum("blhv,bmhv->blmh", dyc, vc)
        Gd = torch.diagonal(G, dim1=1, dim2=2).movedim(-1, 1)  # (B, L, H)
        bonus = (rc * uf[:, None] * kc).sum(-1)              # (B, L, H)
        Gl = G * tri
        dv[:, t0:t0 + L] = (torch.einsum("blmh,blhv->bmhv", A, dyc)
                            + bonus[..., None] * dyc
                            + torch.einsum("bmhk,bhkv->bmhv", kc * tail, ds))
        dr_p = (torch.exp(ce) * torch.einsum("bhkv,blhv->blhk", starts[ci],
                                             dyc)
                + torch.einsum("blmh,bmhk,blmhk->blhk", Gl, kc, m))
        dk_s = tail * torch.einsum("bhkv,bmhv->bmhk", ds, vc)
        dk_p = torch.einsum("blmh,blhk,blmhk->bmhk", Gl, rc, m) + dk_s
        dr[:, t0:t0 + L] = dr_p + Gd[..., None] * uf[:, None] * kc
        dk[:, t0:t0 + L] = dk_p + Gd[..., None] * uf[:, None] * rc
        du += (Gd[..., None] * rc * kc).sum(1)
        # rowsum(dS * S_end), S_end = e^c_L S + (k e^(c_L - c))^T v
        end = (torch.exp(c[:, -1]) * (ds * starts[ci]).sum(-1)
               + (kc * dk_s).sum(1))                         # (B, H, K)
        p, q = rc * dr_p, kc * dk_p
        after = p.flip(1).cumsum(1).flip(1) - p              # sum_{t>i}
        upto = q.flip(1).cumsum(1).flip(1)                   # sum_{j>=i}
        dlw[:, t0:t0 + L] = after - upto + end[:, None]
        ds = torch.exp(c[:, -1])[..., None] * ds + torch.einsum(
            "blhk,blhv->bhkv", rc * torch.exp(ce), dyc)
    if u.dim() == 2:
        du = du.sum(0)
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dlw, du,
            None if state is None else ds)


def check_aligned(**tensors: torch.Tensor) -> None:
    """Raises unless every given tensor starts on a 16-byte boundary: the
    forward copies r, k, v and lw rows with 16-byte ``cp.async``, and the
    backward loads r, k, v, dy and lw four elements at a time. Rows are K
    elements (K >= 16) apart, so they are aligned once the base is."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6: {name} must start on a 16-byte "
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


def _check_kernel_inputs(what, r, k, v, lw, u, state, **more) -> None:
    """What both kernels take: r, k, v, u (and ``more``) in one of
    ``DTYPES`` alike, lw and the state float32, K = V in ``HEAD_SIZES``,
    every tensor contiguous on r's card."""
    if r.dtype not in DTYPES:
        raise TypeError(f"{what} takes r, k, v in "
                        f"{sorted(map(str, DTYPES))}, not {r.dtype}")
    K = r.shape[-1]
    if K not in HEAD_SIZES or v.shape[-1] != K:
        raise ValueError(f"the kernel is built for K = V in {HEAD_SIZES}; "
                         f"got K {K}, V {v.shape[-1]}")
    for name, t in (("r", r), ("k", k), ("v", v), ("u", u), *more.items()):
        check_tensor(name, t, r.device, r.dtype)
    check_tensor("lw", lw, r.device, torch.float32)
    if state is not None:
        check_tensor("state", state, r.device, torch.float32)


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
    _check_kernel_inputs("wkv6_chunk", r, k, v, lw, u, state)
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


def wkv6_chunk_bwd_scratch_floats(B: int, S: int, H: int, K: int) -> int:
    """Floats of the scratch one backward launch takes
    (``csrc/wkv6_chunk_bwd.cu``): for each head and span of ``SPAN``
    tokens, the (K, K) state at the span's start, then the same for the
    state's cotangent at the span's end, then du's part of each span."""
    return B * H * -(-S // SPAN) * K * (2 * K + 1)


def wkv6_chunk_bwd_smem_bytes(K: int, dtype: torch.dtype) -> dict:
    """Dynamic shared memory of one block of the backward's walks and of
    its span pass, {"walk": bytes, "span": bytes} (builds the kernel)."""
    lib = build.bind("wkv6_chunk_bwd", _BWD_SIGNATURES)
    return {name: lib.wkv6_chunk_bwd_smem_bytes(K, DTYPES[dtype], p)
            for p, name in enumerate(("walk", "span"))}


def wkv6_chunk_bwd_blocks_per_sm(K: int, dtype: torch.dtype) -> dict:
    """Thread blocks of the backward's walks and of its span pass that the
    runtime fits on one SM at once, {"walk": n, "span": n} (builds the
    kernel; needs the card)."""
    lib = build.bind("wkv6_chunk_bwd", _BWD_SIGNATURES)
    got = {name: lib.wkv6_chunk_bwd_blocks_per_sm(K, DTYPES[dtype], p)
           for p, name in enumerate(("walk", "span"))}
    if min(got.values()) < 0:
        raise RuntimeError(f"wkv6_chunk_bwd_blocks_per_sm failed: {got}")
    return got


def wkv6_chunk_bwd(r, k, v, lw, u, state, dy, ds_out=None
                   ) -> Tuple[torch.Tensor, ...]:
    """The backward of ``wkv6_chunk``: ``wkv6_chunk_bwd_plain``'s arguments
    and results. A CUDA tensor goes through ``csrc/wkv6_chunk_bwd.cu`` (r,
    k, v, u and dy float32 or bfloat16 alike, lw, the state and ds_out
    float32, K = V in 16, 32, 64, every tensor contiguous, r, k, v, dy and
    lw 16-byte aligned; one launch runs its three kernels: the walks, the
    span pass and du's sum); a CPU tensor through
    ``wkv6_chunk_bwd_plain``."""
    _check(r, k, v, lw, u, state)
    if dy.shape != v.shape:
        raise ValueError(f"dy has shape {tuple(dy.shape)}; expected "
                         f"{tuple(v.shape)}")
    B, S, H, K = r.shape
    if ds_out is not None and tuple(ds_out.shape) != (B, H, K, v.shape[-1]):
        raise ValueError(f"ds_out has shape {tuple(ds_out.shape)}; expected "
                         f"({B}, {H}, {K}, {v.shape[-1]})")
    if not on_card("wkv6_chunk_bwd", r):
        return wkv6_chunk_bwd_plain(r, k, v, lw, u, state, dy, ds_out)
    _check_kernel_inputs("wkv6_chunk_bwd", r, k, v, lw, u, state, dy=dy)
    if ds_out is not None:
        check_tensor("ds_out", ds_out, r.device, torch.float32)
    check_aligned(r=r, k=k, v=v, dy=dy, lw=lw)
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlw = torch.empty_like(lw)
    du = torch.empty(u.shape, dtype=torch.float32, device=r.device)
    ds0 = (None if state is None else
           torch.empty((B, H, K, K), dtype=torch.float32, device=r.device))
    if S == 0:
        du.zero_()
        if ds0 is not None:
            ds0.copy_(ds_out if ds_out is not None else torch.zeros_like(ds0))
        return dr, dk, dv, dlw, du, ds0
    scratch = torch.empty(wkv6_chunk_bwd_scratch_floats(B, S, H, K),
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        status = build.bind("wkv6_chunk_bwd", _BWD_SIGNATURES
                            ).wkv6_chunk_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            dy.data_ptr(), None if ds_out is None else ds_out.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
            du.data_ptr(), None if ds0 is None else ds0.data_ptr(),
            scratch.data_ptr(), B, S, H, K, H * K if u.dim() == 3 else 0,
            DTYPES[r.dtype], stream(r))
    raise_on(status, "wkv6_chunk_bwd", "wkv6_chunk_bwd")
    launch_counts["wkv6_chunk_bwd"] += 1
    return dr, dk, dv, dlw, du, ds0


class WKV6Chunk(torch.autograd.Function):
    """``wkv6_chunk`` with its gradient: the forward is the same launch
    (the same bits, one ``wkv6_chunk`` count) and keeps only its inputs;
    the backward is ``wkv6_chunk_bwd``, which walks the sequence again for
    the states (the reference's ``jax.checkpoint`` of its chunk scan), a
    span of ``SPAN`` tokens a step, and rebuilds the states at the chunk
    boundaries inside each span. Returns (y, final state); the final
    state's cotangent is None when nothing used it."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, lw, u, state)
        return wkv6_chunk(r, k, v, lw, u, state)

    @staticmethod
    def backward(ctx, dy, ds_out):
        r, k, v, lw, u, state = ctx.saved_tensors
        dy = torch.zeros_like(v) if dy is None else dy.contiguous()
        dr, dk, dv, dlw, du, ds0 = wkv6_chunk_bwd(
            r, k, v, lw, u, state, dy,
            None if ds_out is None else ds_out.contiguous())
        return dr, dk, dv, dlw, du.to(u.dtype), ds0

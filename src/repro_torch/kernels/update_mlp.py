"""The update stage: ``act(x @ w + b)`` (counterpart of
``repro.kernels.update_mlp``).

``update_mlp`` takes a CUDA tensor to the hand-written kernel
``csrc/update_mlp.cu`` — or raises — and a CPU tensor to
``update_mlp_plain``, which the tests hold against the reference. The
reference's kernel has no VJP, and neither has this one.
``update_epilogue`` is the update's bias + activation tail, shared with the
fused datapath's plain versions (``kernels/aggregate.py``), as the
reference shares it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import (check_tensor, launch_counts, on_card,
                                       raise_on, sm_count, stream)

launch_counts.update(update_mlp=0)

# activations the kernels apply, by the code the CUDA sources take
# (csrc/activation.cuh)
ACTS = {"none": 0, "relu": 1, "gelu": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"update_mlp_launch": ([_P] * 4 + [_I] * 5 + [_P], _I),
               "update_mlp_smem_bytes": ([_I], _I)}
# the kernel's tile shapes (rows, columns) by plan number
# (csrc/update_mlp.cu: Big, Small)
TILES = {0: (64, 128), 1: (16, 64)}


def update_epilogue(y: torch.Tensor, b, act: str) -> torch.Tensor:
    """Bias + activation tail of the update MLP (copy of
    ``repro.kernels.update_mlp.update_epilogue``; ``jax.nn.gelu`` is the
    tanh form)."""
    if b is not None:
        y = y + b.float()[None, :]
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "gelu":
        y = torch.nn.functional.gelu(y, approximate="tanh")
    elif act != "none":
        raise ValueError(f"unknown activation: {act!r}")
    return y


def update_mlp_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     act: str = "none") -> torch.Tensor:
    """Plain version of ``update_mlp``: ``update_epilogue(x @ w, b, act)``
    in fp32."""
    return update_epilogue(x.float() @ w.float(), b, act)


def plan(M: int, N: int, sms: int) -> int:
    """The tile plan for an (M, N) output on a card of ``sms`` SMs: the
    64 x 128 tiles (0) where they give at least two thread blocks per SM,
    else the 16 x 64 tiles (1), so a small output still spreads over the
    card (the layer-1 update, 1,024 x 41, runs 64 blocks, not 16)."""
    bm, bn = TILES[0]
    return 0 if -(-M // bm) * -(-N // bn) >= 2 * sms else 1


def update_mlp_smem_bytes(tiles: int) -> int:
    """Dynamic shared memory of one thread block of tile plan ``tiles``
    (builds the kernel)."""
    return build.bind("update_mlp", _SIGNATURES).update_mlp_smem_bytes(tiles)


def _check(x, w, b, act) -> None:
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype in (torch.bfloat16, torch.float16):
            raise NotImplementedError(
                f"update_mlp takes float32; {name} is {t.dtype} (ROADMAP.md "
                f"queue A, item A.15: reduced-precision datapaths)")
        check_tensor(name, t, x.device, torch.float32)
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         f"(M, K) and (K, N)")
    if tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"b has shape {tuple(b.shape)}; expected "
                         f"({w.shape[1]},)")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; expected one of "
                         f"{tuple(ACTS)}")


def update_mlp(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               act: str = "none") -> torch.Tensor:
    """act(x @ w + b): x (M, K), w (K, N), b (N,), all float32
    (bf16 or f16 raises ``NotImplementedError``); act is none, relu or
    the tanh-form gelu. Returns (M, N) float32. Any M, K and N is taken.
    A CUDA tensor goes through ``csrc/update_mlp.cu``, a CPU tensor
    through ``update_mlp_plain``."""
    _check(x, w, b, act)
    if not on_card("update_mlp", x):
        return update_mlp_plain(x, w, b, act)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        status = build.bind("update_mlp", _SIGNATURES).update_mlp_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, K,
            N, ACTS[act], plan(M, N, sm_count(x)), stream(x))
    raise_on(status, "update_mlp", "update_mlp")
    launch_counts["update_mlp"] += 1
    return out

"""Edge-streaming aggregation ``out = A @ h`` (counterpart of
``repro.kernels.aggregate.aggregate_edges`` and ``aggregate_edges_vjp``).

A arrives as per-tile edge segments (``kernels/layout.py``). On a CUDA
tensor ``aggregate_edges`` launches the hand-written kernel
``csrc/aggregate_edges.cu`` — or raises; on a CPU tensor it runs
``aggregate_edges_plain``, the same function in plain PyTorch, which the
tests hold against the JAX reference. ``AggregateEdges`` is the autograd
function of the training path: its backward is the same kernel over the
transposed segments, ``dh = A^T @ g``.

``launch_counts`` counts kernel launches (incremented where a launch is
made, nowhere else), so a run can show that its main path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.layout import BLK

launch_counts = {"aggregate_edges": 0}

# dynamic shared memory a thread block may use on Hopper
_MAX_SMEM = 232_448


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def aggregate_edges_plain(tile_off: torch.Tensor, val: torch.Tensor,
                          seg: torch.Tensor, cols: torch.Tensor,
                          h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every valid edge ``e <
    seg[-1]`` finds its tile slot ``t`` (``seg[t] <= e < seg[t+1]``), then
    adds ``val[e] * h[src]`` into ``out[dst]``. Returns (n_dstb*128, F)."""
    n_dstb, max_blk = cols.shape
    out = torch.zeros((n_dstb * BLK, h.shape[1]), dtype=h.dtype,
                      device=h.device)
    n_valid = int(seg[-1]) if seg.numel() else 0
    if n_valid == 0:
        return out
    e = torch.arange(n_valid, dtype=seg.dtype, device=seg.device)
    t = (torch.searchsorted(seg, e, right=True) - 1).long()
    i, k = t // max_blk, t % max_blk
    off = tile_off[:n_valid].long()
    dst = i * BLK + off // BLK
    src = cols[i, k].long() * BLK + off % BLK
    out.index_add_(0, dst, val[:n_valid, None].to(h.dtype) * h[src])
    return out


def _check(tile_off, val, seg, cols, h) -> None:
    dev = h.device
    for name, t, dtype in (("tile_off", tile_off, torch.int32),
                           ("val", val, torch.float32),
                           ("seg", seg, torch.int32),
                           ("cols", cols, torch.int32),
                           ("h", h, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tile_off.dim() != 1 or val.shape != tile_off.shape:
        raise ValueError(f"tile_off {tuple(tile_off.shape)} and val "
                         f"{tuple(val.shape)} must be equal 1-D shapes")
    if cols.dim() != 2 or h.dim() != 2:
        raise ValueError("cols and h must be 2-D")
    n_dstb, max_blk = cols.shape
    if seg.shape != (n_dstb * max_blk + 1,):
        raise ValueError(f"seg has shape {tuple(seg.shape)}, expected "
                         f"({n_dstb * max_blk + 1},) for cols "
                         f"{tuple(cols.shape)}")
    if h.shape[0] % BLK:
        raise ValueError(f"h has {h.shape[0]} rows; pad it to a multiple of "
                         f"{BLK} (the source blocks)")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("aggregate_edges")
    lib.aggregate_edges_smem_bytes.argtypes = [ctypes.c_int]
    lib.aggregate_edges_smem_bytes.restype = ctypes.c_longlong
    lib.aggregate_edges_launch.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_void_p])
    lib.aggregate_edges_launch.restype = ctypes.c_int
    lib.aggregate_edges_error_string.argtypes = [ctypes.c_int]
    lib.aggregate_edges_error_string.restype = ctypes.c_char_p
    return lib


def aggregate_edges_smem_bytes(max_blk: int) -> int:
    """Dynamic shared memory one kernel launch uses for a layout with
    ``max_blk`` tile slots per destination block (builds the kernel)."""
    return _lib().aggregate_edges_smem_bytes(max_blk)


def aggregate_edges(tile_off: torch.Tensor, val: torch.Tensor,
                    seg: torch.Tensor, cols: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """out = A @ h with A streamed from per-tile edge segments.

    tile_off (E,) i32 and val (E,) f32 sorted into per-tile segments; seg
    (n_dstb*max_blk + 1,) i32 segment offsets (masked edges lie past
    seg[-1]); cols (n_dstb, max_blk) i32 source-block table; h (n_srcb*128,
    F) f32. Returns (n_dstb*128, F) f32. A CUDA tensor goes through the
    kernel, a CPU tensor through ``aggregate_edges_plain``."""
    _check(tile_off, val, seg, cols, h)
    if h.device.type == "cpu":
        return aggregate_edges_plain(tile_off, val, seg, cols, h)
    if h.device.type != "cuda":
        raise ValueError(f"aggregate_edges runs on cuda or cpu, not "
                         f"{h.device}")
    n_dstb, max_blk = cols.shape
    F = h.shape[1]
    out = torch.empty((n_dstb * BLK, F), dtype=torch.float32, device=h.device)
    if tile_off.numel() == 0 or F == 0:  # zero-capacity layer: A is empty
        return out.zero_()
    smem = aggregate_edges_smem_bytes(max_blk)
    if smem > _MAX_SMEM:
        raise ValueError(f"aggregate_edges needs {smem} B of shared memory "
                         f"for max_blk={max_blk}; a block has {_MAX_SMEM}")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        status = _lib().aggregate_edges_launch(
            tile_off.data_ptr(), val.data_ptr(), seg.data_ptr(),
            cols.data_ptr(), h.data_ptr(), out.data_ptr(), n_dstb, max_blk,
            h.shape[0], F, stream)
    if status != 0:
        msg = _lib().aggregate_edges_error_string(status).decode()
        raise RuntimeError(f"aggregate_edges launch failed: {msg} "
                           f"(status {status})")
    launch_counts["aggregate_edges"] += 1
    return out


class AggregateEdges(torch.autograd.Function):
    """Differentiable ``A @ h``. The backward is the same kernel over the
    transposed segments (``dh = A^T @ g``), run only when ``h`` needs a
    gradient; the layout is sampled data and gets none."""

    @staticmethod
    def forward(ctx, tile_off, val, seg, cols, tile_off_t, val_t, seg_t,
                cols_t, h):
        ctx.save_for_backward(tile_off_t, val_t, seg_t, cols_t)
        return aggregate_edges(tile_off, val, seg, cols, h)

    @staticmethod
    def backward(ctx, g):
        dh = None
        if ctx.needs_input_grad[8]:
            tile_off_t, val_t, seg_t, cols_t = ctx.saved_tensors
            dh = aggregate_edges(tile_off_t, val_t, seg_t, cols_t,
                                 g.float().contiguous()).to(g.dtype)
        return None, None, None, None, None, None, None, None, dh

#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main paths — synchronous training at the paper's width
(2 layers, hidden 128, fanouts (25, 10), 1024 targets per batch) on a
Reddit-shaped graph of 2^18 vertices (602 features, 41 classes) — through
their normal entry point, ``SyncGNNTrainer.run_iteration``, and the kernel
entry points of ``repro_torch.kernels.ops``, and holds every CUDA kernel of
those paths against its plain PyTorch version. The paths: GraphSAGE on
``aggregate_backend="pallas_edges"`` (the ``aggregate_edges`` kernel, then
the update matmul), GraphSAGE on ``"pallas_fused"`` (``aggregate_fused``
forward, ``fused_bwd`` and ``aggregate_edges`` backward), GIN on
``"pallas_fused"`` at 128 targets, whose last layer has one destination
block and so takes ``fused_bwd_merged``, GraphSAGE on ``"pallas"`` (dense
tiles densified on the card, then ``aggregate_blockcsr``, then the update
matmul), and ``ops.update`` / ``ops.aggregate`` / ``ops.aggregate_update``
(``update_mlp``, ``aggregate_blockcsr``, ``aggregate_fused`` and, unfused,
``aggregate_edges``). Phases, each of which exits non-zero on failure:

  1. device report: the card's name, and its name and power limit as
     ``nvidia-smi`` gives them;
  2. build: every kernel source in ``src/repro_torch/kernels/csrc`` goes
     through ``nvcc`` (one process per source, all started together), and
     the compiler's register report is printed;
  3. kernel vs plain, at the shapes the main paths give each kernel: one
     paper-shape batch for ``aggregate_edges`` (layer-0 forward, layer-1
     forward, layer-1 backward over A^T), ``aggregate_fused`` and
     ``fused_bwd`` (layers 0 and 1, no self term), and one 128-target GIN
     batch for ``aggregate_fused`` and ``fused_bwd`` with a self term
     ``s`` (layers 0 and 1) and ``fused_bwd_merged`` (its layer 1);
     ``aggregate_blockcsr`` over the paper batch's dense tiles (layer-0
     forward, layer-1 forward, layer-1 backward over A^T), with the time
     of ``densify_tiles`` on its own; and ``update_mlp`` at the update
     stage's shapes. Each launch is held against its plain version on
     the card within rtol 1e-5 and atol 1e-6 times the largest magnitude
     of the plain result (at least 1e-6): fp32 sums are taken in another
     order, and the products contract up to 602 features, 26,624 rows or
     1,280 tiles of 128 columns, so an element that cancels towards zero
     keeps an absolute error of about sqrt(K)·eps of its terms' size. Times
     by CUDA events after warm-up, with the launches queued behind a busy
     card so they time the device: the kernel, its plain version, and
     yardsticks the port never calls — ``torch.sparse.mm`` on a CSR of the
     same edges for ``aggregate_edges``, on a BSR of the tiles that hold
     an edge for ``aggregate_blockcsr`` (a CSR of the edges where the
     installed PyTorch has no fp32 BSR product on CUDA; the line says
     which), ``torch.addmm`` for ``update_mlp`` without an activation;
     for the fused kernels, which no
     single PyTorch call computes, the port's unfused composition (the
     ``aggregate_edges`` kernel and ``torch.matmul``) and ``torch.sparse.mm``
     with ``torch.matmul``. Beside them the bound: the larger of the bytes
     the launch must move over 3.35 TB/s and its flops over the 67 TFLOP/s
     fp32 rate (published H100 SXM peaks). The fused kernels' update flops
     are counted over the destination rows that hold an edge or a self
     term (``flops``), and over all padded rows as ``flops_all_rows``;
     without a bias the backward reads ``g`` over the same rows, since a
     row whose z is zero adds nothing to dw. ``aggregate_blockcsr``'s
     flops are 2*128*128*F per slot that holds an edge (``flops``) and
     over every slot (``flops_all_slots``, the work the kernel does, with
     its own ``bound_all_slots_ms``); its bytes count every tile, read
     once. The ``kernels`` line sums
     each kernel's times and bounds over the launches this phase checked;
  4. training, each path with every launch count set to 0 just before it
     and read just after: five iterations of GraphSAGE on
     ``"pallas_edges"`` (3 ``aggregate_edges`` launches each), five on
     ``"pallas_fused"`` (2 ``aggregate_fused``, 2 ``fused_bwd`` and 1
     ``aggregate_edges`` each), two of GIN on ``"pallas_fused"`` at 128
     targets (2 ``aggregate_fused``, 1 ``fused_bwd`` and 1
     ``fused_bwd_merged`` each), three of GraphSAGE on ``"pallas"`` (3
     ``aggregate_blockcsr`` each: layer 0's input features need no
     gradient, so layer 0's A^T is never densified); any other count
     fails. Losses must be finite, and each path's first loss must match
     ``aggregate_backend="reference"`` (plain segment sums on the card)
     from the same parameters and batch within rtol 1e-4. The reference
     datapath runs that iteration twice, from the same parameters and
     batch, and its two losses and updated parameters must be bitwise
     equal. The peak device memory of each backend's run is printed
     beside the aggregate and dense-tile bytes the trainer says it keeps
     in device memory;
  5. the kernel entry points: ``ops.update``, ``ops.aggregate`` and
     ``ops.aggregate_update`` (fused, and with ``use_pallas=False``) on
     the layer-1 operands, with the counts set to 0 just before and read
     just after (one launch of each of the four kernels), each result
     held against its plain version;
  6. summary: one ``{"kernels": [...]}`` line, then the last line
     ``{"ok": true, "device": {...}}``.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

SCALE = 18          # 2^18 vertices, Reddit's 602 features and 41 classes
ITERATIONS = 5
BLOCKCSR_ITERATIONS = 3
MERGED_TARGETS = 128    # one destination block at the last layer
MERGED_ITERATIONS = 2
SEED = 0
RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
FWD = ("tile_off", "val", "tile_seg", "cols")
BWD = ("tile_off_t", "val_t", "tile_seg_t", "cols_t")
COMPACT = ("tile_id", "tile_off", "val", "cols")
COMPACT_T = ("tile_id_t", "tile_off_t", "val", "cols_t")
KERNEL_SOURCES = {
    "aggregate_blockcsr": (
        "src/repro_torch/kernels/csrc/aggregate_blockcsr.cu",
        "src/repro/kernels/aggregate.py:83"),
    "aggregate_edges": ("src/repro_torch/kernels/csrc/aggregate_edges.cu",
                        "src/repro/kernels/aggregate.py:275"),
    "aggregate_fused": ("src/repro_torch/kernels/csrc/aggregate_fused.cu",
                        "src/repro/kernels/aggregate.py:526"),
    "fused_bwd": ("src/repro_torch/kernels/csrc/aggregate_fused_bwd.cu",
                  "src/repro/kernels/aggregate.py:558"),
    "fused_bwd_merged": (
        "src/repro_torch/kernels/csrc/aggregate_fused_bwd.cu",
        "src/repro/kernels/aggregate.py:818"),
    "update_mlp": ("src/repro_torch/kernels/csrc/update_mlp.cu",
                   "src/repro/kernels/update_mlp.py:38"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls.
    The card first spins for ~10 ms so that the host queues every call
    before the first runs: the events then time the device, not the host's
    launch rate (a small launch takes less time on the card than in
    Python). A call that syncs with the host keeps its host time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, what: str, out, ref) -> float:
    """Fails unless ``out`` matches ``ref`` (see the module docstring for
    the tolerance); returns the max abs error."""
    if out is None or ref is None:
        if out is not None or ref is not None:
            fail(f"{name}: {what} is {out} on the kernel, {ref} plain")
        return 0.0
    if out.shape != ref.shape:
        fail(f"{name}: {what} has shape {tuple(out.shape)}, plain "
             f"{tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite {what}")
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    try:
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL * scale)
    except AssertionError as e:
        fail(f"{name}: {what} of the kernel disagrees with the plain "
             f"version: {e}")
    return float((out - ref).abs().max()) if out.numel() else 0.0


def edge_coords(lay: dict, keys) -> tuple:
    """(dst row, src row, weight) of every valid edge of one launch's
    segments, on the host — for the CSR yardstick and the bound."""
    tile_off, val, seg, cols = (lay[k] for k in keys)
    n = int(seg[-1])
    max_blk = cols.shape[1]
    t = np.searchsorted(seg, np.arange(n), side="right") - 1
    i, k = t // max_blk, t % max_blk
    off = tile_off[:n].astype(np.int64)
    return (i * 128 + off // 128, cols[i, k].astype(np.int64) * 128
            + off % 128, val[:n])


def csr(lay: dict, keys, n_out: int, n_in: int) -> torch.Tensor:
    """The launch's A (or A^T) as a CSR on the card, for
    ``torch.sparse.mm``."""
    dst, src, w = edge_coords(lay, keys)
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([dst, src])),
            torch.from_numpy(w.astype(np.float32)), (n_out, n_in),
            check_invariants=True).coalesce().to_sparse_csr().cuda()


def sparse_mm(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse.mm(a, h)


def segment_bytes(lay: dict, keys) -> int:
    """Bytes of a launch's valid edges (tile_off + val), seg and cols."""
    return (8 * int(lay[keys[2]][-1])
            + 4 * (len(lay[keys[2]]) + lay[keys[3]].size))


def bound(bytes_moved: int, flops: int) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return {"bytes": bytes_moved, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def on_card(lay: dict, keys) -> list:
    return [torch.from_numpy(np.ascontiguousarray(lay[k])).cuda()
            for k in keys]


def report(row: dict) -> dict:
    print("launch " + json.dumps(row), flush=True)
    return row


def check_edges_launch(name, agg, lay, keys, h, n_out):
    """aggregate_edges vs plain on the card, the times, and the bound of
    one launch."""
    args = on_card(lay, keys)
    out = agg.aggregate_edges(*args, h)
    ref = agg.aggregate_edges_plain(*args, h)
    torch.cuda.synchronize()
    max_abs = check_close(name, "out", out, ref)
    err = (out - ref).abs()
    max_rel = float((err / ref.abs().clamp_min(ATOL)).max())
    a = csr(lay, keys, n_out, h.shape[0])
    lib_err = float((sparse_mm(a, h) - ref).abs().max())
    dst, src, _ = edge_coords(lay, keys)
    F = h.shape[1]
    row = {"kernel": "aggregate_edges", "launch": name, "edges": len(dst),
           "src_rows": len(np.unique(src)), "h": list(h.shape),
           "out": [n_out, F],
           "smem_bytes": agg.aggregate_edges_smem_bytes(args[3].shape[1]),
           "max_abs_err": max_abs, "max_rel_err": max_rel,
           "library_max_abs_err": lib_err,
           "ms": time_ms(lambda: agg.aggregate_edges(*args, h)),
           "plain_ms": time_ms(lambda: agg.aggregate_edges_plain(*args, h)),
           "library_ms": time_ms(lambda: sparse_mm(a, h))}
    row.update(bound(segment_bytes(lay, keys)
                     + 4 * F * (row["src_rows"] + n_out),
                     2 * len(dst) * F))
    return report(row)


def update_rows(lay: dict, s) -> int:
    """Destination rows that hold an edge or a (nonzero) self term."""
    rows = set(edge_coords(lay, FWD)[0].tolist())
    if s is not None:
        rows |= set(torch.nonzero(s.abs().sum(1)).flatten().tolist())
    return len(rows)


def fused_shapes(lay: dict, h, w, s) -> dict:
    dst, src, _ = edge_coords(lay, FWD)
    n_dst_pad = lay["cols"].shape[0] * 128
    return {"edges": len(dst), "src_rows": len(np.unique(src)),
            "update_rows": update_rows(lay, s), "n_dst_pad": n_dst_pad,
            "h": list(h.shape), "w": list(w.shape), "self_term": s is not None}


def check_fused_fwd(name, agg, lay, h, w, s=None):
    """aggregate_fused vs plain on the card, its times, yardsticks and
    bound for one launch (no bias and no activation: the models keep those
    outside the kernel)."""
    args = on_card(lay, FWD)
    out = agg.aggregate_fused(*args, h, w, None, s)
    ref = agg.aggregate_fused_plain(*args, h, w, None, s)
    torch.cuda.synchronize()
    row = {"kernel": "aggregate_fused", "launch": name,
           **fused_shapes(lay, h, w, s),
           "smem_bytes": agg.aggregate_fused_smem_bytes(args[3].shape[1]),
           "max_abs_err": check_close(name, "out", out, ref)}
    F, N = w.shape
    n_dst_pad = row["n_dst_pad"]
    a = csr(lay, FWD, n_dst_pad, h.shape[0])

    def unfused():
        z = agg.aggregate_edges(*args, h)
        return (z if s is None else z + s) @ w

    def sparse():
        z = sparse_mm(a, h)
        return (z if s is None else z + s) @ w

    row.update(ms=time_ms(lambda: agg.aggregate_fused(*args, h, w, None, s)),
               plain_ms=time_ms(lambda: agg.aggregate_fused_plain(
                   *args, h, w, None, s)),
               library_ms=None, unfused_ms=time_ms(unfused),
               sparse_ms=time_ms(sparse))
    agg_flops = 2 * row["edges"] * F
    row.update(bound(segment_bytes(lay, FWD) + 4 * F * row["src_rows"]
                     + 4 * F * N + (4 * n_dst_pad * F if s is not None else 0)
                     + 4 * n_dst_pad * N,
                     agg_flops + 2 * row["update_rows"] * F * N))
    row["flops_all_rows"] = agg_flops + 2 * n_dst_pad * F * N
    return report(row)


def check_fused_bwd(name, agg, lay, h, w, g, s=None):
    """fused_bwd vs plain on the card (act none: dw only), with its dw
    partial buffer, times, yardsticks and bound."""
    args = on_card(lay, FWD)
    got = agg.fused_bwd(*args, h, g, w, None, s)
    want = agg.fused_bwd_plain(*args, h, g, w, None, s)
    torch.cuda.synchronize()
    err = max(check_close(name, what, a, b)
              for what, a, b in zip(("dw", "db", "dy"), got, want))
    F, N = w.shape
    n_dstb = lay["cols"].shape[0]
    groups, size = agg.fused_bwd_groups(n_dstb, F, N)
    row = {"kernel": "fused_bwd", "launch": name,
           **fused_shapes(lay, h, w, s),
           "smem_bytes": agg.fused_bwd_smem_bytes(args[3].shape[1]),
           "dw_groups": groups, "blocks_per_group": size,
           "partial_bytes": groups * F * N * 4, "max_abs_err": err}
    n_dst_pad = row["n_dst_pad"]
    a = csr(lay, FWD, n_dst_pad, h.shape[0])

    def unfused():
        z = agg.aggregate_edges(*args, h)
        return (z if s is None else z + s).T @ g

    def sparse():
        z = sparse_mm(a, h)
        return (z if s is None else z + s).T @ g

    row.update(ms=time_ms(lambda: agg.fused_bwd(*args, h, g, w, None, s)),
               plain_ms=time_ms(lambda: agg.fused_bwd_plain(
                   *args, h, g, w, None, s)),
               library_ms=None, unfused_ms=time_ms(unfused),
               sparse_ms=time_ms(sparse))
    agg_flops = 2 * row["edges"] * F
    row.update(bound(segment_bytes(lay, FWD) + 4 * F * row["src_rows"]
                     + 4 * row["update_rows"] * N  # g; no bias, no db
                     + (4 * n_dst_pad * F if s is not None else 0)
                     + 4 * F * N,
                     agg_flops + 2 * row["update_rows"] * F * N))
    row["flops_all_rows"] = agg_flops + 2 * n_dst_pad * F * N
    return report(row)


def check_merged(name, agg, lay, h, w, g, s):
    """fused_bwd_merged vs plain on the card (one destination block, act
    none), its times, yardsticks and bound."""
    args = on_card(lay, FWD + BWD)
    dz = (g @ w.T).contiguous()
    got = agg.fused_bwd_merged(*args, h, g, dz, s)
    want = agg.fused_bwd_merged_plain(*args, h, g, dz, s)
    torch.cuda.synchronize()
    err = max(check_close(name, what, a, b)
              for what, a, b in zip(("dw", "db", "dh"), got, want))
    F, N = w.shape
    row = {"kernel": "fused_bwd_merged", "launch": name,
           **fused_shapes(lay, h, w, s),
           "edges_t": int(lay["tile_seg_t"][-1]),
           "smem_bytes": agg.fused_bwd_merged_smem_bytes(
               args[3].shape[1], args[7].shape[1]),
           "max_abs_err": err}
    n_src = h.shape[0]
    a = csr(lay, FWD, 128, n_src)
    at = csr(lay, BWD, n_src, 128)

    def unfused():
        z = agg.aggregate_edges(*args[:4], h) + s
        return z.T @ g, agg.aggregate_edges(*args[4:], dz)

    def sparse():
        z = sparse_mm(a, h) + s
        return z.T @ g, sparse_mm(at, dz)

    row.update(ms=time_ms(lambda: agg.fused_bwd_merged(*args, h, g, dz, s)),
               plain_ms=time_ms(lambda: agg.fused_bwd_merged_plain(
                   *args, h, g, dz, s)),
               library_ms=None, unfused_ms=time_ms(unfused),
               sparse_ms=time_ms(sparse))
    agg_flops = 2 * (row["edges"] + row["edges_t"]) * F
    row.update(bound(segment_bytes(lay, FWD) + segment_bytes(lay, BWD)
                     + 4 * F * row["src_rows"] + 4 * row["update_rows"] * N
                     + 4 * 128 * 2 * F
                     + 4 * F * N + 4 * n_src * F,
                     agg_flops + 2 * row["update_rows"] * F * N))
    row["flops_all_rows"] = agg_flops + 2 * 128 * F * N
    return report(row)


def blockcsr_library(tiles, cols: np.ndarray, slots: np.ndarray,
                     n_in: int, lay: dict, keys) -> tuple:
    """(name, A) of the yardstick for one ``aggregate_blockcsr`` launch:
    a BSR tensor of the tiles that hold an edge (blocksize 128) where the
    installed PyTorch multiplies fp32 BSR on CUDA, else a CSR of the same
    edges from the launch's edge segments."""
    n_dstb, max_blk = cols.shape
    rows = slots // max_blk
    crow = np.zeros(n_dstb + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_dstb), out=crow[1:])
    with warnings.catch_warnings():  # BSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_bsr_tensor(
            torch.from_numpy(crow).cuda(),
            torch.from_numpy(cols[rows, slots % max_blk].astype(
                np.int64)).cuda(),
            tiles.view(-1, 128, 128)[torch.from_numpy(slots).cuda()],
            size=(n_dstb * 128, n_in))
        try:
            sparse_mm(a, torch.zeros((n_in, 1), device="cuda"))
            return "bsr", a
        except (RuntimeError, NotImplementedError) as e:
            print(f"no fp32 BSR product on CUDA here ({e}); the "
                  f"aggregate_blockcsr yardstick is a CSR", flush=True)
    return "csr", csr(lay, keys, n_dstb * 128, n_in)


def check_blockcsr_launch(name, agg, lay_c, keys, lay_e, keys_e, h,
                          iters: int = 20):
    """densify_tiles and aggregate_blockcsr on one launch's compact
    triples: the kernel vs plain on the card, the times (``densify_ms``
    on its own), the BSR (or CSR) yardstick and the bound. ``lay_e`` /
    ``keys_e`` are the same launch's edge segments, for the CSR."""
    tile_id, tile_off, val, cols = (lay_c[k] for k in keys)
    dens = on_card(lay_c, keys)
    tiles = agg.densify_tiles(*dens[:3], *cols.shape)
    cols_d = dens[3]
    out = agg.aggregate_blockcsr(tiles, cols_d, h)
    ref = agg.aggregate_blockcsr_plain(tiles, cols_d, h)
    torch.cuda.synchronize()
    n_dstb, max_blk = cols.shape
    F = h.shape[1]
    slots = np.unique(tile_id[val != 0]).astype(np.int64)
    lib_name, a = blockcsr_library(tiles, cols, slots, h.shape[0], lay_e,
                                   keys_e)
    row = {"kernel": "aggregate_blockcsr", "launch": name,
           "dst_blocks": n_dstb, "slots": n_dstb * max_blk,
           "real_slots": len(slots), "h": list(h.shape),
           "out": [n_dstb * 128, F], "tile_bytes": tiles.numel() * 4,
           "max_abs_err": check_close(name, "out", out, ref),
           "library": lib_name,
           "library_max_abs_err": float((sparse_mm(a, h) - ref).abs().max())}
    short = dict(iters=iters, warmup=1 if iters < 5 else 3)
    row.update(
        densify_ms=time_ms(lambda: agg.densify_tiles(*dens[:3],
                                                     *cols.shape), **short),
        ms=time_ms(lambda: agg.aggregate_blockcsr(tiles, cols_d, h),
                   **short),
        plain_ms=time_ms(lambda: agg.aggregate_blockcsr_plain(
            tiles, cols_d, h), **short),
        library_ms=time_ms(lambda: sparse_mm(a, h), **short))
    src_blocks = len(np.unique(cols))
    bytes_moved = (4 * n_dstb * max_blk * (128 * 128 + 1)
                   + 4 * 128 * F * (src_blocks + n_dstb))
    per_slot = 2 * 128 * 128 * F
    row["flops_all_slots"] = per_slot * n_dstb * max_blk
    row["bound_all_slots_ms"] = bound(bytes_moved,
                                      row["flops_all_slots"])["bound_ms"]
    row.update(bound(bytes_moved, per_slot * len(slots)))
    del tiles, a
    return report(row)


def check_update_launch(name, um, x, w, b, act):
    """update_mlp vs plain on the card, its times, the ``torch.addmm``
    yardstick (without an activation) and the bound."""
    out = um.update_mlp(x, w, b, act)
    ref = um.update_mlp_plain(x, w, b, act)
    torch.cuda.synchronize()
    (M, K), N = x.shape, w.shape[1]
    lib = None if act != "none" else time_ms(lambda: torch.addmm(b, x, w))
    row = {"kernel": "update_mlp", "launch": name, "x": [M, K],
           "w": [K, N], "act": act,
           "max_abs_err": check_close(name, "out", out, ref),
           "ms": time_ms(lambda: um.update_mlp(x, w, b, act)),
           "plain_ms": time_ms(lambda: um.update_mlp_plain(x, w, b, act)),
           "library_ms": lib}
    row.update(bound(4 * (M * K + K * N + N + M * N), 2 * M * K * N))
    return report(row)


def run_path(label, trainer, groups, expected, agg) -> dict:
    """Drive one path through ``run_iteration`` with every launch count set
    to 0 just before and read just after; fails on any other count per
    iteration than ``expected`` or on a non-finite loss."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    agg.reset_launch_counts()
    steps = []
    for it, group in enumerate(groups):
        before = dict(agg.launch_counts)
        t0 = time.perf_counter()
        m = trainer.run_iteration(group)
        wall = time.perf_counter() - t0
        got = {k: agg.launch_counts[k] - before[k] for k in before}
        m.update(path=label, iteration=it, wall_s=wall, launches=got,
                 nvtps=m["vertices_traversed"] / wall)
        print("iteration " + json.dumps(m), flush=True)
        if got != expected:
            fail(f"{label}: iteration {it} launched {got}, expected "
                 f"{expected}")
        if not np.isfinite(m["loss"]):
            fail(f"{label}: iteration {it} loss is {m['loss']}")
        steps.append(m)
    torch.cuda.synchronize()
    return {"steps": steps, "launches": dict(agg.launch_counts),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "aggregate_intermediate_bytes":
                trainer.aggregate_intermediate_bytes(),
            "densified_hbm_bytes": trainer.densified_hbm_bytes()}


def reference_loss(trainer_cls, graph, cfg, params, group,
                   flatten=None) -> tuple:
    """First loss of ``aggregate_backend="reference"`` from the same
    parameters and batch, and the peak device memory of that iteration.
    Given ``flatten`` (``repro_torch.nn.param.flatten``) the iteration
    runs twice, in two trainers, and must give bitwise the same loss and
    updated parameters."""
    repeat = flatten is not None
    runs = []
    for _ in range(2 if repeat else 1):
        ref = trainer_cls(graph, dataclasses.replace(
            cfg, aggregate_backend="reference"), num_devices=1,
            algorithm="distdgl", seed=SEED, device="cuda", params=params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = ref.run_iteration(group)["loss"]
        torch.cuda.synchronize()
        runs.append((loss, torch.cuda.max_memory_allocated(),
                     [p.detach().cpu() for p in flatten(ref.params)]
                     if repeat else None))
        del ref
    if repeat:
        (l0, _, p0), (l1, _, p1) = runs
        same = l0 == l1 and all(torch.equal(a, b) for a, b in zip(p0, p1))
        print(f"reference datapath twice from the same parameters and "
              f"batch: losses {l0!r} and {l1!r}, parameters "
              f"{'bitwise equal' if same else 'DIFFERENT'}", flush=True)
        if not same:
            fail("the reference datapath does not repeat its bits")
    return runs[0][0], runs[0][1]


def check_first_loss(label, run, ref_loss) -> None:
    first = run["steps"][0]["loss"]
    if not np.isclose(first, ref_loss, rtol=LOSS_RTOL, atol=0):
        fail(f"{label}: first loss {first} vs reference backend {ref_loss}")
    print(f"{label}: first loss {first!r} vs reference backend "
          f"{ref_loss!r}", flush=True)


def kernel_entry(name, rows, launches_by_path) -> dict:
    src, replaces = KERNEL_SOURCES[name]
    t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S
    t_ops = sum(r["flops"] for r in rows) / FP32_FLOPS

    def total(key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals)

    entry = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces,
             "launches": sum(launches_by_path.values()),
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": total("ms"), "plain_ms": total("plain_ms"),
             "bound_ms": total("bound_ms"),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": total("library_ms"),
             "launches_by_path": launches_by_path}
    if "unfused_ms" in rows[0]:
        entry.update(unfused_ms=total("unfused_ms"),
                     sparse_ms=total("sparse_ms"))
    entry["per_launch"] = rows
    return entry


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.configs.gnn import GNNModelConfig
        from repro_torch.core import scheduler as sched
        from repro_torch.core.sampler import NeighborSampler
        from repro_torch.core.trainer import SyncGNNTrainer
        from repro_torch.data.graphs import scaled_dataset
        from repro_torch.gnn.models import AGG_KIND
        from repro_torch.kernels import aggregate as agg
        from repro_torch.kernels import build
        from repro_torch.kernels.layout import (block_capacities,
                                                build_layer_layouts)
        from repro_torch.kernels import ops
        from repro_torch.kernels import update_mlp as um
        from repro_torch.nn.param import flatten, params_to_numpy
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device report
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(f"card: {card}", flush=True)

    # 2. build every kernel source, all nvcc processes at once
    t0 = time.perf_counter()
    try:
        reports = build.build(build.sources())
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    print(f"build: {len(reports)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "ptxas info" in line and ("Used" in line
                                         or "Compiling" in line):
                print(f"  {name}: {line.strip()}", flush=True)

    # 3. every launch of the main paths, kernel vs plain
    t0 = time.perf_counter()
    graph = scaled_dataset("reddit", scale=SCALE, seed=SEED)
    print(f"graph: {graph.name}, {graph.num_vertices} vertices, "
          f"{graph.num_edges} edges, {graph.features.shape[1]} features, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = GNNModelConfig("graphsage", num_layers=2, hidden=128,
                         fanouts=(25, 10), batch_targets=1024,
                         aggregate_backend="pallas_edges")
    mb = NeighborSampler(graph, cfg, graph.train_ids, 0, SEED).batch_at(0, 0)
    lay = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                              block_capacities(cfg), "mean", edge_stream=True)
    layers = [{k[4:]: v[l] for k, v in lay.items()} for l in range(2)]
    pad = [layers[l]["cols_t"].shape[0] * 128 for l in range(2)]
    out_rows = [layers[l]["cols"].shape[0] * 128 for l in range(2)]
    feats = graph.features[mb.nodes[0]] * mb.node_mask[0][:, None]
    f0, hid, n_cls = feats.shape[1], cfg.hidden, graph.num_classes
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale

    h0 = torch.zeros((pad[0], f0), device="cuda")
    h0[:len(feats)] = torch.from_numpy(feats).cuda()
    h1, g1 = randn(pad[1], hid), randn(out_rows[1], hid)
    rows = {"aggregate_edges": [
        check_edges_launch("layer0_fwd", agg, layers[0], FWD, h0,
                           out_rows[0]),
        check_edges_launch("layer1_fwd", agg, layers[1], FWD, h1,
                           out_rows[1]),
        check_edges_launch("layer1_bwd", agg, layers[1], BWD, g1, pad[1])]}
    w0, w1 = randn(f0, hid, scale=f0 ** -0.5), randn(hid, n_cls,
                                                     scale=hid ** -0.5)
    rows["aggregate_fused"] = [
        check_fused_fwd("layer0_fused_fwd", agg, layers[0], h0, w0),
        check_fused_fwd("layer1_fused_fwd", agg, layers[1], h1, w1)]
    rows["fused_bwd"] = [
        check_fused_bwd("layer0_fused_bwd", agg, layers[0], h0, w0,
                        randn(out_rows[0], hid)),
        check_fused_bwd("layer1_fused_bwd", agg, layers[1], h1, w1,
                        randn(out_rows[1], n_cls))]
    cfg_m = dataclasses.replace(cfg, name="gin", aggregate_backend=
                                "pallas_fused", batch_targets=MERGED_TARGETS)
    mb_m = NeighborSampler(graph, cfg_m, graph.train_ids, 0,
                           SEED).batch_at(0, 0)
    lay_m = build_layer_layouts(mb_m.edge_src, mb_m.edge_dst,
                                mb_m.edge_mask, block_capacities(cfg_m),
                                AGG_KIND["gin"], edge_stream=True)
    lay_m0, lay_m1 = ({k[4:]: v[l] for k, v in lay_m.items()}
                      for l in range(2))
    if lay_m1["cols"].shape[0] != 1:
        fail(f"the {MERGED_TARGETS}-target batch's layer 1 has "
             f"{lay_m1['cols'].shape[0]} destination blocks, not 1")
    # GIN's launches carry the self term s = (1 + eps) h_self
    feats_m = graph.features[mb_m.nodes[0]] * mb_m.node_mask[0][:, None]
    hm0 = torch.zeros((lay_m0["cols_t"].shape[0] * 128, f0), device="cuda")
    hm0[:len(feats_m)] = torch.from_numpy(feats_m).cuda()
    hm1 = randn(lay_m1["cols_t"].shape[0] * 128, hid)
    dst_m = [lay_m0["cols"].shape[0] * 128, 128]
    for l, (lay_l, h_l, w_l) in enumerate((
            (lay_m0, hm0, randn(f0, hid, scale=f0 ** -0.5)),
            (lay_m1, hm1, randn(hid, n_cls, scale=hid ** -0.5)))):
        s_l = randn(dst_m[l], h_l.shape[1])
        rows["aggregate_fused"].append(check_fused_fwd(
            f"gin{MERGED_TARGETS}_layer{l}_fused_fwd", agg, lay_l, h_l, w_l,
            s_l))
        rows["fused_bwd"].append(check_fused_bwd(
            f"gin{MERGED_TARGETS}_layer{l}_fused_bwd", agg, lay_l, h_l, w_l,
            randn(dst_m[l], w_l.shape[1]), s_l))
    rows["fused_bwd_merged"] = [check_merged(
        "layer1_merged_bwd", agg, lay_m1,
        randn(lay_m1["cols_t"].shape[0] * 128, hid),
        randn(hid, n_cls, scale=hid ** -0.5), randn(128, n_cls),
        randn(128, hid))]
    del hm0, hm1
    lay_c = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                                block_capacities(cfg), "mean")
    compact = [{k[4:]: v[l] for k, v in lay_c.items()} for l in range(2)]
    torch.cuda.empty_cache()
    rows["aggregate_blockcsr"] = [
        check_blockcsr_launch("layer0_blockcsr_fwd", agg, compact[0],
                              COMPACT, layers[0], FWD, h0, iters=2),
        check_blockcsr_launch("layer1_blockcsr_fwd", agg, compact[1],
                              COMPACT, layers[1], FWD, h1),
        check_blockcsr_launch("layer1_blockcsr_bwd", agg, compact[1],
                              COMPACT_T, layers[1], BWD, g1)]
    torch.cuda.empty_cache()
    b0, b1 = randn(hid), randn(n_cls)
    x0 = randn(out_rows[0], f0)
    rows["update_mlp"] = [
        check_update_launch("layer0_update_relu", um, x0, w0, b0, "relu"),
        check_update_launch("layer0_update", um, x0, w0, b0, "none"),
        check_update_launch("layer1_update", um, randn(out_rows[1], hid),
                            w1, b1, "none")]
    del h0, g1, w0, x0
    torch.cuda.empty_cache()

    # 4. the main paths: training steps through the trainer's entry point
    t0 = time.perf_counter()
    runs, peaks = {}, {}
    edges_tr = SyncGNNTrainer(graph, cfg, num_devices=1, algorithm="distdgl",
                              seed=SEED, device="cuda")
    params0 = params_to_numpy(edges_tr.params)
    groups = list(sched.iterations(edges_tr.epoch_schedule()))[:ITERATIONS]
    ref_loss, peaks["reference"] = reference_loss(
        SyncGNNTrainer, graph, cfg, params0, groups[0], flatten)
    print(f"trainers built in {time.perf_counter() - t0:.1f} s", flush=True)
    none = {k: 0 for k in agg.launch_counts}
    runs["pallas_edges"] = run_path(
        "graphsage/pallas_edges", edges_tr, groups,
        {**none, "aggregate_edges": 3}, agg)
    check_first_loss("graphsage/pallas_edges", runs["pallas_edges"],
                     ref_loss)
    del edges_tr
    fused_tr = SyncGNNTrainer(
        graph, dataclasses.replace(cfg, aggregate_backend="pallas_fused"),
        num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
        params=params0)
    runs["pallas_fused"] = run_path(
        "graphsage/pallas_fused", fused_tr, groups,
        {**none, "aggregate_fused": 2, "fused_bwd": 2, "aggregate_edges": 1},
        agg)
    check_first_loss("graphsage/pallas_fused", runs["pallas_fused"],
                     ref_loss)
    del fused_tr
    blockcsr_tr = SyncGNNTrainer(
        graph, dataclasses.replace(cfg, aggregate_backend="pallas"),
        num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
        params=params0)
    runs["pallas"] = run_path(
        "graphsage/pallas", blockcsr_tr, groups[:BLOCKCSR_ITERATIONS],
        {**none, "aggregate_blockcsr": 3}, agg)
    check_first_loss("graphsage/pallas", runs["pallas"], ref_loss)
    del blockcsr_tr
    memory = {be: {"peak_bytes": runs[be]["peak_bytes"] if be in runs
                   else peaks[be]}
              | {key: runs[be][key] if be in runs else 0
                 for key in ("aggregate_intermediate_bytes",
                             "densified_hbm_bytes")}
              for be in ("reference", "pallas", "pallas_edges",
                         "pallas_fused")}
    print("peak_memory " + json.dumps(memory), flush=True)

    merged_tr = SyncGNNTrainer(graph, cfg_m, num_devices=1,
                               algorithm="distdgl", seed=SEED, device="cuda")
    groups_m = list(sched.iterations(
        merged_tr.epoch_schedule()))[:MERGED_ITERATIONS]
    ref_loss_m, _ = reference_loss(SyncGNNTrainer, graph, cfg_m,
                                   params_to_numpy(merged_tr.params),
                                   groups_m[0])
    runs["merged"] = run_path(
        f"gin/pallas_fused/{MERGED_TARGETS}_targets", merged_tr, groups_m,
        {**none, "aggregate_fused": 2, "fused_bwd": 1,
         "fused_bwd_merged": 1}, agg)
    check_first_loss(f"gin/pallas_fused/{MERGED_TARGETS}_targets",
                     runs["merged"], ref_loss_m)

    # 5. the kernel entry points, on the layer-1 operands
    seg1 = on_card(layers[1], FWD)
    cols1 = torch.from_numpy(compact[1]["cols"]).cuda()
    blocks1 = agg.densify_tiles(*on_card(compact[1], COMPACT)[:3],
                                *compact[1]["cols"].shape)
    x1 = randn(out_rows[1], hid)
    torch.cuda.synchronize()
    agg.reset_launch_counts()
    got = {"update": ops.update(x1, w1, b1, act="relu"),
           "aggregate": ops.aggregate(blocks1, cols1, h1),
           "aggregate_update": ops.aggregate_update(*seg1, h1, w1),
           "aggregate_update_unfused": ops.aggregate_update(
               *seg1, h1, w1, use_pallas=False)}
    torch.cuda.synchronize()
    runs["ops"] = {"launches": dict(agg.launch_counts)}
    want_counts = {**none, "update_mlp": 1, "aggregate_blockcsr": 1,
                   "aggregate_fused": 1, "aggregate_edges": 1}
    if runs["ops"]["launches"] != want_counts:
        fail(f"ops launched {runs['ops']['launches']}, expected "
             f"{want_counts}")
    fused_plain = agg.aggregate_fused_plain(*seg1, h1, w1)
    want = {"update": um.update_mlp_plain(x1, w1, b1, "relu"),
            "aggregate": agg.aggregate_blockcsr_plain(blocks1, cols1, h1),
            "aggregate_update": fused_plain,
            "aggregate_update_unfused": fused_plain}
    errs = {k: check_close(f"ops.{k}", "out", got[k], want[k]) for k in got}
    print("ops " + json.dumps({"launches": runs["ops"]["launches"],
                               "max_abs_err": errs}), flush=True)

    # 6. summary
    kernels = [kernel_entry(name, rows[name], {
        path: run["launches"][name] for path, run in runs.items()})
        for name in KERNEL_SOURCES]
    for k in kernels:
        if k["launches"] == 0:
            fail(f"{k['name']} was launched no time on the main paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

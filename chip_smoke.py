#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path — synchronous GraphSAGE training at the
paper's width (2 layers, hidden 128, fanouts (25, 10), 1024 targets per
batch, ``aggregate_backend="pallas_edges"``) on a Reddit-shaped graph of
2^18 vertices (602 features, 41 classes) — through its normal entry point,
``SyncGNNTrainer.run_iteration``, and holds every CUDA kernel of that path
against its plain PyTorch version. Phases, each of which exits non-zero on
failure:

  1. device report: the card's name, and its name and power limit as
     ``nvidia-smi`` gives them;
  2. build: every kernel source in ``src/repro_torch/kernels/csrc`` goes
     through ``nvcc`` (one process per source, all started together), and
     the compiler's register report is printed (each launch line below
     gives the dynamic shared memory it uses);
  3. kernel vs plain: one paper-shape batch is sampled and each of the
     kernel's three launches per iteration (layer-0 forward, layer-1
     forward, layer-1 backward over A^T) runs through the kernel and its
     plain version on the card, within rtol 1e-5 / atol 1e-6 (fp32 sums in
     another order). Times by CUDA events after warm-up, with the launches
     queued behind a busy card so they time the device: the kernel, the
     plain version, and ``torch.sparse.mm`` on a CSR of the same edges (a
     yardstick the port never calls), beside the bound: the larger of the
     bytes the launch must move over 3.35 TB/s and its flops over the
     67 TFLOP/s fp32 rate (published H100 SXM peaks);
  4. training: five iterations with the launch counts set to 0 just
     before; each must launch the kernel exactly 3 times and give a finite
     loss, and the first loss must match ``aggregate_backend="reference"``
     (plain segment sums on the card) from the same parameters and batch
     within rtol 1e-4;
  5. summary: one ``{"kernels": [...]}`` line, then the last line
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
SEED = 0
RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores


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


def check_launch(name, agg, lay, keys, h, n_out):
    """Kernel vs plain on the card, the times, and the bound of one launch."""
    args = [torch.from_numpy(np.ascontiguousarray(lay[k])).cuda()
            for k in keys]
    out = agg.aggregate_edges(*args, h)
    ref = agg.aggregate_edges_plain(*args, h)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(ATOL)).max())
    try:
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    except AssertionError as e:
        fail(f"{name}: kernel disagrees with the plain version: {e}")
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite output")

    dst, src, w = edge_coords(lay, keys)
    F = h.shape[1]
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([dst, src])),
            torch.from_numpy(w.astype(np.float32)), (n_out, h.shape[0]),
            check_invariants=True).coalesce().to_sparse_csr().cuda()
        lib = torch.sparse.mm(csr, h)
    lib_err = float((lib - ref).abs().max())

    kernel_ms = time_ms(lambda: agg.aggregate_edges(*args, h))
    plain_ms = time_ms(lambda: agg.aggregate_edges_plain(*args, h))
    library_ms = time_ms(lambda: torch.sparse.mm(csr, h))
    n_edges = len(dst)
    n_rows = len(np.unique(src))
    bytes_moved = (8 * n_edges + 4 * (len(lay[keys[2]]) + lay[keys[3]].size)
                   + 4 * F * (n_rows + n_out))
    flops = 2 * n_edges * F
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    row = {"launch": name, "edges": n_edges, "src_rows": n_rows,
           "h": list(h.shape), "out": [n_out, F],
           "smem_bytes": agg.aggregate_edges_smem_bytes(args[3].shape[1]),
           "max_abs_err": max_abs,
           "max_rel_err": max_rel, "library_max_abs_err": lib_err,
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bytes": bytes_moved, "flops": flops,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("launch " + json.dumps(row), flush=True)
    return row


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
        from repro_torch.kernels import aggregate as agg
        from repro_torch.kernels import build
        from repro_torch.kernels.layout import (block_capacities,
                                                build_layer_layouts)
        from repro_torch.nn.param import params_to_numpy
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
    for name, report in reports.items():
        for line in report.splitlines():
            if "ptxas info" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # 3. every launch of the main path, kernel vs plain, on one batch
    t0 = time.perf_counter()
    graph = scaled_dataset("reddit", scale=SCALE, seed=SEED)
    print(f"graph: {graph.name}, {graph.num_vertices} vertices, "
          f"{graph.num_edges} edges, {graph.features.shape[1]} features, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = GNNModelConfig("graphsage", num_layers=2, hidden=128,
                         fanouts=(25, 10), batch_targets=1024,
                         aggregate_backend="pallas_edges")
    caps = block_capacities(cfg)
    mb = NeighborSampler(graph, cfg, graph.train_ids, 0, SEED).batch_at(0, 0)
    lay = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask, caps,
                              "mean")
    layers = [{k[4:]: v[l] for k, v in lay.items()} for l in range(2)]
    fwd = ("tile_off", "val", "tile_seg", "cols")
    bwd = ("tile_off_t", "val_t", "tile_seg_t", "cols_t")
    pad = [layers[l]["cols_t"].shape[0] * 128 for l in range(2)]
    out_rows = [layers[l]["cols"].shape[0] * 128 for l in range(2)]
    feats = graph.features[mb.nodes[0]] * mb.node_mask[0][:, None]
    h0 = torch.zeros((pad[0], feats.shape[1]), device="cuda")
    h0[:len(feats)] = torch.from_numpy(feats).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h1 = torch.randn((pad[1], cfg.hidden), device="cuda", generator=gen)
    g1 = torch.randn((out_rows[1], cfg.hidden), device="cuda", generator=gen)
    launches = [
        check_launch("layer0_fwd", agg, layers[0], fwd, h0, out_rows[0]),
        check_launch("layer1_fwd", agg, layers[1], fwd, h1, out_rows[1]),
        check_launch("layer1_bwd", agg, layers[1], bwd, g1, pad[1]),
    ]
    del h0, h1, g1

    # 4. the main path: training steps through the trainer's entry point
    t0 = time.perf_counter()
    trainer = SyncGNNTrainer(graph, cfg, num_devices=1, algorithm="distdgl",
                             seed=SEED, device="cuda")
    reference = SyncGNNTrainer(
        graph, dataclasses.replace(cfg, aggregate_backend="reference"),
        num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
        params=params_to_numpy(trainer.params))
    print(f"trainers built in {time.perf_counter() - t0:.1f} s", flush=True)
    groups = list(sched.iterations(trainer.epoch_schedule()))[:ITERATIONS]
    ref_loss = reference.run_iteration(groups[0])["loss"]

    agg.reset_launch_counts()
    steps = []
    for it, group in enumerate(groups):
        before = agg.launch_counts["aggregate_edges"]
        t0 = time.perf_counter()
        m = trainer.run_iteration(group)
        wall = time.perf_counter() - t0
        got = agg.launch_counts["aggregate_edges"] - before
        m.update(iteration=it, wall_s=wall, launches=got,
                 nvtps=m["vertices_traversed"] / wall)
        print("iteration " + json.dumps(m), flush=True)
        if got != 3:
            fail(f"iteration {it} launched aggregate_edges {got} times, "
                 f"expected 3")
        if not np.isfinite(m["loss"]):
            fail(f"iteration {it} loss is {m['loss']}")
        steps.append(m)
    main_launches = agg.launch_counts["aggregate_edges"]
    first = steps[0]["loss"]
    if not np.isclose(first, ref_loss, rtol=LOSS_RTOL, atol=0):
        fail(f"first loss {first} vs reference backend {ref_loss}")
    print(f"first loss {first!r} vs reference backend {ref_loss!r}; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # 5. summary
    def total(key):
        return sum(r[key] for r in launches)

    t_bytes = sum(r["bytes"] for r in launches) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["flops"] for r in launches) / FP32_FLOPS * 1e3
    kernels = [{
        "name": "aggregate_edges", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/aggregate_edges.cu",
        "replaces": "src/repro/kernels/aggregate.py:275",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in launches),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": total("library_ms"),
        "per_launch": launches}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main paths — synchronous training at the paper's width
(2 layers, hidden 128, fanouts (25, 10), 1024 targets per batch) on a
Reddit-shaped graph of 2^18 vertices (602 features, 41 classes) — through
their normal entry points, ``SyncGNNTrainer.run_iteration`` and
``run_epoch`` (sequential, pipelined, and with sampler worker processes),
and the kernel entry points of ``repro_torch.kernels.ops``, and holds
every CUDA kernel of those paths against its plain PyTorch version. The
paths: GraphSAGE on
``aggregate_backend="pallas_edges"`` (the ``aggregate_edges`` kernel, then
the update matmul), GraphSAGE on ``"pallas_fused"`` (``aggregate_fused``
forward, ``fused_bwd`` and ``aggregate_edges`` backward), GIN on
``"pallas_fused"`` at 128 targets, whose last layer has one destination
block and so takes ``fused_bwd_merged``, GraphSAGE on ``"pallas"`` (dense
tiles densified on the card, then ``aggregate_blockcsr``, then the update
matmul), and ``ops.update`` / ``ops.aggregate`` / ``ops.aggregate_update``
(``update_mlp``, ``aggregate_blockcsr``, ``aggregate_fused`` and, unfused,
``aggregate_edges``). It then serves the LM zoo's two ported models at
their published widths and depths through ``models.registry.build``,
``ModelBundle.init_params`` and ``launch.steps.make_prefill_step`` /
``make_decode_step``: Llama-3-8B (prefill through ``flash_attention_fwd``)
and RWKV-6-3B (prefill through ``wkv6_chunk``), in bf16 from a seeded
init. Phases, each of which exits non-zero on failure:

  1. device report: the card's name, its name and power limit as
     ``nvidia-smi`` gives them, and its max SM clock;
  2. build: every kernel source in ``src/repro_torch/kernels/csrc`` goes
     through ``nvcc`` (one process per source, all started together), and
     the compiler's register and spill report is printed;
  3. kernel vs plain, at the shapes the main paths give each kernel: one
     paper-shape batch for ``aggregate_edges`` (layer-0 forward, layer-1
     forward, layer-1 backward over A^T), ``aggregate_fused`` and
     ``fused_bwd`` (layers 0 and 1, no self term), and one 128-target GIN
     batch for ``aggregate_fused`` and ``fused_bwd`` with a self term
     ``s`` (layers 0 and 1) and ``fused_bwd_merged`` (its layer 1);
     ``aggregate_blockcsr`` over the paper batch's dense tiles (layer-0
     forward, layer-1 forward, layer-1 backward over A^T), walking only
     the real slots that ``real_slot_counts`` finds, as the trainer runs
     it, with the times of ``densify_tiles`` and of the counts on their
     own; and ``update_mlp`` at the update
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
     which), ``torch.addmm`` for ``update_mlp`` (``torch.addmm(b, x,
     w).relu_()`` for its relu launch); for the fused kernels, which no
     single PyTorch call computes, the port's unfused composition (the
     ``aggregate_edges`` kernel and ``torch.matmul``) and ``torch.sparse.mm``
     with ``torch.matmul``. Beside them the bound: the larger of the bytes
     the launch must move over 3.35 TB/s and its flops over the 67 TFLOP/s
     fp32 rate (published H100 SXM peaks). ``aggregate_edges``' lines
     give its shape (``groups`` of ``rows_a_group`` rows, ``slab``: the
     columns a warp walks at once, ``vec``: the floats a lane loads at
     once, ``ctas``, ``real_blocks``: the destination blocks that hold an
     edge, ``busy_ctas``) and the build report's registers and spill bytes
     of the launch's instantiation; two launches must give the same bits.
     ``fused_bwd``'s lines also
     give its plan (``real_blocks``, ``groups``, ``slab``, ``ctas``,
     ``partial_bytes``, held under 8 MiB), the device times of its dw
     kernel, its reduce and its plan's PyTorch ops apart
     (``torch.profiler``), and the build report's registers and spill
     bytes; two launches must give bitwise the same dw (and db).
     ``fused_bwd_merged``'s line gives its shape (``dh_groups``,
     ``dw_groups``: the dw cluster's ranks, ``ctas``, ``vec``), the build
     report's registers, spill bytes and static shared memory of the
     launch's instantiation beside its dynamic shared memory, and its
     device split, which must hold one kernel a call; two launches must
     give the same bits, and dh must equal the ``aggregate_edges`` kernel
     over A^T bit for bit.
     ``aggregate_fused``'s lines give its shape (``slab``, ``cluster``,
     ``rounds``, ``ctas``, ``max_active_clusters``: the clusters the card
     runs at once, ``real_blocks``: the destination blocks that hold an
     edge), its device split by kernel and the build report's registers
     and spill bytes (of the launch's instantiation, and of each under
     ``build``); two launches must give the same bits. The
     fused kernels' update flops are counted over the destination rows
     that hold an edge or a self term (``flops``), and over all padded
     rows as ``flops_all_rows``;
     without a bias the backward reads ``g`` over the same rows, since a
     row whose z is zero adds nothing to dw. ``aggregate_blockcsr``'s
     flops are 2*128*128*F per slot that holds an edge, over the 495
     TFLOP/s TF32 tensor-core rate, the fastest the card multiplies fp32
     inputs (its 3xTF32 split does three TF32 products per product); its
     bytes count the tiles of the slots it walks (``real_slots_walked``),
     the h rows they name and the output, each once; the line gives the
     achieved fp32-product rate (``tflops``). ``update_mlp``'s products
     run on the tensor cores too (3xTF32), so its bound takes them at the
     TF32 rate as well; its lines name the route, the tile plan, the
     shared memory and the build report's registers and spill bytes, and
     keep the earlier all-fp32 bound as ``bound_fp32_ms``. Each line names
     its ``op_rate`` (``op_rates`` where the work runs on several units).
     The ``kernels`` line sums
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
     in device memory. Beside each GraphSAGE run, the same iterations
     from the same parameters under ``data_parallel=True`` (the resident
     feature path: the shard uploaded once, the layer-0 block assembled on
     the card by ``assemble_device_feats``), whose launch counts must be
     the host-gather run's and whose first loss must be its first loss
     bit for bit; then two iterations at p = 4 on ``"pallas_fused"``,
     host gather and resident, with four times the counts, the same first
     loss, miss rows shipped, beta below 1 and the same per-device
     accounting. Iteration lines carry ``gather_s``, ``upload_s``,
     ``step_s``, ``wall_s``, ``nvtps``, ``beta`` and, resident,
     ``shard_upload_s`` and ``miss_rows``. ``assemble_device_feats`` at
     the paper batch (p = 1, and each device at p = 4) must equal
     ``FeatureStore.gather`` on the card bit for bit; its launch lines
     give its ms by CUDA events beside its bytes bound (the valid rows
     read, the block written, the positions). ``peak_memory_resident``
     gives each resident run's peak beside its host-gather run's and its
     shard's bytes;
  5. the host runtime (``SyncGNNTrainer.run_epoch``): the machine's CPU
     count and affinity and ``/dev/shm``'s free bytes, which must hold the
     shared graph and the largest ring a pool here may take (else the
     phase fails); the host milliseconds of one paper batch's trip
     through the pool's ring (``pool_codec``: encode, decode and CRC32
     alone); then, from phase 4's initial parameters, two full epochs a
     run (26 iterations each) on the resident path at p = 1 for
     ``"pallas_fused"`` and ``"pallas_edges"``: sequential
     (``pipeline=False``, the twin), pipelined with in-process sampling,
     and pipelined with 2, 4 and min(8, usable CPUs - 2) sampler workers;
     one pooled epoch (2 workers) on ``"pallas_fused"`` with a worker
     killed at batch 13 of the first epoch, which must be respawned; the
     host gather on ``"pallas_fused"``, sequential against pipelined;
     and p = 4 on ``"pallas_fused"`` with the ``"load"`` policy,
     sequential against 4 workers that gather the miss rows (which must
     cross the ring). Each run's epoch loss and acc, and its parameters
     after its last epoch, must equal its twin's bit for bit, and its
     launch counts must be its iterations times phase 4's counts per
     iteration (times p). Each ``epoch`` line gives ``epoch_time_s``,
     ``iteration_s``, ``nvtps``, the host seconds (``host_produce_s``:
     the prefetch thread preparing groups; ``host_wait_s``: the main
     thread waiting for one; ``host_fetch_s``: pulling payloads from the
     pool; ``host_gather_s``; ``host_issue_s``: the main thread launching
     steps), ``ring_bytes_per_iter`` and the ``pool_*`` counters; the
     last epoch of a run is traced on the device alone
     (``torch.profiler`` with CUDA activity only, which keeps it off the
     host's path) for its kernels, busy milliseconds (the union of the
     kernels' and copies' intervals) and idle share;
  6. the kernel entry points: ``ops.update``, ``ops.aggregate`` and
     ``ops.aggregate_update`` (fused, and with ``use_pallas=False``) on
     the layer-1 operands, with the counts set to 0 just before and read
     just after (one launch of each of the four kernels), each result
     held against its plain version;
  7. the LM kernels vs their plain versions, at the models' shapes:
     ``flash_attention_fwd`` at Llama-3-8B's prefill (4 x 4,096 tokens,
     32 query and 8 kv heads of 128, bf16, causal), in fp32 at 1 x 1,024,
     and non-causal with Sq 1,000 != Sk 1,537 (bf16); ``wkv6_chunk`` at
     RWKV-6-3B's prefill (4 x 4,096 tokens, 40 heads of 64, bf16 r/k/v and
     fp32 log-decays, y and the final state), in fp32 at 1 x 512, and at a
     ragged 1,007 tokens from a given state. fp32 launches are held at the
     reference's own kernel-test tolerances (flash rtol 1e-4 / atol 2e-4,
     wkv6 1e-4 / 1e-4, each atol times the plain result's largest
     magnitude, at least 1). bf16 launches get rtol 1e-2, which covers one
     bf16 rounding of the output on each side (2 x 2^-8 of its value), and
     an absolute term for what else the kernel does: flash rounds each p
     to bf16 before the PV product as the TPU kernel does (the plain
     version keeps fp32 p), which moves an output by at most 2^-8 (P|v|)
     for that element, so its atol is 4e-3 x (P|v|), element by element,
     with P|v| the plain version run on |v|; wkv6 rounds nothing inside,
     so its atol stays the fp32 one. The state is held at 1e-4. Each
     launch line gives the plain result's largest and mean magnitude and
     the largest share of its allowance an element used (``tol_used``).
     Each flash line names its route (``wgmma`` for bf16: both products
     on the tensor cores on TMA-fed tiles; ``fma`` for fp32) and its
     achieved rate (``tflops``, the unmasked pairs' 4 D flops per pair).
     Yardstick: ``scaled_dot_product_attention`` for flash (k
     and v repeated to 32 heads outside the timing); none computes wkv6.
     Bounds: flash's bytes (q, k, v, out once; k and v unrepeated) and its
     flops over the unmasked pairs (4 D per pair) at the bf16 tensor-core
     rate (989 TFLOP/s) for bf16 launches and 67 TFLOP/s for fp32; wkv6's
     bytes, and its work per chunk (``wkv6_flops``) on three units, the
     largest time counting: the products (r~ S, A v, k~^T v) at the TF32
     rate (its products run on the tensor cores, 3xTF32), the elementwise
     and pairwise flops at 67 TFLOP/s, the exponentials at the SFU's 16 a
     clock per SM on 132 SMs at ``nvidia-smi``'s max SM clock; beside it
     ``bound_fp32_ms``, every flop at 67 TFLOP/s as before. wkv6 lines
     name the route, the heads per thread block, the thread blocks, the
     shared memory and the build report's registers and spill bytes. Only
     the main-path launches enter the ``kernels`` line's times;
  8. serving, each model with every launch count set to 0 just before and
     read just after each prefill and each decode step: a 256-token
     warm-up prefill, the prefill of 4 prompts of 4,096 numpy-seeded
     tokens, the KV cache grown by 16 slots (``examples/lm_serve.py``),
     16 greedy decode steps, then the last step once more under
     ``torch.profiler`` (device busy time and kernel count). Exactly 32
     launches of the model's kernel per prefill and none per decode step;
     finite logits. Printed: init, prefill and decode times, tokens/s,
     the peak device memory of the init and of serving;
  9. prefill/decode consistency in fp32 (TF32 off) at full width and 2
     layers: the last logits of a 1,024-token prefill against a
     1,023-token prefill and one decode step, within rtol 1e-4 and atol
     1e-4 times the largest logit (fp32 sums over 4,096 features and 1,024
     positions taken in another order by the two paths);
  10. summary: one ``{"kernels": [...]}`` line, then the last line
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

if __name__ == "__main__":
    # the sampler pool's workers are spawned processes that import this
    # file as __mp_main__, and a worker must not load torch
    import torch

SCALE = 18          # 2^18 vertices, Reddit's 602 features and 41 classes
ITERATIONS = 5
BLOCKCSR_ITERATIONS = 3
MERGED_TARGETS = 128    # one destination block at the last layer
MERGED_ITERATIONS = 2
RESIDENT_P4 = 4         # simulated devices of the resident run with misses
RESIDENT_P4_ITERATIONS = 2
# the host runtime phase: two epochs a run, the resident path at p = 1 on
# these backends, p = 4 with the "load" policy, and a worker killed at
# partition 0's batch 13 of the first epoch (epoch 1: every epoch starts
# with a reset)
HOST_EPOCHS = 2
HOST_BACKENDS = ("pallas_fused", "pallas_edges")
HOST_P4 = 4
HOST_FAULT = "kill@0.1.13"
SEED = 0
RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-4
BWD_PARTIAL_CAP = 8 << 20   # fused_bwd's dw partials stay under this
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
# exponentials (ex2 on the special-function units): 16 a clock per SM on
# 132 SMs, at the clock ``nvidia-smi --query-gpu=clocks.max.sm`` reports
# (set in phase 1)
SFU_EXP_PER_CLOCK_PER_SM, H100_SMS = 16, 132
SFU_EXP_PER_S = None
# the LM zoo's serving paths: 4 prompts of 4,096 tokens, the cache grown by
# 16 slots, 16 greedy decode steps; a 256-token prefill first warms cuBLAS
# and the allocator; prefill/decode consistency in fp32 at 2 layers
LM_ARCHS = ("llama3-8b", "rwkv6-3b")
LM_BATCH, LM_PROMPT, LM_WARM_PROMPT, LM_DECODE = 4, 4096, 256, 16
CONSIST_LAYERS, CONSIST_BATCH, CONSIST_PROMPT = 2, 2, 1024
CONSIST_TOL = 1e-4
# kernel vs plain on the card: fp32 at the reference's own kernel-test
# tolerances; bf16 at rtol 1e-2 (one bf16 rounding of the output on each
# side) with flash's atol 4e-3 x (P|v|) element-wise (each p rounded to
# bf16 once: 2^-8, plus fp32 sums) and wkv6's the fp32 one
FLASH_TOL = dict(rtol=1e-4, atol=2e-4)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_RTOL = 1e-2
FLASH_BF16_P_ATOL = 4e-3
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
    "flash_attention_fwd": (
        "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "src/repro/kernels/flash_attention.py:22"),
    "wkv6_chunk": ("src/repro_torch/kernels/csrc/wkv6_chunk.cu",
                   "src/repro/kernels/wkv6.py:20"),
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


def check_close(name: str, what: str, out, ref, rtol: float = RTOL,
                atol: float = ATOL) -> float:
    """Fails unless ``out`` matches ``ref`` within ``rtol`` and ``atol``
    times the largest magnitude of ``ref`` (at least 1; see the module
    docstring for the tolerances); returns the max abs error."""
    if out is None or ref is None:
        if out is not None or ref is not None:
            fail(f"{name}: {what} is {out} on the kernel, {ref} plain")
        return 0.0
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    return check_within(name, what, out, ref, rtol,
                        atol * scale)["max_abs_err"]


def check_within(name: str, what: str, out, ref, rtol: float,
                 atol) -> dict:
    """Fails unless ``out`` is finite, of ``ref``'s shape and within
    ``rtol`` |ref| + ``atol`` of ``ref`` element by element (``atol`` a
    number or a tensor of ``ref``'s shape). Returns the max abs error,
    the largest share of its allowance an element used, and the largest
    and mean magnitude of ``ref``, so the margin shows on the line."""
    if out.shape != ref.shape:
        fail(f"{name}: {what} has shape {tuple(out.shape)}, plain "
             f"{tuple(ref.shape)}")
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite {what}")
    if not out.numel():
        return {"max_abs_err": 0.0, "tol_used": 0.0}
    err = (out - ref).abs()
    allowed = rtol * ref.abs() + atol
    used = err / allowed.clamp_min(torch.finfo(torch.float32).tiny)
    worst = int(used.argmax())
    row = {"max_abs_err": float(err.max()), "tol_used": float(used.max()),
           "ref_max_abs": float(ref.abs().max()),
           "ref_mean_abs": float(ref.abs().mean())}
    if not bool((err <= allowed).all()):
        fail(f"{name}: {what} of the kernel disagrees with the plain "
             f"version: {int((err > allowed).sum())} of {err.numel()} "
             f"elements past their allowance; worst at flat index {worst}: "
             f"kernel {float(out.flatten()[worst])}, plain "
             f"{float(ref.flatten()[worst])}, allowed "
             f"{float(allowed.flatten()[worst])} ({row})")
    return row


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


def bound(bytes_moved: int, flops: int, rate: float = FP32_FLOPS) -> dict:
    """The least time of a launch: its bytes over the memory rate or its
    flops over ``rate`` (the fp32 rate unless the launch's type has
    another), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bytes": bytes_moved, "flops": flops, "op_rate": rate,
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bound_parts(bytes_moved: int, parts: dict, flops_fp32: int) -> dict:
    """The least time of a launch whose work runs on several units: the
    largest of its bytes over the memory rate and each part's count over
    its unit's rate (``parts``: {name: (count, rate)}; products at the TF32
    rate, elementwise flops at the fp32 rate, exponentials at the SFU's).
    ``bound_fp32_ms`` keeps the earlier bound, every flop (``flops_fp32``)
    at the fp32 rate, so rows stay comparable with it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_parts = {name: n / rate * 1e3 for name, (n, rate) in parts.items()}
    t_ops = max(t_parts.values())
    return {"bytes": bytes_moved,
            **{f"{name}": n for name, (n, _) in parts.items()},
            "op_rates": {name: rate for name, (_, rate) in parts.items()},
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            **{f"{name}_ms": t for name, t in t_parts.items()},
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fp32_ms": bound(bytes_moved, flops_fp32)["bound_ms"]}


def ptxas_usage(report: str) -> dict:
    """{kernel function: {registers, spill_bytes}} from ``nvcc -Xptxas
    -v``'s report (spill bytes: stores plus loads)."""
    usage, fn = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            usage[fn] = {"registers": None, "spill_bytes": 0,
                         "smem_bytes": 0}
        elif fn and "spill stores" in line:
            words = line.replace(",", "").split()
            usage[fn]["spill_bytes"] = (int(words[words.index("spill") - 2])
                                        + int(words[-4]))
        elif fn and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            usage[fn]["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                usage[fn]["smem_bytes"] = int(words[words.index("smem") - 2])
    return usage


def build_usage(usage: dict, key: str) -> dict:
    """The largest registers and spill bytes over the functions whose name
    holds ``key`` (one kernel's instantiations)."""
    hits = [u for fn, u in usage.items() if key in fn]
    if not hits:
        fail(f"no kernel function matching {key!r} in the build report")
    return {"registers": max(u["registers"] or 0 for u in hits),
            "spill_bytes": max(u["spill_bytes"] for u in hits),
            "build_functions": len(hits)}


def on_card(lay: dict, keys) -> list:
    return [torch.from_numpy(np.ascontiguousarray(lay[k])).cuda()
            for k in keys]


def report(row: dict) -> dict:
    print("launch " + json.dumps(row), flush=True)
    return row


def check_edges_launch(name, agg, lay, keys, h, n_out, usage):
    """aggregate_edges vs plain on the card, twice, bitwise equal; its
    shape (row groups, rows a group, columns a warp walks at once, load
    width, thread blocks, busy destination blocks), build (registers,
    spills of the launch's instantiation), times and bound for one
    launch."""
    args = on_card(lay, keys)
    out = agg.aggregate_edges(*args, h)
    again = agg.aggregate_edges(*args, h)
    ref = agg.aggregate_edges_plain(*args, h)
    torch.cuda.synchronize()
    max_abs = check_close(name, "out", out, ref)
    if not torch.equal(out, again):
        fail(f"{name}: two launches gave different bits")
    err = (out - ref).abs()
    max_rel = float((err / ref.abs().clamp_min(ATOL)).max())
    a = csr(lay, keys, n_out, h.shape[0])
    lib_err = float((sparse_mm(a, h) - ref).abs().max())
    dst, src, _ = edge_coords(lay, keys)
    F = h.shape[1]
    n_dstb, max_blk = lay[keys[3]].shape
    groups = agg.aggregate_edges_shape(
        n_dstb, F, torch.cuda.get_device_properties(0).multi_processor_count)
    vec = agg.aggregate_edges_vec(h)
    busy = int((np.diff(lay[keys[2]][::max_blk]) > 0).sum())
    row = {"kernel": "aggregate_edges", "launch": name, "edges": len(dst),
           "src_rows": len(np.unique(src)), "h": list(h.shape),
           "out": [n_out, F], "groups": groups, "rows_a_group": 128 // groups,
           "slab": 128, "vec": vec, "ctas": groups * n_dstb,
           "real_blocks": busy, "busy_ctas": groups * busy,
           **build_usage(usage, f"aggregate_edges_kernelILi{vec}E"),
           "max_abs_err": max_abs, "max_rel_err": max_rel,
           "bitwise_repeat": True, "library_max_abs_err": lib_err,
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


def check_fused_fwd(name, agg, lay, h, w, usage, s=None):
    """aggregate_fused vs plain on the card, twice, bitwise equal; its
    shape (slab, cluster, rounds, thread blocks, busy destination blocks),
    build (registers, spills), device split, times, yardsticks and bound
    for one launch (no bias and no activation: the models keep those
    outside the kernel)."""
    args = on_card(lay, FWD)
    out = agg.aggregate_fused(*args, h, w, None, s)
    again = agg.aggregate_fused(*args, h, w, None, s)
    ref = agg.aggregate_fused_plain(*args, h, w, None, s)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail(f"{name}: two launches gave different bits")
    F, N = w.shape
    n_dstb = lay["cols"].shape[0]
    slab, cluster, rounds = agg.aggregate_fused_shape(
        n_dstb, F, N, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    seg = lay["tile_seg"][::lay["cols"].shape[1]]
    row = {"kernel": "aggregate_fused", "launch": name,
           **fused_shapes(lay, h, w, s),
           "smem_bytes": agg.aggregate_fused_smem_bytes(slab),
           "real_blocks": int((np.diff(seg) > 0).sum()), "n_dstb": n_dstb,
           "slab": slab, "cluster": cluster, "rounds": rounds,
           "ctas": cluster * n_dstb * -(-N // 128),
           "max_active_clusters": agg.aggregate_fused_max_clusters(
               slab, cluster),
           # the h rows the walk gathers, an edge's row once for each edge
           "gather_bytes": 4 * F * int(lay["tile_seg"][-1]),
           "max_abs_err": check_close(name, "out", out, ref),
           "bitwise_repeat": True,
           # this launch's instantiation: slab S, one or several rounds
           **build_usage(usage, f"aggregate_fused_kernelILi{slab}ELb"
                                f"{int(rounds > 1)}E"),
           "build": {fn[fn.index("aggregate_fused_kernel"):][:34]: u
                     for fn, u in usage.items()
                     if "aggregate_fused_kernel" in fn},
           "device_kernels": device_split(
               lambda: agg.aggregate_fused(*args, h, w, None, s))}
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


def device_split(fn, calls: int = 10, counts: dict | None = None) -> dict:
    """Device milliseconds per call of ``fn`` by kernel, from
    ``torch.profiler`` over ``calls`` calls: {kernel name: ms}; with
    ``counts``, also fills it with each kernel's launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name.replace("(anonymous namespace)::", "")
            key = key.replace("void ", "").split("(")[0][-80:]
            split[key] = (split.get(key, 0.0)
                          + e.time_range.elapsed_us() / 1e3 / calls)
            if counts is not None:
                counts[key] = counts.get(key, 0) + 1
    if counts is not None:
        for key in counts:
            counts[key] /= calls
    return split


def check_fused_bwd(name, agg, lay, h, w, g, usage, s=None):
    """fused_bwd vs plain on the card (act none: dw only), twice, bitwise
    equal; its plan (real blocks, groups, slab, partial bytes), times
    (the whole call, and the dw kernel, the reduce and the plan's PyTorch
    ops apart, by the profiler), yardsticks and bound."""
    args = on_card(lay, FWD)
    got = agg.fused_bwd(*args, h, g, w, None, s)
    again = agg.fused_bwd(*args, h, g, w, None, s)
    want = agg.fused_bwd_plain(*args, h, g, w, None, s)
    torch.cuda.synchronize()
    err = max(check_close(name, what, a, b)
              for what, a, b in zip(("dw", "db", "dy"), got, want))
    if not torch.equal(got[0], again[0]):
        fail(f"{name}: two launches gave different dw bits")
    if got[1] is not None and not torch.equal(got[1], again[1]):
        fail(f"{name}: two launches gave different db bits")
    F, N = w.shape
    n_dstb = lay["cols"].shape[0]
    slab, groups = agg.fused_bwd_shape(n_dstb, F, N, torch.cuda
                                       .get_device_properties(0)
                                       .multi_processor_count)
    seg = lay["tile_seg"][::lay["cols"].shape[1]]
    split = device_split(lambda: agg.fused_bwd(*args, h, g, w, None, s))
    dw_ms = sum(t for k, t in split.items() if "fused_dw" in k)
    reduce_ms = sum(t for k, t in split.items() if "fused_reduce" in k)
    row = {"kernel": "fused_bwd", "launch": name,
           **fused_shapes(lay, h, w, s),
           "smem_bytes": agg.fused_bwd_smem_bytes(args[3].shape[1], slab),
           "real_blocks": int((np.diff(seg) > 0).sum()),
           # the h rows the walk gathers, an edge's row once for each edge
           "gather_bytes": 4 * F * int(lay["tile_seg"][-1]),
           "n_dstb": n_dstb, "groups": groups, "slab": slab,
           "ctas": groups * -(-F // slab) * -(-N // 128),
           "partial_bytes": groups * F * N * 4, "max_abs_err": err,
           "dw_bitwise_repeat": True,
           **build_usage(usage, "fused_dw"),
           "dw_kernel_ms": dw_ms, "reduce_ms": reduce_ms,
           "plan_ms": sum(split.values()) - dw_ms - reduce_ms,
           "device_kernels": split}
    if row["partial_bytes"] > BWD_PARTIAL_CAP:
        fail(f"{name}: {row['partial_bytes']} B of dw partials, over the "
             f"{BWD_PARTIAL_CAP} B cap")
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


def check_merged(name, agg, lay, h, w, g, s, usage):
    """fused_bwd_merged vs plain on the card (one destination block, act
    none), twice, bitwise equal, and dh bitwise equal to the
    ``aggregate_edges`` kernel over A^T (the unfused branch's dh); its shape
    (dh row groups, dw row groups, thread blocks, load width), build
    (registers, spills, static and dynamic shared memory of the launch's
    instantiation), device split (one kernel a call), times, yardsticks and
    bound."""
    args = on_card(lay, FWD + BWD)
    dz = (g @ w.T).contiguous()
    got = agg.fused_bwd_merged(*args, h, g, dz, s)
    again = agg.fused_bwd_merged(*args, h, g, dz, s)
    want = agg.fused_bwd_merged_plain(*args, h, g, dz, s)
    dh_edges = agg.aggregate_edges(*args[4:], dz)
    torch.cuda.synchronize()
    err = max(check_close(name, what, a, b)
              for what, a, b in zip(("dw", "db", "dh"), got, want))
    for what, a, b in zip(("dw", "db", "dh"), got, again):
        if a is not None and not torch.equal(a, b):
            fail(f"{name}: two launches gave different {what} bits")
    if not torch.equal(got[2], dh_edges):
        fail(f"{name}: dh differs from the aggregate_edges kernel over A^T "
             f"in {int((got[2] != dh_edges).sum())} elements")
    F, N = w.shape
    n_srcb = lay["cols_t"].shape[0]
    dh_groups, dw_groups, ctas = agg.fused_bwd_merged_shape(
        n_srcb, F, N, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    vec = min(agg.aggregate_edges_vec(h), agg.aggregate_edges_vec(dz))
    key = f"fused_bwd_merged_kernelILi{vec}E"
    counts = {}
    split = device_split(lambda: agg.fused_bwd_merged(*args, h, g, dz, s),
                         counts=counts)
    if sum(counts.values()) != 1.0:
        fail(f"{name}: {counts} device kernels a call, expected one")
    row = {"kernel": "fused_bwd_merged", "launch": name,
           **fused_shapes(lay, h, w, s),
           "edges_t": int(lay["tile_seg_t"][-1]), "n_srcb": n_srcb,
           "dh_groups": dh_groups, "dw_groups": dw_groups, "ctas": ctas,
           "vec": vec, **build_usage(usage, key),
           "static_smem_bytes": max(u["smem_bytes"] for fn, u in usage.items()
                                    if key in fn),
           "dynamic_smem_bytes": agg.fused_bwd_merged_smem_bytes(
               F, dw_groups),
           "max_abs_err": err, "bitwise_repeat": True,
           "dh_equals_aggregate_edges": True,
           "device_kernels": split, "device_launches_a_call": counts}
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
    triples, as ``AggregateCompact`` runs them: the kernel walking only the
    real slots (``real_slot_counts``) vs the plain version on the card,
    the times (``densify_ms`` and ``counts_ms`` on their own), the BSR (or
    CSR) yardstick and the bound. ``lay_e`` / ``keys_e`` are the same
    launch's edge segments, for the CSR."""
    tile_id, tile_off, val, cols = (lay_c[k] for k in keys)
    dens = on_card(lay_c, keys)
    tiles = agg.densify_tiles(*dens[:3], *cols.shape)
    cols_d = dens[3]
    nblk = agg.real_slot_counts(dens[0], *cols.shape)
    out = agg.aggregate_blockcsr(tiles, cols_d, h, nblk)
    ref = agg.aggregate_blockcsr_plain(tiles, cols_d, h, nblk)
    torch.cuda.synchronize()
    n_dstb, max_blk = cols.shape
    F = h.shape[1]
    slots = np.unique(tile_id[val != 0]).astype(np.int64)
    counts = nblk.cpu().numpy()
    walked = np.concatenate([i * max_blk + np.arange(c)
                             for i, c in enumerate(counts)]).astype(np.int64)
    lib_name, a = blockcsr_library(tiles, cols, slots, h.shape[0], lay_e,
                                   keys_e)
    row = {"kernel": "aggregate_blockcsr", "launch": name,
           "dst_blocks": n_dstb, "slots": n_dstb * max_blk,
           "real_slots": len(slots), "real_slots_walked": len(walked),
           "max_real_slots": int(counts.max()), "h": list(h.shape),
           "out": [n_dstb * 128, F], "tile_bytes": tiles.numel() * 4,
           "smem_bytes": agg.aggregate_blockcsr_smem_bytes(),
           "max_abs_err": check_close(name, "out", out, ref),
           "library": lib_name,
           "library_max_abs_err": float((sparse_mm(a, h) - ref).abs().max())}
    short = dict(iters=iters, warmup=1 if iters < 5 else 3)
    row.update(
        densify_ms=time_ms(lambda: agg.densify_tiles(*dens[:3],
                                                     *cols.shape), **short),
        counts_ms=time_ms(lambda: agg.real_slot_counts(dens[0],
                                                       *cols.shape)),
        ms=time_ms(lambda: agg.aggregate_blockcsr(tiles, cols_d, h, nblk)),
        plain_ms=time_ms(lambda: agg.aggregate_blockcsr_plain(
            tiles, cols_d, h, nblk), **short),
        library_ms=time_ms(lambda: sparse_mm(a, h), **short))
    # the bytes the walk must move: the walked tiles and their cols, the
    # counts, the h rows of the source blocks they name, the output; the
    # real slots' flops at the TF32 rate, the fastest the card multiplies
    # fp32 inputs (the kernel's 3xTF32 split does three TF32 products per
    # product, so its own ceiling is a third of it)
    src_blocks = len(np.unique(cols.reshape(-1)[walked]))
    bytes_moved = (4 * len(walked) * (128 * 128 + 1) + 4 * n_dstb
                   + 4 * 128 * F * (src_blocks + n_dstb))
    row.update(bound(bytes_moved, 2 * 128 * 128 * F * len(slots),
                     TF32_FLOPS))
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    del tiles, a
    return report(row)


def check_update_launch(name, um, x, w, b, act, usage):
    """update_mlp vs plain on the card, its times, the ``torch.addmm``
    yardstick (``.relu_()`` after it for the relu launch) and the bound:
    the products at the TF32 rate, the fastest the card multiplies fp32
    inputs (the kernel's 3xTF32 split does three TF32 products per
    product), beside the earlier fp32-rate bound."""
    out = um.update_mlp(x, w, b, act)
    ref = um.update_mlp_plain(x, w, b, act)
    torch.cuda.synchronize()
    (M, K), N = x.shape, w.shape[1]
    if act == "none":
        def lib():
            return torch.addmm(b, x, w)
    elif act == "relu":
        def lib():
            return torch.addmm(b, x, w).relu_()
    else:
        fail(f"{name}: no yardstick for act {act!r}")
    tiles = um.plan(M, N, torch.cuda.get_device_properties(0)
                    .multi_processor_count)
    bm, bn = um.TILES[tiles]
    row = {"kernel": "update_mlp", "launch": name, "x": [M, K],
           "w": [K, N], "act": act, "route": "mma.sync 3xTF32",
           "tiles": [bm, bn], "thread_blocks": -(-M // bm) * -(-N // bn),
           "smem_bytes": um.update_mlp_smem_bytes(tiles),
           **build_usage(usage, f"TileILi{bm}ELi{bn}E"),
           "max_abs_err": check_close(name, "out", out, ref),
           "library": "torch.addmm" + (".relu_" if act == "relu" else ""),
           "ms": time_ms(lambda: um.update_mlp(x, w, b, act)),
           "plain_ms": time_ms(lambda: um.update_mlp_plain(x, w, b, act)),
           "library_ms": time_ms(lib)}
    flops = 2 * M * K * N
    row.update(bound_parts(4 * (M * K + K * N + N + M * N),
                           {"products_tf32": (flops, TF32_FLOPS)}, flops))
    row["tflops"] = flops / row["ms"] / 1e9
    return report(row)


def run_path(label, trainer, groups, expected, agg) -> dict:
    """Drive one path through ``run_iteration`` with every launch count set
    to 0 just before and read just after; fails on any other count per
    iteration than ``expected`` or on a non-finite loss. Each iteration
    line carries the store's running ``beta``."""
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
                 nvtps=m["vertices_traversed"] / wall,
                 beta=trainer.store.beta())
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


def check_resident(label, run, host_run) -> None:
    """A ``data_parallel`` run against the host-gather run of the same
    backend and batches: the same first loss bit for bit, the shard
    uploaded at the first step and never again."""
    first, host_first = run["steps"][0]["loss"], host_run["steps"][0]["loss"]
    if first != host_first:
        fail(f"{label}: first loss {first!r}, host-gather run "
             f"{host_first!r}")
    uploads = [m["shard_upload_s"] for m in run["steps"]]
    if not uploads[0] > 0 or any(uploads[1:]):
        fail(f"{label}: shard_upload_s {uploads}: one upload, at the first "
             f"step")
    print(f"{label}: first loss {first!r}, bitwise the host-gather run's",
          flush=True)


def check_assembly(name, assemble, payload, store, features, mb,
                   dev) -> dict:
    """``assemble_device_feats`` at one batch on the card against
    ``FeatureStore.gather`` (bit for bit), from the trainer's index payload
    (``payload``: ``core.trainer.resident_payload``), timed by CUDA events.
    Its bound counts the bytes it must move: the valid rows read (from the
    shard or the shipped miss rows), the (N_0, f) block written and the
    index arrays."""
    ids = np.asarray(mb.nodes[0])
    valid = np.asarray(mb.node_mask[0], bool)
    idx = payload(store.core, dev, ids, valid)
    shard = torch.from_numpy(store.build_shard_matrix()[dev]).cuda()
    batch = {k: torch.from_numpy(a).cuda() for k, a in idx.items()}
    batch["miss_rows"] = torch.from_numpy(
        features[ids[idx["miss_pos"]]]).cuda()
    batch["node_mask"] = [torch.from_numpy(valid).cuda()]
    got = assemble(shard, batch)
    want = torch.from_numpy(store.gather(dev, ids, valid)).cuda()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"{name}: the block assembled on the card differs from "
             f"FeatureStore.gather")
    del got, want
    n, f = ids.shape[0], features.shape[1]
    n_valid = int(valid.sum())
    moved = n_valid * f * 4 + n * f * 4 + sum(a.nbytes for a in idx.values())
    b = bound(moved, 0)
    row = {"name": name, "kernel": "assemble_device_feats",
           "route": "pytorch", "device": dev, "rows": n,
           "valid_rows": n_valid, "hit_rows": len(idx["hit_idx"]),
           "miss_rows": len(idx["miss_pos"]), "shard_rows": shard.shape[0],
           "bitwise_equal_gather": True,
           "ms": time_ms(lambda: assemble(shard, batch)), **b}
    del shard, batch
    torch.cuda.empty_cache()
    return report(row)


def check_first_loss(label, run, ref_loss) -> None:
    first = run["steps"][0]["loss"]
    if not np.isclose(first, ref_loss, rtol=LOSS_RTOL, atol=0):
        fail(f"{label}: first loss {first} vs reference backend {ref_loss}")
    print(f"{label}: first loss {first!r} vs reference backend "
          f"{ref_loss!r}", flush=True)


def kernel_entry(name, rows, launches_by_path) -> dict:
    """One kernel's entry of the ``kernels`` line: times and bounds summed
    over the checked launches at the main paths' shapes (``main_path``,
    default true), the largest error over every checked launch."""
    src, replaces = KERNEL_SOURCES[name]
    main = [r for r in rows if r.get("main_path", True)]
    t_bytes = sum(r["bytes_ms"] for r in main)
    t_ops = sum(r["ops_ms"] for r in main)

    def total(key):
        vals = [r[key] for r in main]
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

# ---------------------------------------------------------------------------
# the LM zoo: flash_attention_fwd and wkv6_chunk, and serving
# ---------------------------------------------------------------------------

def check_flash_launch(name, fa, B, Sq, Sk, H, KH, D, dtype, causal,
                       main_path, iters=5):
    """flash_attention_fwd vs its plain version on the card at (B, S, H, D)
    with KH kv heads, its times, the SDPA yardstick (k and v repeated to H
    heads beforehand, outside the timing) and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((B, S, h, D), device="cuda", generator=gen
                           ).to(dtype)
               for S, h in ((Sq, H), (Sk, KH), (Sk, KH)))
    out = fa.flash_attention_fwd(q, k, v, causal)
    ref = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        tol = check_within(name, "out", out, ref, FLASH_TOL["rtol"],
                           FLASH_TOL["atol"] * max(1.0, float(
                               ref.abs().max())))
    else:
        # the kernel rounds each p to bf16 (relative 2^-8) before PV: an
        # output moves by at most 2^-8 (P|v|), P|v| from the plain version
        p_abs_v = fa.flash_attention_plain(q.float(), k.float(),
                                           v.float().abs(), causal)
        tol = check_within(name, "out", out, ref, BF16_RTOL,
                           FLASH_BF16_P_ATOL * p_abs_v)
        tol["p_abs_v_mean"] = float(p_abs_v.mean())
        del p_abs_v
    del ref
    G = H // KH
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)
    lib_err = float((sdpa().transpose(1, 2).float() - out.float())
                    .abs().max())
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    elt = q.element_size()
    row = {"kernel": "flash_attention_fwd", "launch": name,
           "main_path": main_path, "q": [B, Sq, H, D], "kv": [B, Sk, KH, D],
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "route": fa.ROUTES[dtype],
           "smem_bytes": fa.flash_attention_fwd_smem_bytes(D, dtype), **tol,
           "library": "scaled_dot_product_attention",
           "library_vs_kernel_max_abs": lib_err,
           "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal),
                         iters=iters, warmup=1),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(
               q, k, v, causal), iters=2, warmup=1),
           "library_ms": time_ms(sdpa, iters=10)}
    row.update(bound(elt * (2 * B * Sq * H * D + 2 * B * Sk * KH * D),
                     4 * D * pairs * B * H,
                     FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS))
    row["tflops"] = row["flops"] / row["ms"] / 1e9
    del q, k, v, qt, kt, vt, out
    torch.cuda.empty_cache()
    return report(row)


def wkv6_flops(S: int, K: int, chunk: int = 16) -> tuple:
    """(products, elementwise flops, exponentials) of the chunked WKV6
    recurrence over S tokens of one head (K = V): per chunk of L tokens the
    products r~ S (2 L K K), A v over the L(L-1)/2 pairs and the diagonal
    (2 (pairs + L) K) and k~^T v (2 L K K); the pairwise sums of A (a
    multiply and a multiply-add per pair and channel, and the difference
    of exponents), the bonus, the decayed rows, the cumsums and the state's
    decay (2 K K); the pairs' exponentials and the 2 L K + K of the decayed
    rows and exp(c_last)."""
    products = elementwise = exps = 0
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        pairs = L * (L - 1) // 2
        products += 2 * L * K * K + 2 * (pairs + L) * K + 2 * L * K * K
        elementwise += (6 * pairs * K + 3 * L * K + 2 * L * K + 2 * K * K
                        + L * K)
        exps += pairs * K + 2 * L * K + K
    return products, elementwise, exps


def check_wkv6_launch(name, wk, B, S, H, K, dtype, with_state, main_path,
                      usage, iters=10):
    """wkv6_chunk vs its plain version on the card (y and the final state),
    its times and the bound (products at the TF32 rate, elementwise flops
    at the fp32 rate, exponentials at the SFU's, beside the earlier
    fp32-rate bound); no single PyTorch call computes it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale
    r, k, v = (randn(B, S, H, K, scale=0.5).to(dtype) for _ in range(3))
    lw = -randn(B, S, H, K).exp()
    u = randn(H, K, scale=0.5).to(dtype)
    s0 = randn(B, H, K, K) if with_state else None
    y, st = wk.wkv6_chunk(r, k, v, lw, u, s0)
    y_p, st_p = wk.wkv6_chunk_plain(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    scale = max(1.0, float(y_p.abs().max()))
    tol = check_within(name, "y", y, y_p, WKV_TOL["rtol"]
                       if dtype == torch.float32 else BF16_RTOL,
                       WKV_TOL["atol"] * scale)
    tol_s = check_within(name, "state", st, st_p, WKV_TOL["rtol"],
                         WKV_TOL["atol"] * max(1.0, float(
                             st_p.abs().max())))
    tol.update(max_abs_err=max(tol["max_abs_err"], tol_s["max_abs_err"]),
               state_tol_used=tol_s["tol_used"])
    products, elementwise, exps = (n * B * H for n in wkv6_flops(S, K))
    hpb = wk.heads_per_block(B * H, torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    elt = r.element_size()
    row = {"kernel": "wkv6_chunk", "launch": name, "main_path": main_path,
           "r": [B, S, H, K], "dtype": str(dtype).replace("torch.", ""),
           "initial_state": with_state, "route": "mma.sync 3xTF32",
           "heads_per_block": hpb, "thread_blocks": -(-B * H // hpb),
           "smem_bytes": wk.wkv6_chunk_smem_bytes(K, dtype, hpb),
           **build_usage(usage, "wkv6_chunk_kernelI" + (
               "f" if dtype == torch.float32 else "13__nv_bfloat16")
               + f"Li{K}ELi{hpb}E"), **tol,
           "ms": time_ms(lambda: wk.wkv6_chunk(r, k, v, lw, u, s0),
                         iters=iters),
           "plain_ms": time_ms(lambda: wk.wkv6_chunk_plain(
               r, k, v, lw, u, s0), iters=2, warmup=1),
           "library_ms": None}
    row.update(bound_parts(
        elt * (4 * B * S * H * K + H * K) + 4 * B * S * H * K
        + 4 * B * H * K * K * (2 if with_state else 1),
        {"products_tf32": (products, TF32_FLOPS),
         "elementwise_fp32": (elementwise, FP32_FLOPS),
         "exponentials": (exps, SFU_EXP_PER_S)},
        products + elementwise))
    row["tflops"] = (products + elementwise) / row["ms"] / 1e9
    del r, k, v, lw, y, y_p
    torch.cuda.empty_cache()
    return report(row)


def traced(fn, cpu: bool = True) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (to a
    synchronize), the device kernels it ran, the time the device was busy
    (the union of their intervals, so kernels and copies that overlap on
    two streams count once) and the device's idle share of the wall time.
    ``cpu=False`` traces the device alone, which keeps the profiler off the
    host's critical path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu
                                            else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, None
    for lo, hi in spans:
        if end is None or lo > end:
            busy_us += hi - lo
            end = hi
        elif hi > end:
            busy_us += hi - end
            end = hi
    busy_ms = busy_us / 1e3
    return {"wall_ms": wall_ms, "device_kernels": len(kernels),
            "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if kernels
            else None}


def serve(arch) -> dict:
    """One model at its published width and depth through the serving
    entry points, in bf16 from a seeded init: a warm-up prefill, the
    prefill of LM_BATCH prompts of LM_PROMPT numpy-seeded tokens, the cache
    grown by LM_DECODE slots (``examples/lm_serve.py``), then LM_DECODE
    greedy decode steps. Launch counts are zeroed before and read after
    each prefill and each decode step: exactly one launch of the model's
    kernel per layer and prefill, none per decode step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build as build_mod
    from repro_torch.launch import steps
    from repro_torch.models.registry import build
    from repro_torch.nn.param import flatten
    cfg = get_config(arch)
    kernel = {"dense": "flash_attention_fwd", "ssm": "wkv6_chunk"}[cfg.family]
    bundle = build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = bundle.init_params(SEED, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    weight_bytes = sum(t.numel() * t.element_size() for t in flatten(params))
    prefill = steps.make_prefill_step(bundle)
    decode = steps.make_decode_step(bundle)
    rng = np.random.default_rng(SEED)
    launches = {kernel: 0}
    none = {k: 0 for k in build_mod.launch_counts}
    for label, S in (("warmup", LM_WARM_PROMPT), ("prefill", LM_PROMPT)):
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (LM_BATCH, S)).astype(np.int32)).cuda()
        torch.cuda.synchronize()
        build_mod.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(build_mod.launch_counts)
        if got != {**none, kernel: cfg.n_layers}:
            fail(f"{arch}: {label} launched {got}, expected "
                 f"{cfg.n_layers} {kernel} and nothing else")
        launches[kernel] += got[kernel]
        if tuple(logits.shape) != (LM_BATCH, 1, cfg.vocab_size) \
                or not torch.isfinite(logits).all():
            fail(f"{arch}: {label} logits {tuple(logits.shape)} are not "
                 f"finite of shape ({LM_BATCH}, 1, {cfg.vocab_size})")
    if cfg.family == "dense":  # grow the KV capacity as lm_serve does
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, LM_DECODE))
                 for k, v in cache.items()}
    tok = logits[:, -1].argmax(-1, keepdim=True).int()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_DECODE):
        build_mod.reset_launch_counts()
        logits, cache = decode(params, cache, {"tokens": tok,
                                               "pos": LM_PROMPT + i})
        if dict(build_mod.launch_counts) != none:
            fail(f"{arch}: decode step {i} launched "
                 f"{dict(build_mod.launch_counts)}, expected no kernel")
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
        if i == 0:  # the first step meets new shapes; time it apart
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if not torch.isfinite(logits).all():
        fail(f"{arch}: decode logits are not finite")
    # the last step once more under the profiler: device busy time and
    # kernel count of one decode step (the result is dropped)
    profile = traced(lambda: decode(params, cache, {
        "tokens": tok, "pos": LM_PROMPT + LM_DECODE - 1}))
    run = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "dtype": "bfloat16",
           "weight_bytes": weight_bytes, "allocated_before_bytes": before,
           "init_s": init_s, "init_peak_bytes": init_peak,
           "prefill_s": wall, "prefill_tokens_per_s": LM_BATCH * LM_PROMPT
           / wall, "decode_steps": LM_DECODE, "decode_s": decode_s,
           "decode_first_step_s": first_s,
           "decode_tokens_per_s": LM_BATCH * LM_DECODE / decode_s,
           "decode_steady_tokens_per_s": LM_BATCH * (LM_DECODE - 1)
           / (decode_s - first_s),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "decode_step_profile": profile, "kernel": kernel,
           "launches_per_prefill": cfg.n_layers,
           "launches_per_decode_step": 0, "launches": launches}
    print("serve " + json.dumps(run), flush=True)
    del params, cache, logits
    torch.cuda.empty_cache()
    return run


def consistency(arch) -> dict:
    """Prefilling all CONSIST_PROMPT tokens and taking the last logits
    must match prefilling all but the last token and decoding it: the
    kernel path (flash or wkv6) against the plain decode path
    (``decode_attention``, ``wkv6_recurrent``), in fp32 with TF32 off, at
    full width and CONSIST_LAYERS layers, within rtol CONSIST_TOL and atol
    CONSIST_TOL times the largest logit (at least 1)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models.registry import build
    cfg = get_config(arch).replace(n_layers=CONSIST_LAYERS)
    bundle = build(cfg)
    params = bundle.init_params(SEED + 1, torch.float32, "cuda")
    prefill = steps.make_prefill_step(bundle)
    decode = steps.make_decode_step(bundle)
    S = CONSIST_PROMPT
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (CONSIST_BATCH, S)).astype(np.int32)).cuda()
    full, _ = prefill(params, {"tokens": tokens})
    _, cache = prefill(params, {"tokens": tokens[:, :-1]})
    if cfg.family == "dense":
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                 for k, v in cache.items()}
    last, _ = decode(params, cache, {"tokens": tokens[:, -1:], "pos": S - 1})
    torch.cuda.synchronize()
    err = check_close(f"{arch}/consistency", "last logits", last, full,
                      rtol=CONSIST_TOL, atol=CONSIST_TOL)
    row = {"arch": arch, "layers": CONSIST_LAYERS, "batch": CONSIST_BATCH,
           "prompt": S, "dtype": "float32", "max_abs_err": err,
           "max_abs_logit": float(full.abs().max()),
           "same_argmax": bool(torch.equal(full.argmax(-1),
                                           last.argmax(-1)))}
    print("consistency " + json.dumps(row), flush=True)
    del params, cache
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the host runtime: the prefetch pipeline and the sampler pool
# ---------------------------------------------------------------------------

EPOCH_KEYS = ("loss", "acc", "iterations", "epoch_time_s", "nvtps",
              "host_produce_s", "host_wait_s", "host_gather_s",
              "host_issue_s", "host_fetch_s", "ring_bytes_per_iter",
              "pool_respawns", "pool_resubmissions", "pool_speculative_hits",
              "pool_speculative_launched", "pool_stale_results",
              "pool_crc_failures", "pool_degraded_batches",
              "pool_recovery_s", "pool_degraded", "beta", "pipeline",
              "sampler_workers", "balance_policy", "gather_in_workers")


def machine_facts(graph, cfg, workers, p_max, layer_capacities,
                  PayloadCodec, blk_caps) -> dict:
    """The host's CPUs and ``/dev/shm``, which must hold the shared graph
    and the largest ring (slots of the worst-case payload: every layer-0
    row shipped) of any pool this phase starts; fails if it cannot."""
    import os
    import shutil
    from repro_torch.core.sampler_pool import FeatureShipSpec
    aff = sorted(os.sched_getaffinity(0))
    shm = shutil.disk_usage("/dev/shm")
    graph_bytes = sum(getattr(graph, f).nbytes for f in
                      ("indptr", "indices", "features", "labels",
                       "train_ids"))
    rows = layer_capacities(cfg)[0][0]
    codec = PayloadCodec(cfg, blk_caps, FeatureShipSpec(
        rows, graph.features.shape[1]))
    ring_bytes = (2 * max(workers) + 2) * codec.nbytes
    facts = {"cpu_count": os.cpu_count(), "affinity": aff,
             "dev_shm": {"total": shm.total, "used": shm.used,
                         "free": shm.free},
             "graph_bytes": graph_bytes,
             "largest_ring_bytes_worst_case": ring_bytes,
             "workers": list(workers), "max_devices": p_max}
    print("machine " + json.dumps(facts), flush=True)
    if shm.free < graph_bytes + ring_bytes:
        fail(f"/dev/shm has {shm.free} bytes free; the sampler pool needs "
             f"{graph_bytes} for the graph and up to {ring_bytes} for its "
             f"ring")
    return facts


def codec_cost(graph, cfg, NeighborSampler, PayloadCodec, blk_caps,
               build_layer_layouts) -> dict:
    """Host milliseconds of one paper batch's trip through the sampler
    pool's ring (``PayloadCodec``, no gathered rows): the worker's encode
    (copies and the CRC32 stamp) and the consumer's decode (one copy out
    of the slot and the CRC32 check), and the CRC32 alone; medians of 5."""
    import statistics
    import zlib
    mb = NeighborSampler(graph, cfg, graph.train_ids, 0, SEED).batch_at(1, 0)
    lay = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                              blk_caps, "mean", edge_stream=True)
    codec = PayloadCodec(cfg, blk_caps, None)
    buf = bytearray(codec.nbytes)

    def median_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    row = {"slot_bytes": codec.nbytes,
           "encode_ms": median_ms(lambda: codec.encode(mb, lay, None, buf,
                                                       0)),
           "decode_ms": median_ms(lambda: codec.decode(buf, 0, 0, 0)),
           "crc32_ms": median_ms(lambda: zlib.crc32(buf))}
    print("pool_codec " + json.dumps(row), flush=True)
    return row


def epoch_run(label, make, epochs, per_iter, agg, flatten) -> dict:
    """Train ``epochs`` epochs with the trainer ``make()`` builds, every
    launch count set to 0 just before and read just after, the last epoch
    traced on the device (busy time and idle share). Fails unless the
    counts are the epochs' iterations times ``per_iter``. Prints one
    ``epoch`` line an epoch; returns the metrics, the parameters after
    each epoch (on the host) and the counts."""
    tr = make()
    metrics, params = [], []
    try:
        torch.cuda.synchronize()
        agg.reset_launch_counts()
        trace = None
        for e in range(epochs):
            if e == epochs - 1:
                trace = traced(lambda: metrics.append(tr.run_epoch()),
                               cpu=False)
            else:
                metrics.append(tr.run_epoch())
            params.append([q.detach().cpu() for q in flatten(tr.params)])
        torch.cuda.synchronize()
        launches = dict(agg.launch_counts)
    finally:
        tr.close()
        del tr
        torch.cuda.empty_cache()
    for e, m in enumerate(metrics):
        line = {"path": label, "epoch": e,
                **{k: m[k] for k in EPOCH_KEYS},
                "iteration_s": m["epoch_time_s"] / m["iterations"]}
        if e == epochs - 1:
            line.update(trace)
        print("epoch " + json.dumps(line), flush=True)
        if not np.isfinite(m["loss"]):
            fail(f"{label}: epoch {e} loss is {m['loss']}")
    iters = sum(m["iterations"] for m in metrics)
    want = {k: iters * v for k, v in per_iter.items()}
    if launches != want:
        fail(f"{label}: {iters} iterations launched {launches}, expected "
             f"{want}")
    return {"metrics": metrics, "params": params, "launches": launches,
            "trace": trace}


def check_twin(label, run, twin) -> None:
    """A pipelined or pooled run against its sequential twin: each epoch's
    loss and acc, and the parameters after its last epoch, bit for bit."""
    n = len(run["metrics"])
    for e, (m, t) in enumerate(zip(run["metrics"], twin["metrics"])):
        if (m["loss"], m["acc"]) != (t["loss"], t["acc"]):
            fail(f"{label}: epoch {e} loss/acc {m['loss']!r}/{m['acc']!r}, "
                 f"sequential twin {t['loss']!r}/{t['acc']!r}")
    same = all(torch.equal(a, b)
               for a, b in zip(run["params"][-1], twin["params"][n - 1]))
    if not same:
        fail(f"{label}: parameters after {n} epoch(s) differ from the "
             f"sequential twin's")
    print(f"{label}: {n} epoch(s), loss/acc and parameters bitwise the "
          f"sequential twin's", flush=True)


def host_runtime(SyncGNNTrainer, graph, cfg, params0, counts, agg, flatten,
                 layer_capacities, PayloadCodec, block_capacities,
                 NeighborSampler, build_layer_layouts) -> dict:
    """Phase 5: the pipelined and pooled epochs against their sequential
    twins, from the same initial parameters (the resident path at p = 1 on
    ``"pallas_fused"`` and ``"pallas_edges"``, the host gather on
    ``"pallas_fused"``, p = 4 with the ``"load"`` policy and the gather in
    the workers, and a worker killed mid-epoch)."""
    import os
    workers = sorted({2, 4, min(8, len(os.sched_getaffinity(0)) - 2)})
    machine_facts(graph, cfg, workers, HOST_P4, layer_capacities,
                  PayloadCodec, block_capacities(cfg))
    codec_cost(graph, cfg, NeighborSampler, PayloadCodec,
               block_capacities(cfg), build_layer_layouts)
    runs = {}

    def run(key, backend, epochs=HOST_EPOCHS, p=1, **kw):
        kw.setdefault("data_parallel", True)
        runs[key] = epoch_run(key, lambda: SyncGNNTrainer(
            graph, dataclasses.replace(cfg, aggregate_backend=backend),
            num_devices=p, algorithm="distdgl", seed=SEED, device="cuda",
            params=params0, **kw), epochs,
            {k: p * v for k, v in counts[backend].items()}, agg, flatten)
        return runs[key]

    for backend in HOST_BACKENDS:
        twin = run(f"{backend}/sequential", backend, pipeline=False)
        check_twin(f"{backend}/pipelined",
                   run(f"{backend}/pipelined", backend), twin)
        for n in workers:
            key = f"{backend}/pipelined/{n}_workers"
            check_twin(key, run(key, backend, num_sampler_workers=n), twin)
        if backend == "pallas_fused":
            # a worker killed mid-epoch: respawned, its task re-run
            key = f"{backend}/2_workers/killed"
            fault = run(key, backend, epochs=1, num_sampler_workers=2,
                        fault_spec=HOST_FAULT)
            check_twin(key, fault, twin)
            if not fault["metrics"][0]["pool_respawns"] >= 1:
                fail(f"{key}: no worker was respawned "
                     f"({fault['metrics'][0]})")
    twin = run("pallas_fused/host_gather/sequential", "pallas_fused",
               pipeline=False, data_parallel=False)
    check_twin("pallas_fused/host_gather/pipelined",
               run("pallas_fused/host_gather/pipelined", "pallas_fused",
                   data_parallel=False), twin)
    p4 = dict(p=HOST_P4, balance_policy="load")
    twin = run(f"pallas_fused/p{HOST_P4}/load/sequential", "pallas_fused",
               pipeline=False, **p4)
    key = f"pallas_fused/p{HOST_P4}/load/pipelined/4_workers/gather"
    check_twin(key, run(key, "pallas_fused", num_sampler_workers=4,
                        gather_in_workers=True, **p4), twin)
    if not runs[key]["metrics"][0]["ring_bytes_per_iter"] > 0:
        fail(f"{key}: no bytes crossed the workers' ring")
    return runs


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.configs.gnn import GNNModelConfig
        from repro_torch.core import scheduler as sched
        from repro_torch.core.sampler import (NeighborSampler,
                                              layer_capacities)
        from repro_torch.core.sampler_pool import PayloadCodec
        from repro_torch.core.trainer import SyncGNNTrainer, resident_payload
        from repro_torch.data.graphs import scaled_dataset
        from repro_torch.gnn.models import AGG_KIND, assemble_device_feats
        from repro_torch.kernels import aggregate as agg
        from repro_torch.kernels import build
        from repro_torch.kernels.layout import (block_capacities,
                                                build_layer_layouts)
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops
        from repro_torch.kernels import update_mlp as um
        from repro_torch.kernels import wkv6 as wk
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
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        max_sm_mhz = float(clk.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi gave no max SM clock: {clk.stdout!r} "
             f"{clk.stderr.strip()}")
    global SFU_EXP_PER_S
    SFU_EXP_PER_S = SFU_EXP_PER_CLOCK_PER_SM * H100_SMS * max_sm_mhz * 1e6
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(f"card: {card}", flush=True)
    print(f"max SM clock: {max_sm_mhz} MHz; exponential bound rate "
          f"{SFU_EXP_PER_S:.4g}/s", flush=True)

    # 2. build every kernel source, all nvcc processes at once
    t0 = time.perf_counter()
    try:
        reports = build.build(build.sources())
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    usage = {name: ptxas_usage(rep) for name, rep in reports.items()}
    print(f"build: {len(reports)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, rep in reports.items():
        for line in rep.splitlines():
            if ("ptxas info" in line and ("Used" in line
                                          or "Compiling" in line)) \
                    or "spill" in line or "warning" in line.lower():
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
                           out_rows[0], usage["aggregate_edges"]),
        check_edges_launch("layer1_fwd", agg, layers[1], FWD, h1,
                           out_rows[1], usage["aggregate_edges"]),
        check_edges_launch("layer1_bwd", agg, layers[1], BWD, g1, pad[1],
                           usage["aggregate_edges"])]}
    w0, w1 = randn(f0, hid, scale=f0 ** -0.5), randn(hid, n_cls,
                                                     scale=hid ** -0.5)
    rows["aggregate_fused"] = [
        check_fused_fwd("layer0_fused_fwd", agg, layers[0], h0, w0,
                        usage["aggregate_fused"]),
        check_fused_fwd("layer1_fused_fwd", agg, layers[1], h1, w1,
                        usage["aggregate_fused"])]
    rows["fused_bwd"] = [
        check_fused_bwd("layer0_fused_bwd", agg, layers[0], h0, w0,
                        randn(out_rows[0], hid), usage["aggregate_fused_bwd"]),
        check_fused_bwd("layer1_fused_bwd", agg, layers[1], h1, w1,
                        randn(out_rows[1], n_cls),
                        usage["aggregate_fused_bwd"])]
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
            usage["aggregate_fused"], s_l))
        rows["fused_bwd"].append(check_fused_bwd(
            f"gin{MERGED_TARGETS}_layer{l}_fused_bwd", agg, lay_l, h_l, w_l,
            randn(dst_m[l], w_l.shape[1]), usage["aggregate_fused_bwd"],
            s_l))
    rows["fused_bwd_merged"] = [check_merged(
        "layer1_merged_bwd", agg, lay_m1,
        randn(lay_m1["cols_t"].shape[0] * 128, hid),
        randn(hid, n_cls, scale=hid ** -0.5), randn(128, n_cls),
        randn(128, hid), usage["aggregate_fused_bwd"])]
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
        check_update_launch("layer0_update_relu", um, x0, w0, b0, "relu",
                            usage["update_mlp"]),
        check_update_launch("layer0_update", um, x0, w0, b0, "none",
                            usage["update_mlp"]),
        check_update_launch("layer1_update", um, randn(out_rows[1], hid),
                            w1, b1, "none", usage["update_mlp"])]
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
    # the resident feature path (data_parallel) beside each host-gather run
    resident = {}

    def run_resident(backend, label, n_iter, expected) -> None:
        tr = SyncGNNTrainer(
            graph, dataclasses.replace(cfg, aggregate_backend=backend),
            num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
            params=params0, data_parallel=True)
        key = f"{backend}_resident"
        runs[key] = run_path(f"{label}/resident", tr, groups[:n_iter],
                             expected, agg)
        check_resident(f"{label}/resident", runs[key], runs[backend])
        resident[key] = tr.store

    run_resident("pallas_edges", "graphsage/pallas_edges", ITERATIONS,
                 {**none, "aggregate_edges": 3})
    check_assembly("paper_batch_p1", assemble_device_feats, resident_payload,
                   resident["pallas_edges_resident"], graph.features, mb, 0)
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
    fused_counts = {**none, "aggregate_fused": 2, "fused_bwd": 2,
                    "aggregate_edges": 1}
    run_resident("pallas_fused", "graphsage/pallas_fused", ITERATIONS,
                 fused_counts)
    # p = 4: real miss rows cross the bus; every slot runs a batch (idle
    # ones at weight 0), so each count is p times the p = 1 count
    p4 = RESIDENT_P4
    cfg_f = dataclasses.replace(cfg, aggregate_backend="pallas_fused")
    p4_stats = {}
    for key, dp in (("pallas_fused_p4", False),
                    ("pallas_fused_p4_resident", True)):
        tr = SyncGNNTrainer(graph, cfg_f, num_devices=p4,
                            algorithm="distdgl", seed=SEED, device="cuda",
                            params=params0, data_parallel=dp)
        groups4 = list(sched.iterations(
            tr.epoch_schedule()))[:RESIDENT_P4_ITERATIONS]
        runs[key] = run_path(f"graphsage/pallas_fused/p{p4}"
                             + ("/resident" if dp else ""), tr, groups4,
                             {k: p4 * v for k, v in fused_counts.items()},
                             agg)
        p4_stats[key] = [dataclasses.astuple(st) for st in tr.store.stats]
        if dp:
            resident[key] = tr.store
        del tr
    check_resident(f"graphsage/pallas_fused/p{p4}/resident",
                   runs["pallas_fused_p4_resident"], runs["pallas_fused_p4"])
    store4 = resident["pallas_fused_p4_resident"]
    shipped = sum(m["miss_rows"]
                  for m in runs["pallas_fused_p4_resident"]["steps"])
    if p4_stats["pallas_fused_p4_resident"] != p4_stats["pallas_fused_p4"]:
        fail(f"p{p4}: resident accounting {p4_stats} differs from the "
             f"host gather's")
    if not shipped or not store4.beta() < 1.0:
        fail(f"p{p4}: the resident run shipped {shipped} miss rows at beta "
             f"{store4.beta()}")
    print(f"graphsage/pallas_fused/p{p4}/resident: {shipped} miss rows "
          f"shipped, beta {store4.beta()!r}, accounting (local/host rows "
          f"and bytes per device) equal to the host gather's", flush=True)
    for dev in range(p4):
        check_assembly(f"paper_batch_p{p4}", assemble_device_feats,
                       resident_payload, store4, graph.features, mb, dev)
    blockcsr_tr = SyncGNNTrainer(
        graph, dataclasses.replace(cfg, aggregate_backend="pallas"),
        num_devices=1, algorithm="distdgl", seed=SEED, device="cuda",
        params=params0)
    runs["pallas"] = run_path(
        "graphsage/pallas", blockcsr_tr, groups[:BLOCKCSR_ITERATIONS],
        {**none, "aggregate_blockcsr": 3}, agg)
    check_first_loss("graphsage/pallas", runs["pallas"], ref_loss)
    del blockcsr_tr
    run_resident("pallas", "graphsage/pallas", BLOCKCSR_ITERATIONS,
                 {**none, "aggregate_blockcsr": 3})
    memory = {be: {"peak_bytes": runs[be]["peak_bytes"] if be in runs
                   else peaks[be]}
              | {key: runs[be][key] if be in runs else 0
                 for key in ("aggregate_intermediate_bytes",
                             "densified_hbm_bytes")}
              for be in ("reference", "pallas", "pallas_edges",
                         "pallas_fused")}
    print("peak_memory " + json.dumps(memory), flush=True)
    print("peak_memory_resident " + json.dumps({
        key: {"peak_bytes": runs[key]["peak_bytes"],
              "host_gather_peak_bytes":
                  runs[key.replace("_resident", "")]["peak_bytes"],
              "shard_bytes": st.p * st.shard_rows() * st.shard_width() * 4}
        for key, st in resident.items()}),
        flush=True)
    del resident, store4

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

    # 5. the host runtime: pipelined and pooled epochs against their twins
    del merged_tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs.update(host_runtime(
        SyncGNNTrainer, graph, cfg, params0,
        {"pallas_edges": {**none, "aggregate_edges": 3},
         "pallas_fused": fused_counts}, agg, flatten, layer_capacities,
        PayloadCodec, block_capacities, NeighborSampler,
        build_layer_layouts))
    print(f"host runtime phase: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 6. the kernel entry points, on the layer-1 operands
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

    # 7. the LM zoo's kernels vs plain, at the models' shapes
    del seg1, cols1, blocks1, x1, got, want, fused_plain, h1, w1, b0, b1
    torch.cuda.empty_cache()
    bf16, f32 = torch.bfloat16, torch.float32
    rows["flash_attention_fwd"] = [
        check_flash_launch("llama3_8b_prefill", fa, LM_BATCH, LM_PROMPT,
                           LM_PROMPT, 32, 8, 128, bf16, True, True),
        check_flash_launch("fp32_causal", fa, 1, 1024, 1024, 32, 8, 128,
                           f32, True, False),
        check_flash_launch("noncausal_ragged", fa, 2, 1000, 1537, 8, 2, 128,
                           bf16, False, False)]
    rows["wkv6_chunk"] = [
        check_wkv6_launch("rwkv6_3b_prefill", wk, LM_BATCH, LM_PROMPT, 40, 64,
                          bf16, False, True, usage["wkv6_chunk"]),
        check_wkv6_launch("fp32", wk, 1, 512, 40, 64, f32, False, False,
                          usage["wkv6_chunk"]),
        check_wkv6_launch("ragged_with_state", wk, 2, 1007, 40, 64, bf16,
                          True, False, usage["wkv6_chunk"])]

    # 8. serving at the published widths and depths
    for arch in LM_ARCHS:
        runs[arch] = serve(arch)

    # 9. prefill/decode consistency in fp32 (TF32 is off since the start)
    for arch in LM_ARCHS:
        consistency(arch)

    # 10. summary
    kernels = [kernel_entry(name, rows[name], {
        path: run["launches"].get(name, 0) for path, run in runs.items()})
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

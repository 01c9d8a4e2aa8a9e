"""Multi-process sampling service over a shared-memory graph store (copy
of ``repro.core.sampler_pool``; the one departure: the partitions' train
ids reach the workers through a shared-memory segment rather than in the
spawn arguments, so the workers start in parallel).

HitGNN's software generator (paper §4.2) runs the ENTIRE data-preparation
path — mini-batch sampling AND feature gathering — on the host CPU and must
keep p accelerators fed (Eq. 5). One Python thread cannot: once the compact
stage-2 path made device prep cheap, the single-threaded host stages became
the pipeline's rate limiter. This module scales those stages the way
DistDGL-style deployments do — N data-preparation worker PROCESSES over one
shared in-memory store:

  * the parent copies the graph ONCE into ``multiprocessing.shared_memory``
    segments (``data/graphs.Graph.to_shared``); each worker attaches
    zero-copy views (``Graph.from_shared``) — no per-worker topology or
    feature replication, O(graph) total host memory regardless of N;
  * each worker runs the vectorized layered sampler AND the compact
    stage-2b block-CSR layout build (``kernels/layout.build_layer_layouts``)
    AND — when a residency core is provided — the stage-2 FEATURE GATHER
    (``core/residency.ResidencyCore.select_ship_rows``): only the rows
    non-resident on the batch's target device are read out of the shared
    feature matrix and shipped, so ring traffic matches the paper's cached
    gather (resident rows are device-HBM reads the trainer materializes at
    placement). All of it is pure numpy — workers never import torch;
  * tasks are ``(seq, partition, epoch, batch_index, device, generation)``
    tuples. Batches are pure functions of the RNG coordinates (the
    sampler's counter-based streams), so ANY worker may execute ANY task
    and the result is bit-identical to the single-process path; ``device``
    only selects WHICH rows ship (the row values are device-independent)
    and ``generation`` names the feature-cache contents the hit/miss split
    is evaluated against (workers spin on
    ``ResidencyCore.wait_generation`` until the trainer's refresh lands —
    the generation handshake that keeps a mutable cache deterministic);
  * completions flow through a sequence-numbered
    :class:`~repro_torch.core.pipeline.ReorderBuffer`, so the consumer sees
    batches in exact submission order no matter which worker finished first.

Results come back through a shared-memory RING, not the pickle queue: every
payload of a fixed sampler config has STATIC shapes (the padded batch and
layout capacities), so a :class:`PayloadCodec` packs
each batch into a fixed-size slot of a preallocated segment and the result
queue carries only ``(seq, slot, meta)`` — the consumer pays ONE memcpy per
batch instead of pickling ~1 MB of arrays through a pipe. The gathered
feature rows ride a capacity-bounded VARIABLE-LENGTH tail of the slot (static
max per config, actual row count in the header), and the consumer copies
only the bytes actually used.

Worker placement: with ``worker_affinity`` the workers are pinned round-robin
over the parent's allowed cores via ``os.sched_setaffinity`` (Linux; a
silent no-op elsewhere), so N gather streams do not migrate across NUMA
domains mid-epoch.

Failure model (the supervisor): tasks are pure functions of their RNG
coordinates, so the pool treats every worker as DISPOSABLE. The consumer
side keeps an in-flight table keyed by sequence number; a worker that dies
(crash, OOM kill, segfault) is detected within one poll interval, its ring
slots are reclaimed through a lease array (each worker stamps the slot it
holds, so the supervisor knows exactly which slots died with it), a
replacement process is spawned against the SAME shared segments (graph,
residency, ring — nothing is re-copied), and every in-flight task is
resubmitted: the counter-based RNG makes the re-executed payloads
bit-identical, so recovery is invisible to training. Stragglers get
speculative duplicates (``straggler_timeout_s``) whose losers the in-flight
table drops; per-slot CRC32 turns silent payload corruption into a detected
decode failure that retries instead of training on garbage; worker-reported
errors retry a bounded number of times (transient faults heal, deterministic
bugs still surface at ``fetch()`` with the worker's formatted traceback
attached — ``add_note`` on py311+, ``sampler_worker_traceback`` otherwise).
After ``max_respawns`` process deaths the pool DEGRADES to in-process
execution of the remaining tasks (the ``workers=0`` twin): training finishes
slower instead of dying. ``core/faults.py`` injects each of these fault
classes on demand.

The pool is a context manager; shared segments — graph, ring, and
residency — are closed AND unlinked on every exit path, including error
paths and KeyboardInterrupt.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
import zlib
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core.faults import (FaultInjector, FaultSpec,
                                     resolve_fault_spec)
from repro_torch.core.pipeline import ReorderBuffer
from repro_torch.core.residency import ResidencyCore, SharedResidency
from repro_torch.core.sampler import (MiniBatch, NeighborSampler,
                                      layer_capacities, pad_minibatch)
from repro_torch.data.graphs import (Graph, SharedGraphSpec, attach_arrays,
                                     share_arrays)
from repro_torch.kernels.layout import (BLK, EDGE_STREAM_BACKENDS,
                                        build_layer_layouts)

# (partition, epoch, batch_index[, device[, generation[, targets]]]) —
# device defaults to the partition; generation is the cache generation the
# batch must be gathered against (0 = the immutable static residency);
# targets (serving path) is an explicit target-id array that replaces the
# epoch permutation's slice, with (epoch, index) still the RNG coordinates
Task = Union[Tuple[int, int, int], Tuple[int, int, int, int],
             Tuple[int, int, int, int, int],
             Tuple[int, int, int, int, int, Optional[np.ndarray]]]

# bytes reserved at the head of every ring slot for [crc32, used_bytes]
# (two uint32 — already 8-byte aligned, so the payload entries follow
# without extra padding)
CRC_HEADER = 8


class RingCorruptionError(RuntimeError):
    """A ring slot failed its integrity check on decode (CRC mismatch or an
    impossible geometry header). The supervisor treats it like a transient
    worker fault: recycle the slot and re-execute the task — never hand
    silently-corrupted arrays (= silently wrong gradients) to training."""


class GenerationStallError(RuntimeError):
    """A worker timed out waiting for a task's stamped cache generation.

    Not the task's fault: after a recovery resubmission, tasks stamped with
    the NEXT generation can sit AHEAD of the resubmitted task in the FIFO
    task queue — but the trainer publishes that generation only after the
    resubmitted task's iteration assembles. A single worker would deadlock;
    instead it bounds the wait, reports this error, and the supervisor
    requeues the stalled task WITHOUT charging a retry attempt (the requeue
    lands behind the pending older-generation work, so the queue drains
    front-first and the publish eventually happens). The fetch deadline
    still bounds total progress, so a generation that never publishes — a
    real bug — surfaces as a TimeoutError rather than an infinite loop."""


@dataclass(frozen=True)
class FeatureShipSpec:
    """Geometry of the gathered-rows segment of a ring slot.

    ``rows_cap`` bounds how many feature rows one payload may ship — the
    worst case (every valid layer-0 row a miss) is the layer-0 node
    capacity, but real miss distributions run far below it, so the
    ``GNNModelConfig.ship_rows_cap`` knob (see
    :func:`suggest_ship_rows_cap`) sizes the segment from measurement and
    shrinks the shm footprint per slot several-fold; ``width`` is the
    feature dimension; ``p3_full`` selects the P3 all-to-all path (ship
    the reconstructed full rows for every valid position instead of the
    miss rows)."""

    rows_cap: int
    width: int
    p3_full: bool = False


def suggest_ship_rows_cap(miss_row_counts: Sequence[int],
                          percentile: float = 99.0,
                          margin: float = 1.1) -> int:
    """Ring-slot rows capacity from a MEASURED miss-row distribution.

    Takes per-payload shipped-row counts (e.g. collected over a calibration
    epoch), returns ``ceil(percentile(counts) * margin)`` — a cap that
    admits the observed distribution with headroom instead of reserving the
    worst-case layer-0 node capacity per slot. A later batch shipping more
    rows fails loudly in ``PayloadCodec.encode`` naming the knob."""
    counts = np.asarray(list(miss_row_counts), np.int64)
    if counts.size == 0:
        raise ValueError("need at least one measured miss-row count")
    if counts.min() < 0:
        raise ValueError("miss-row counts must be >= 0")
    return max(1, int(np.ceil(float(np.percentile(counts, percentile))
                              * margin)))


class PayloadCodec:
    """Fixed layout of one sampled payload (MiniBatch + optional stage-2b
    block-CSR arrays + optional gathered feature rows) inside a
    shared-memory ring slot.

    Every array of a fixed sampler config has a static padded shape, so the
    byte layout is a pure function of ``(cfg, blk_caps, feat_spec)`` —
    parent and workers construct identical codecs independently. Offsets
    are 8-byte aligned; ``decode`` copies the USED bytes of the slot ONCE
    into private memory and hands out zero-copy views over that copy, so
    the slot recycles immediately.

    The feature segment is the one variable-length part: ``feat_count``
    (header) says how many of the ``rows_cap`` row slots are real, and the
    rows block sits LAST in the slot so the consumer's memcpy stops after
    the last real row instead of paying for the full capacity."""

    def __init__(self, cfg: GNNModelConfig, blk_caps: Optional[list],
                 feat_spec: Optional[FeatureShipSpec] = None):
        n_caps, e_caps = layer_capacities(cfg)
        L = cfg.num_layers
        # slot integrity header FIRST: crc32 over every used byte after it
        # + the used-byte count, stamped by encode, verified by decode
        spec: List[Tuple[str, int, tuple, np.dtype]] = [
            ("slot_crc", -1, (2,), np.dtype(np.uint32))]
        for l, n in enumerate(n_caps):
            spec.append(("nodes", l, (n,), np.dtype(np.int32)))
            spec.append(("node_mask", l, (n,), np.dtype(bool)))
        for l, e in enumerate(e_caps):
            spec.append(("edge_src", l, (e,), np.dtype(np.int32)))
            spec.append(("edge_dst", l, (e,), np.dtype(np.int32)))
            spec.append(("edge_mask", l, (e,), np.dtype(bool)))
        for l in range(L):
            spec.append(("self_idx", l, (n_caps[l + 1],), np.dtype(np.int32)))
        spec.append(("targets", -1, (cfg.batch_targets,), np.dtype(np.int32)))
        spec.append(("labels", -1, (cfg.batch_targets,), np.dtype(np.int32)))
        self.has_layout = blk_caps is not None
        # the edge-streaming backend reuses the ring's per-edge fields but
        # swaps tile_id/tile_id_t (which its kernel never reads — the
        # CSR-style segment offsets replace them) for the independently
        # sorted transpose values + the two offsets arrays
        self.edge_stream = (blk_caps is not None
                            and cfg.aggregate_backend
                            in EDGE_STREAM_BACKENDS)
        if blk_caps is not None:
            for l, (n_src, n_dst, max_blk, max_blk_t, e_cap) in \
                    enumerate(blk_caps):
                n_srcb = (n_src + BLK - 1) // BLK
                n_dstb = (n_dst + BLK - 1) // BLK
                if not self.edge_stream:
                    spec.append(("agg_tile_id", l, (e_cap,),
                                 np.dtype(np.int32)))
                spec.append(("agg_tile_off", l, (e_cap,), np.dtype(np.int32)))
                spec.append(("agg_val", l, (e_cap,), np.dtype(np.float32)))
                spec.append(("agg_cols", l, (n_dstb, max_blk),
                             np.dtype(np.int32)))
                if not self.edge_stream:
                    spec.append(("agg_tile_id_t", l, (e_cap,),
                                 np.dtype(np.int32)))
                spec.append(("agg_tile_off_t", l, (e_cap,),
                             np.dtype(np.int32)))
                spec.append(("agg_cols_t", l, (n_srcb, max_blk_t),
                             np.dtype(np.int32)))
                if self.edge_stream:
                    spec.append(("agg_val_t", l, (e_cap,),
                                 np.dtype(np.float32)))
                    spec.append(("agg_tile_seg", l,
                                 (n_dstb * max_blk + 1,),
                                 np.dtype(np.int32)))
                    spec.append(("agg_tile_seg_t", l,
                                 (n_srcb * max_blk_t + 1,),
                                 np.dtype(np.int32)))
        self.feat = feat_spec
        if feat_spec is not None:
            spec.append(("feat_count", -1, (1,), np.dtype(np.int32)))
            spec.append(("feat_pos", -1, (feat_spec.rows_cap,),
                         np.dtype(np.int32)))
        self.entries = []
        off = 0
        for key, l, shape, dtype in spec:
            self.entries.append((key, l, shape, dtype, off))
            size = int(np.prod(shape)) * dtype.itemsize
            off += (size + 7) & ~7  # keep every entry 8-byte aligned
        self.fixed_nbytes = off
        self.feat_rows_off = off
        self.row_nbytes = 0
        if feat_spec is not None:
            self.row_nbytes = feat_spec.width * 4
            off += feat_spec.rows_cap * self.row_nbytes
        self.nbytes = off
        self.num_layers = L

    def used_nbytes(self, feat_count: int) -> int:
        """Bytes of a slot actually carrying payload: the fixed part plus
        the shipped feature rows — what one batch really moves through the
        ring (and what the consumer memcpys out of it)."""
        if self.feat is None:
            return self.fixed_nbytes
        return self.feat_rows_off + feat_count * self.row_nbytes

    def encode(self, mb: MiniBatch, layout: Optional[dict],
               feats: Optional[Tuple[np.ndarray, np.ndarray]],
               buf, base: int, inject: Optional[str] = None) -> None:
        """Pack one payload into the slot at ``base`` and stamp its CRC.
        ``inject`` hooks the fault harness (core/faults.py):
        ``"encode_overflow"`` raises the capacity error regardless of the
        real row count; ``"corrupt_slot"`` flips payload bytes AFTER the
        CRC stamp, so the consumer's decode must catch it."""
        m = 0
        if inject == "encode_overflow":
            cap = self.feat.rows_cap if self.feat is not None else 0
            raise ValueError(
                f"feature ring capacity overflow (injected fault): batch "
                f"ships more rows than rows_cap={cap}")
        if self.feat is not None:
            pos, rows = feats if feats is not None else (
                np.empty(0, np.int32), np.empty((0, self.feat.width),
                                                np.float32))
            m = len(pos)
            if m > self.feat.rows_cap:
                raise ValueError(
                    f"feature ring capacity overflow: batch ships {m} rows "
                    f"but the slot holds rows_cap={self.feat.rows_cap}; "
                    f"set GNNModelConfig.ship_rows_cap explicitly (it "
                    f"overrides the measured default), or disable the "
                    f"measured sizing with CacheConfig."
                    f"auto_ship_rows_cap=False to fall back to the "
                    f"worst-case layer-0 node cap")
        for key, l, shape, dtype, off in self.entries:
            if key == "slot_crc":
                continue
            if key == "feat_count":
                arr = np.array([m], np.int32)
            elif key == "feat_pos":
                np.ndarray((m,), np.int32, buffer=buf,
                           offset=base + off)[...] = pos
                continue
            elif key.startswith("agg_"):
                arr = layout[key][l]
            elif l < 0:
                arr = getattr(mb, key)
            else:
                arr = getattr(mb, key)[l]
            np.ndarray(shape, dtype, buffer=buf,
                       offset=base + off)[...] = arr
        if self.feat is not None and m:
            np.ndarray((m, self.feat.width), np.float32, buffer=buf,
                       offset=base + self.feat_rows_off)[...] = rows
        used = self.used_nbytes(m)
        view = np.ndarray((used,), np.uint8, buffer=buf, offset=base)
        hdr = np.ndarray((2,), np.uint32, buffer=buf, offset=base)
        hdr[0] = zlib.crc32(view[CRC_HEADER:])
        hdr[1] = used & 0xFFFFFFFF
        if inject == "corrupt_slot":
            # flip a byte run PAST the header: the CRC no longer matches
            # the payload, exactly what a torn write / bad DMA looks like
            view[CRC_HEADER:CRC_HEADER + 16] ^= 0xFF

    def decode(self, buf, base: int, partition_id: int, seq_no: int
               ) -> Tuple[MiniBatch, Optional[dict], Optional[dict], int]:
        """One memcpy of the USED slot bytes -> (minibatch, layout, feats,
        used_bytes). ``feats`` is ``{"pos", "rows"}`` views over the private
        copy (or None when the codec ships no features). The slot's CRC is
        verified over that private copy (so a concurrent slot reuse cannot
        race the check); any mismatch — or a geometry header no valid
        encode could have produced — raises :class:`RingCorruptionError`
        and the supervisor re-executes the task."""
        m = 0
        if self.feat is not None:
            count_off = next(off for key, _, _, _, off in self.entries
                             if key == "feat_count")
            m = int(np.ndarray((1,), np.int32, buffer=buf,
                               offset=base + count_off)[0])
            if not 0 <= m <= self.feat.rows_cap:
                raise RingCorruptionError(
                    f"ring slot geometry corrupted: feat_count {m} outside "
                    f"[0, rows_cap={self.feat.rows_cap}]")
        used = self.used_nbytes(m)
        private = np.empty(used, np.uint8)
        private[:] = np.ndarray((used,), np.uint8, buffer=buf, offset=base)
        hdr = private[:CRC_HEADER].view(np.uint32)
        if int(hdr[1]) != used & 0xFFFFFFFF:
            raise RingCorruptionError(
                f"ring slot geometry corrupted: header says "
                f"{int(hdr[1])} used bytes, decode derives {used}")
        crc = zlib.crc32(private[CRC_HEADER:])
        if int(hdr[0]) != crc:
            raise RingCorruptionError(
                f"ring slot CRC mismatch: stored {int(hdr[0]):#010x}, "
                f"computed {crc:#010x} over {used} bytes")
        fields: dict = {k: [None] * self.num_layers
                        for k in ("nodes", "node_mask", "edge_src",
                                  "edge_dst", "edge_mask", "self_idx")}
        fields["nodes"].append(None)
        fields["node_mask"].append(None)
        layout: Optional[dict] = None
        if self.has_layout:
            if self.edge_stream:
                keys = ["agg_tile_off", "agg_val", "agg_cols",
                        "agg_tile_off_t", "agg_cols_t", "agg_val_t",
                        "agg_tile_seg", "agg_tile_seg_t"]
            else:
                keys = ["agg_tile_id", "agg_tile_off", "agg_val",
                        "agg_cols", "agg_tile_id_t", "agg_tile_off_t",
                        "agg_cols_t"]
            layout = {k: [None] * self.num_layers for k in keys}
        scalars = {}
        feats: Optional[dict] = None
        for key, l, shape, dtype, off in self.entries:
            if key in ("slot_crc", "feat_count"):
                continue
            if key == "feat_pos":
                pos = private[off:off + m * 4].view(np.int32)
                rows = private[self.feat_rows_off:
                               self.feat_rows_off + m * self.row_nbytes
                               ].view(np.float32).reshape(m, self.feat.width)
                feats = {"pos": pos, "rows": rows}
                continue
            size = int(np.prod(shape)) * dtype.itemsize
            arr = private[off:off + size].view(dtype).reshape(shape)
            if key.startswith("agg_"):
                layout[key][l] = arr
            elif l < 0:
                scalars[key] = arr
            else:
                fields[key][l] = arr
        mb = MiniBatch(fields["nodes"], fields["node_mask"],
                       fields["edge_src"], fields["edge_dst"],
                       fields["edge_mask"], fields["self_idx"],
                       scalars["targets"], scalars["labels"],
                       partition_id, seq_no)
        return mb, layout, feats, used


def _picklable_exc(e: BaseException) -> BaseException:
    """The original exception object when it survives pickling, else a
    RuntimeError carrying its repr (mp.Queue pickles in a feeder thread,
    where a failure would vanish and hang the consumer)."""
    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def _pin_worker(worker_id: int, cores: Optional[Sequence[int]]) -> None:
    """Round-robin CPU pinning for sampler workers (``worker_affinity``).

    Pins worker w to core ``cores[w % len(cores)]`` of the parent's allowed
    set, so N gather streams stay put instead of migrating across cores/NUMA
    domains mid-epoch. ``sched_setaffinity`` is Linux-only; everywhere else
    (and on any OS error) this is a silent no-op — placement is a
    performance knob, never a correctness one."""
    if not cores or not hasattr(os, "sched_setaffinity"):
        return
    try:
        os.sched_setaffinity(0, {cores[worker_id % len(cores)]})
    except OSError:
        pass


def _worker_main(worker_id: int, spec: SharedGraphSpec, cfg: GNNModelConfig,
                 train_ids_spec: dict, seed: int,
                 agg_kind: Optional[str], blk_caps: Optional[list],
                 res_spec: Optional[object],
                 feat_spec: Optional[FeatureShipSpec],
                 affinity_cores: Optional[Sequence[int]],
                 ring_name: str, num_slots: int,
                 fault_spec: Optional[FaultSpec],
                 fault_latch_dir: Optional[str],
                 task_q: Any, free_q: Any, result_q: Any) -> None:
    """Worker loop: attach the shared graph + residency + result ring, serve
    tasks until the ``None`` sentinel. Imports only numpy-side modules
    (sampler + layout builders + residency core) — never torch.

    Respawn-compatible by construction: everything the loop touches lives
    in the named shared segments, so a replacement worker started with the
    SAME arguments attaches the same state and serves the same task queue —
    the supervisor's recovery path. The lease array (tail of the ring
    segment) records which worker holds each slot between ``free_q.get``
    and the consumer's recycle, so the supervisor can reclaim the slots a
    dead worker took with it."""
    _pin_worker(worker_id, affinity_cores)
    graph = Graph.from_shared(spec)
    # the partitions' train ids, zero-copy views of the pool's segment
    # (kept referenced by the samplers for the worker's life)
    ids_handles, ids = attach_arrays(train_ids_spec)
    off = ids["offsets"]
    train_ids = [ids["ids"][off[p]:off[p + 1]] for p in range(len(off) - 1)]
    residency = (ResidencyCore.from_shared(res_spec)
                 if res_spec is not None else None)
    codec = PayloadCodec(cfg, blk_caps, feat_spec)
    ring = shared_memory.SharedMemory(name=ring_name)
    lease = np.ndarray((num_slots,), np.int32, buffer=ring.buf,
                       offset=num_slots * codec.nbytes)
    injector = (FaultInjector(fault_spec, fault_latch_dir)
                if fault_spec is not None and fault_latch_dir is not None
                else None)
    samplers = [NeighborSampler(graph, cfg, ids, p, seed)
                for p, ids in enumerate(train_ids)]
    try:
        while True:
            task = task_q.get()
            if task is None:
                return
            seq, part, epoch, index, device, gen, targets = task
            try:
                inject = None
                if injector is not None:
                    tid = (part, epoch, index)
                    if injector.fire("kill", tid) is not None:
                        # simulate SIGKILL/OOM: no cleanup, no report — the
                        # supervisor must detect, respawn and resubmit
                        os._exit(137)
                    hang = injector.fire("hang", tid)
                    if hang is not None:
                        time.sleep(hang.hang_s)
                    if injector.fire("encode_overflow", tid) is not None:
                        inject = "encode_overflow"
                    elif injector.fire("corrupt_slot", tid) is not None:
                        inject = "corrupt_slot"
                if targets is None:
                    mb = samplers[part].batch_at(epoch, index)
                else:
                    # serving path: bucket-shaped explicit-target batch,
                    # zero-padded up to the ring codec's single geometry
                    # (the consumer slices the prefix back down)
                    mb = pad_minibatch(
                        samplers[part].request_batch(epoch, index, targets),
                        *layer_capacities(cfg))
                layout = None
                if blk_caps is not None:
                    layout = build_layer_layouts(
                        mb.edge_src, mb.edge_dst, mb.edge_mask, blk_caps,
                        agg_kind,
                        edge_stream=(cfg.aggregate_backend
                                     in EDGE_STREAM_BACKENDS))
                feats = None
                if residency is not None:
                    # generation handshake: the task names the cache
                    # contents its hit/miss split must be evaluated
                    # against. The trainer publishes generations in
                    # iteration order and never overwrites one a stamped
                    # task still needs, so a stale view here just means
                    # the refresh has not landed yet — spin until it does
                    if gen != residency.generation:
                        try:
                            residency.wait_generation(gen, timeout=2.0)
                        except TimeoutError as e:
                            raise GenerationStallError(str(e)) from None
                    # stage 2 in the worker: gather only what must cross
                    # the bus to `device` (all valid rows for P3 all-to-all)
                    feats = residency.select_ship_rows(
                        device, graph.features, mb.nodes[0], mb.node_mask[0],
                        p3_full=feat_spec.p3_full)
                # acquire a ring slot only once the batch is ready: a worker
                # never sits on a slot while it computes. The lease stamp
                # (this worker's id) is what lets the supervisor reclaim
                # the slot if this process dies before the consumer
                # recycles it.
                slot = free_q.get()
                lease[slot] = worker_id
                try:
                    codec.encode(mb, layout, feats, ring.buf,
                                 slot * codec.nbytes, inject=inject)
                except BaseException:
                    # the consumer will never see this slot — recycle it
                    # here or every encode failure (e.g. feature-capacity
                    # overflow) leaks one slot until the pool wedges
                    lease[slot] = -1
                    free_q.put(slot)
                    raise
                result_q.put((seq, "ok",
                              (slot, part, index, device,
                               mb.work_estimate())))
            except BaseException as e:  # surfaced at the consumer's fetch()
                result_q.put((seq, "error",
                              (_picklable_exc(e), traceback.format_exc())))
    finally:
        lease = None  # release the exported view before the mmap closes
        ring.close()


class _TaskRecord:
    """Supervisor bookkeeping for one submitted-but-undelivered task.

    ``dup_causes`` records WHY extra live copies of this task may exist —
    one entry per copy beyond the first: ``"speculative"`` for a straggler
    race, ``"resubmit"`` for a post-death blanket resubmission (which also
    re-enqueues tasks a LIVE worker still holds). When the winner delivers,
    the causes move to the pool's expected-duplicate table so each late
    copy is attributed to its cause exactly once — a resubmission overlap
    must never inflate the speculative-hit count."""

    __slots__ = ("task", "attempts", "submitted_at", "dup_causes")

    def __init__(self, task: tuple):
        self.task = task
        self.attempts = 1
        self.submitted_at = time.monotonic()
        self.dup_causes: List[str] = []


class SamplerPool:
    """N *supervised* data-preparation worker processes over one
    shared-memory store.

    ``submit(partition, epoch, index, device)`` enqueues a batch task and
    returns its sequence number; ``fetch()`` returns payloads in exact
    submission order (reorder buffer). A payload is a dict with keys
    ``minibatch`` (the :class:`MiniBatch`), ``layout`` (the stage-2b
    compact block-CSR arrays, or None when no capacities were given),
    ``features`` (``{"pos", "rows", "device"}`` worker-gathered rows, or
    None when no residency core was given), ``ring_bytes`` (bytes this
    payload moved through the ring) and ``load`` (the raw Eq. 5 work
    estimate).

    The supervisor runs inside ``fetch``'s poll loop (no extra thread): it
    keeps every submitted task in an in-flight table until its payload is
    delivered, detects dead workers within one poll interval, reclaims their
    leased ring slots, respawns them against the existing shared segments
    (exponential backoff, at most ``max_respawns`` lifetime respawns before
    the pool degrades to in-process execution), resubmits in-flight tasks
    after a death, speculatively re-executes the head-of-line task when it
    exceeds ``straggler_timeout_s``, and retries worker-reported errors and
    CRC-failed slots up to ``max_task_retries`` executions. ``stats``
    counts every recovery action; ``degraded`` reports whether the pool has
    fallen back to in-process sampling.

    Use as a context manager — or call :meth:`close` — to tear down worker
    processes and release/unlink the shared-memory segments. ``close`` is
    idempotent and runs on error paths and KeyboardInterrupt alike.
    """

    def __init__(self, graph: Graph, cfg: GNNModelConfig,
                 train_ids_per_partition: Sequence[np.ndarray],
                 seed: int = 0, num_workers: int = 2,
                 agg_kind: Optional[str] = None,
                 blk_caps: Optional[list] = None,
                 residency: Optional[ResidencyCore] = None,
                 p3_full: bool = False,
                 feat_rows_cap: Optional[int] = None,
                 worker_affinity: bool = False,
                 num_slots: Optional[int] = None,
                 start_method: str = "spawn",
                 shared: Optional["object"] = None,
                 max_respawns: int = 2,
                 straggler_timeout_s: Optional[float] = None,
                 speculative: bool = True,
                 max_task_retries: int = 3,
                 fault_spec: Optional[Union[str, FaultSpec]] = None):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers
        self._closed = False
        self._ring: Optional[shared_memory.SharedMemory] = None
        self._shared_res: Optional[SharedResidency] = None
        self._lease: Optional[np.ndarray] = None
        self._latch_dir: Optional[str] = None
        self._procs: List[Any] = []
        # `shared` lets several pools over the SAME graph reuse one set of
        # segments (O(graph) shm total, not O(pools)); the caller then owns
        # its lifetime and this pool never unlinks it.
        self._owns_shared = shared is None
        self._shared = graph.to_shared() if shared is None else shared
        self.feat_spec: Optional[FeatureShipSpec] = None
        if residency is not None:
            cap = (feat_rows_cap if feat_rows_cap is not None
                   else layer_capacities(cfg)[0][0])
            self.feat_spec = FeatureShipSpec(cap, graph.features.shape[1],
                                             p3_full)
        self._codec = PayloadCodec(cfg, blk_caps, self.feat_spec)
        self.num_slots = (num_slots if num_slots is not None
                          else 2 * num_workers + 2)
        # construction state kept for respawns and the degraded fallback —
        # respawned workers get byte-identical arguments, so they attach
        # the same segments and serve the same queues
        self._graph = graph
        self._cfg = cfg
        self._ids = [np.asarray(t, np.int32) for t in train_ids_per_partition]
        self._ids_segments: list = []
        self._ids_spec: Optional[dict] = None
        self._seed = seed
        self._agg_kind = agg_kind
        self._blk_caps = blk_caps
        self._residency = residency
        self._fault_spec = resolve_fault_spec(fault_spec)
        self.max_respawns = max_respawns
        self.straggler_timeout_s = straggler_timeout_s
        self.speculative = speculative
        self.max_task_retries = max_task_retries
        self._ctx = mp.get_context(start_method)
        ctx = self._ctx
        # SimpleQueues, deliberately: mp.Queue hands every put to a feeder
        # THREAD that must win the producer's GIL to pickle — on a busy
        # host that adds ~ms latency per message and throttles the whole
        # service. SimpleQueue sends synchronously in the caller; all
        # messages here are tiny tuples (the payloads travel via the ring).
        self._task_q = ctx.SimpleQueue()
        self._free_q = ctx.SimpleQueue()
        self._result_q = ctx.SimpleQueue()
        self._rob = ReorderBuffer()
        self._seq = 0
        self._outstanding = 0
        self._inflight: dict[int, _TaskRecord] = {}
        self._degraded = False
        self._respawn_count = 0
        self._local_samplers: Optional[List[NeighborSampler]] = None
        self._last_supervise = 0.0
        self.stats = {"respawns": 0, "resubmissions": 0, "speculative": 0,
                      "duplicates_dropped": 0, "stale_results": 0,
                      "retried_errors": 0,
                      "crc_failures": 0, "degraded_tasks": 0,
                      "gen_stalls": 0, "recovery_s": 0.0}
        # seq -> ([remaining duplicate causes], registered_at): filled when
        # a task with extra live copies delivers, consumed as the losers
        # land, purged by _supervise if a loser died with its worker
        self._dup_expected: dict[int, Tuple[List[str], float]] = {}
        self._affinity_cores: Optional[List[int]] = None
        if worker_affinity and hasattr(os, "sched_getaffinity"):
            self._affinity_cores = sorted(os.sched_getaffinity(0))
        try:
            # the train ids travel to the workers through shared memory, not
            # in the spawn arguments: a start writes its arguments into a
            # pipe and, past the pipe's 64 KB, waits for the child to read
            # them, which serialises every worker's interpreter start-up
            self._ids_segments, self._ids_spec = share_arrays({
                "ids": np.concatenate(self._ids),
                "offsets": np.cumsum([0] + [len(t) for t in self._ids])})
            if residency is not None:
                self._shared_res = residency.to_shared()
            if self._fault_spec is not None:
                # latch files must outlive individual workers (one-shot
                # across respawns) — the POOL owns the directory
                self._latch_dir = tempfile.mkdtemp(prefix="hitgnn-faults-")
            # slot payloads first, then the int32 lease array (slot ->
            # worker id holding it, -1 = unleased) the supervisor reads to
            # reclaim a dead worker's slots
            self._ring = shared_memory.SharedMemory(
                create=True,
                size=max(1, self.num_slots * self._codec.nbytes
                         + 4 * self.num_slots))
            self._lease = np.ndarray((self.num_slots,), np.int32,
                                     buffer=self._ring.buf,
                                     offset=self.num_slots
                                     * self._codec.nbytes)
            self._lease[:] = -1
            for s in range(self.num_slots):
                self._free_q.put(s)
            self._procs = [
                ctx.Process(target=_worker_main, name=f"hitgnn-sampler-{w}",
                            args=self._worker_args(w), daemon=True)
                for w in range(num_workers)]
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def _worker_args(self, worker_id: int) -> tuple:
        """Identical argument tuple for a worker's first start and every
        respawn — the recovery path's whole contract."""
        res_spec = (self._shared_res.spec
                    if self._shared_res is not None else None)
        return (worker_id, self._shared.spec, self._cfg, self._ids_spec,
                self._seed, self._agg_kind, self._blk_caps, res_spec,
                self.feat_spec, self._affinity_cores, self._ring.name,
                self.num_slots, self._fault_spec, self._latch_dir,
                self._task_q, self._free_q, self._result_q)

    # -- task flow -----------------------------------------------------------
    @property
    def outstanding(self) -> int:
        """Tasks submitted but not yet returned by ``fetch``."""
        return self._outstanding

    def submit(self, partition: int, epoch: int, index: int,
               device: Optional[int] = None, generation: int = 0,
               targets: Optional[np.ndarray] = None) -> int:
        """Enqueue one batch task. ``device`` is the target device whose
        residency decides which feature rows ship (defaults to the
        partition, the scheduler's static stage-1 mapping); ``generation``
        is the cache generation the worker must gather against (0 = the
        residency as shared — the only generation an immutable core ever
        has). Both are ignored when the pool gathers no features.
        ``targets`` (serving path) replaces the epoch permutation's slice
        with explicit target ids — ``(epoch, index)`` stay the RNG
        coordinates, so resubmission/speculation re-execute bit-identically;
        the payload comes back padded to the codec geometry with the bucket
        prefix real."""
        if self._closed:
            raise RuntimeError("SamplerPool is closed")
        seq = self._seq
        self._seq += 1
        dev = partition if device is None else device
        task = (partition, epoch, index, dev, generation,
                None if targets is None else np.asarray(targets, np.int32))
        self._inflight[seq] = _TaskRecord(task)
        if not self._degraded:
            self._task_q.put((seq,) + task)
        self._outstanding += 1
        return seq

    @property
    def degraded(self) -> bool:
        """True once the pool has exhausted ``max_respawns`` and fallen
        back to executing tasks in-process."""
        return self._degraded

    def fetch(self, timeout: float = 60.0) -> dict:
        """Next payload in submission order; blocks until it arrives.

        One ABSOLUTE monotonic deadline (``now + timeout``) governs the
        whole call — every poll, result drain and supervision pass spends
        from the same budget, so a slow worker cannot stretch the wait past
        ``timeout`` by trickling results. Worker exceptions that exhaust
        their retry budget re-raise HERE with the worker traceback
        attached; deaths, stragglers and corrupted slots are recovered
        silently by the supervisor."""
        if self._outstanding <= 0:
            raise RuntimeError("fetch() with no outstanding tasks")
        deadline = time.monotonic() + timeout
        while True:
            item = self._rob.pop()
            if item is None and self._degraded:
                self._run_degraded_head()
                item = self._rob.pop()
            if item is not None:
                self._outstanding -= 1
                kind, payload = item
                if kind == "error":
                    exc, worker_tb = payload
                    note = "sampler worker traceback:\n" + worker_tb
                    if hasattr(exc, "add_note"):  # py311+
                        exc.add_note(note)
                    else:
                        exc.sampler_worker_traceback = worker_tb
                    raise exc
                return payload
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no sampler result within {timeout:.0f}s "
                    f"({self._outstanding} outstanding)")
            # SimpleQueue has no get(timeout); poll the read end so worker
            # death is still detected while blocked
            if self._result_q._reader.poll(min(0.2, remaining)):
                self._handle_result(self._result_q.get())
            if time.monotonic() - self._last_supervise >= 0.2:
                self._supervise()

    # -- supervisor ----------------------------------------------------------
    def _handle_result(self, msg: tuple) -> None:
        """Route one worker message: deliver, retry, or drop a duplicate."""
        seq, kind, payload = msg
        rec = self._inflight.get(seq)
        if rec is None:
            # already delivered — the payloads are bit-identical
            # (counter-based RNG), so just recycle the loser's slot and
            # attribute the duplicate to its cause: a lost speculative race
            # counts as a speculative hit (duplicates_dropped), a
            # post-death resubmission overlap is a stale result. Never
            # guess: an untracked duplicate is stale, so speculative hits
            # can never exceed speculative launches.
            if kind == "ok":
                self._recycle_slot(payload[0])
            causes, _ = self._dup_expected.get(seq, ([], 0.0))
            if "speculative" in causes:
                causes.remove("speculative")
                self.stats["duplicates_dropped"] += 1
            else:
                if causes:
                    causes.pop()
                self.stats["stale_results"] += 1
            if not causes:
                self._dup_expected.pop(seq, None)
            return
        if kind == "error":
            if isinstance(payload[0], GenerationStallError):
                # queue-order hazard, not a task failure (see the class
                # docstring): requeue without charging a retry attempt —
                # the fetch deadline bounds a never-publishing generation
                rec.submitted_at = time.monotonic()
                self.stats["gen_stalls"] += 1
                self.stats["resubmissions"] += 1
                if not self._degraded:
                    self._task_q.put((seq,) + rec.task)
                return
            self._retry_or_surface(seq, rec, payload, "retried_errors")
            return
        slot, part, index, device, load = payload
        try:
            mb, layout, feats, used = self._codec.decode(
                self._ring.buf, slot * self._codec.nbytes, part, index)
        except RingCorruptionError as e:
            # detected corruption = transient fault: recycle the slot and
            # re-execute rather than train on garbage
            self._recycle_slot(slot)
            self.stats["crc_failures"] += 1
            self._retry_or_surface(
                seq, rec, (e, traceback.format_exc()), "crc_failures")
            return
        # decode ON ARRIVAL (one memcpy out of the ring) and recycle the
        # slot immediately, so workers never starve for slots while the
        # consumer waits on an earlier sequence number
        self._recycle_slot(slot)
        if feats is not None:
            feats["device"] = device
        self._expect_duplicates(seq, rec)
        del self._inflight[seq]
        self._rob.put(seq, ("ok", {"minibatch": mb, "layout": layout,
                                   "features": feats, "ring_bytes": used,
                                   "load": load}))

    def _expect_duplicates(self, seq: int, rec: _TaskRecord) -> None:
        """On delivery, remember which extra copies of ``seq`` may still
        land (and why), so each late arrival is attributed once."""
        if rec.dup_causes:
            self._dup_expected[seq] = (rec.dup_causes, time.monotonic())

    def _recycle_slot(self, slot: int) -> None:
        if self._lease is not None:
            self._lease[slot] = -1
        self._free_q.put(slot)

    def _retry_or_surface(self, seq: int, rec: _TaskRecord,
                          err_payload: tuple, counter: str) -> None:
        """Resubmit a failed task while it has retry budget; surface the
        error through the reorder buffer once it runs out (a deterministic
        bug fails every attempt — it must reach the caller)."""
        if rec.attempts >= self.max_task_retries:
            self._expect_duplicates(seq, rec)
            del self._inflight[seq]
            self._rob.put(seq, ("error", err_payload))
            return
        rec.attempts += 1
        rec.submitted_at = time.monotonic()
        if counter != "crc_failures":  # crc counter already bumped
            self.stats[counter] += 1
        self.stats["resubmissions"] += 1
        if not self._degraded:
            self._task_q.put((seq,) + rec.task)

    def _supervise(self) -> None:
        """One supervision pass: detect/recover worker deaths, then watch
        the head-of-line task for straggling. Called from ``fetch``'s poll
        loop at most every 0.2 s."""
        self._last_supervise = time.monotonic()
        # expected duplicates whose copy died with its worker never arrive —
        # drop stale entries so the table stays bounded
        for seq in [s for s, (_, t) in self._dup_expected.items()
                    if self._last_supervise - t > 60.0]:
            del self._dup_expected[seq]
        if self._degraded or self._closed:
            return
        dead = [w for w, p in enumerate(self._procs)
                if p.exitcode is not None]
        if dead:
            t0 = time.perf_counter()
            # drain what the dead worker managed to report before its
            # death — those results are valid and must not be re-executed
            self._drain_results()
            for w in dead:
                self._procs[w].join()
                self._reclaim_slots(w)
            for w in dead:
                if self._respawn_count >= self.max_respawns:
                    self._enter_degraded()
                    break
                self._respawn(w)
            if not self._degraded:
                self._resubmit_inflight()
            self.stats["recovery_s"] += time.perf_counter() - t0
            return
        if not (self.speculative and self.straggler_timeout_s):
            return
        seq = self._rob.next_seq
        rec = self._inflight.get(seq)
        if rec is None:
            return
        overdue = time.monotonic() - rec.submitted_at
        if overdue >= self.straggler_timeout_s \
                and rec.attempts < self.max_task_retries:
            # the head task is what training blocks on — race a duplicate
            # on a healthy worker; ReorderBuffer drops whichever loses
            rec.attempts += 1
            rec.submitted_at = time.monotonic()
            rec.dup_causes.append("speculative")
            self.stats["speculative"] += 1
            self.stats["resubmissions"] += 1
            self._task_q.put((seq,) + rec.task)

    def _respawn(self, worker_id: int) -> None:
        """Start a replacement process against the SAME shared segments."""
        self._respawn_count += 1
        self.stats["respawns"] += 1
        # exponential backoff caps a crash-looping worker's churn
        time.sleep(min(0.05 * 2 ** (self._respawn_count - 1), 1.0))
        p = self._ctx.Process(target=_worker_main,
                              name=f"hitgnn-sampler-{worker_id}",
                              args=self._worker_args(worker_id), daemon=True)
        p.start()
        self._procs[worker_id] = p

    def _reclaim_slots(self, worker_id: int) -> None:
        """Free every ring slot the dead worker still leased — without this
        each death leaks a slot until the ring wedges."""
        if self._lease is None:
            return
        for slot in np.flatnonzero(self._lease[:] == worker_id):
            self._recycle_slot(int(slot))

    def _drain_results(self) -> None:
        while self._result_q._reader.poll(0):
            self._handle_result(self._result_q.get())

    def _resubmit_inflight(self) -> None:
        """Re-enqueue every undelivered task after a worker death. No
        attempts increment: a crash is not the task's fault, and the
        respawn budget already bounds crash loops. The sequence numbers are
        unchanged, so delivery order — and therefore training — is
        bit-identical to the fault-free run.

        Only ONE of the resubmitted tasks died with the worker; the rest
        are still queued or held by live workers, so each resubmission is a
        potential duplicate — recorded as a ``"resubmit"`` cause so its
        late copy lands in ``stale_results``, never in the speculative-hit
        count."""
        now = time.monotonic()
        for seq, rec in sorted(self._inflight.items()):
            rec.submitted_at = now
            rec.dup_causes.append("resubmit")
            self.stats["resubmissions"] += 1
            self._task_q.put((seq,) + rec.task)

    def _enter_degraded(self) -> None:
        """Respawn budget exhausted: stop every worker and finish the
        remaining tasks in-process — training completes slower instead of
        dying."""
        self._degraded = True
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=3.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=1.0)
        # late results that landed before the terminate are still valid
        self._drain_results()
        self._procs = []

    def _run_degraded_head(self) -> None:
        """Execute the head-of-line task in-process (degraded mode)."""
        seq = self._rob.next_seq
        rec = self._inflight.pop(seq, None)
        if rec is None:
            return
        try:
            payload = self._run_task_inprocess(rec.task)
        except BaseException as e:
            self._rob.put(seq, ("error", (e, traceback.format_exc())))
            return
        self.stats["degraded_tasks"] += 1
        self._rob.put(seq, ("ok", payload))

    def _run_task_inprocess(self, task: tuple) -> dict:
        """The workers=0 twin of ``_worker_main``'s task body, against the
        parent-held graph/residency (no ring, ring_bytes=0). Counter-based
        RNG makes the payload bit-identical to a worker's."""
        part, epoch, index, device, gen, targets = task
        if self._local_samplers is None:
            self._local_samplers = [
                NeighborSampler(self._graph, self._cfg, ids, p, self._seed)
                for p, ids in enumerate(self._ids)]
        if targets is None:
            mb = self._local_samplers[part].batch_at(epoch, index)
        else:
            mb = pad_minibatch(
                self._local_samplers[part].request_batch(epoch, index,
                                                         targets),
                *layer_capacities(self._cfg))
        layout = None
        if self._blk_caps is not None:
            layout = build_layer_layouts(
                mb.edge_src, mb.edge_dst, mb.edge_mask, self._blk_caps,
                self._agg_kind,
                edge_stream=(self._cfg.aggregate_backend
                             in EDGE_STREAM_BACKENDS))
        feats = None
        if self._residency is not None:
            if gen != self._residency.generation:
                self._residency.wait_generation(gen)
            pos, rows = self._residency.select_ship_rows(
                device, self._graph.features, mb.nodes[0], mb.node_mask[0],
                p3_full=self.feat_spec.p3_full)
            feats = {"pos": pos, "rows": rows, "device": device}
        return {"minibatch": mb, "layout": layout, "features": feats,
                "ring_bytes": 0, "load": mb.work_estimate()}

    def map_tasks(self, tasks: Iterable[Task],
                  window: Optional[int] = None,
                  fetch_timeout: float = 300.0) -> Iterator[dict]:
        """Run ``(partition, epoch, index[, device[, generation[,
        targets]]])`` tasks with a bounded
        submission window, yielding payloads in task order. The window
        (default ``4 * num_workers``) caps staged-but-unconsumed batches,
        bounding host memory exactly like the prefetch executor's queue
        depth. ``fetch_timeout`` bounds the wait for any single result —
        generous by default, because a single big-config batch on a loaded
        host can legitimately take minutes while every worker is healthy
        (dead workers are detected separately, within a poll interval)."""
        window = window if window is not None else 4 * self.num_workers
        it = iter(tasks)
        exhausted = False
        while True:
            while not exhausted and self._outstanding < window:
                try:
                    t = next(it)
                except StopIteration:
                    exhausted = True
                    break
                self.submit(*t)
            if exhausted and self._outstanding == 0:
                return
            yield self.fetch(timeout=fetch_timeout)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Idempotent teardown: stop workers, then close AND unlink the
        shared-memory segments (ring + residency + owned graph store). Safe
        on error paths — runs from ``__exit__`` for any exception type,
        including KeyboardInterrupt — and with workers mid-crash: every
        per-process step is individually guarded, so one dying worker (a
        broken queue pipe, an unjoinable zombie) cannot skip the segment
        unlinks that follow."""
        if self._closed:
            return
        self._closed = True
        procs = getattr(self, "_procs", [])
        for _ in procs:
            try:
                self._task_q.put(None)
            except Exception:
                break  # queue already broken — terminate below instead
        for p in procs:
            try:
                p.join(timeout=3.0)
            except Exception:
                pass  # e.g. never started
        for p in procs:
            try:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=3.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=1.0)
            except Exception:
                pass
        for q in (self._task_q, self._free_q, self._result_q):
            try:
                q.close()
            except Exception:
                pass
        # release the exported lease view BEFORE closing the ring — an
        # outstanding numpy view over the buffer makes mmap.close() raise
        self._lease = None
        if self._ring is not None:
            try:
                self._ring.close()
            except Exception:
                pass
            try:
                self._ring.unlink()
            except FileNotFoundError:
                pass
        if self._shared_res is not None:
            try:
                self._shared_res.close(unlink=True)
            except Exception:
                pass
        for shm in self._ids_segments:
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        if self._owns_shared:
            self._shared.close(unlink=True)
        if self._latch_dir is not None:
            shutil.rmtree(self._latch_dir, ignore_errors=True)

    def __enter__(self) -> "SamplerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

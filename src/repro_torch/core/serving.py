"""Request-driven serving runtime on the training substrate (counterpart of
``repro.core.serving``).

Target-node inference requests arrive one at a time, are coalesced into
micro-batches under a latency objective (SLO) and flow through the
scheduling core into the supervised ``SamplerPool``, the same host
machinery as epoch training: worker respawn, straggler speculation,
absolute fetch deadlines and fault injection carry over as they are.

* :func:`bucket_ladder`, :class:`ServeConfig`, :class:`MicroBatcher` and
  :func:`closed_loop_load` are the reference's policy, copied.
* :class:`BucketForward` is the counterpart of the reference's one
  ``jax.jit`` a bucket: the bucket's batch lives in static buffers at the
  bucket's capacities (one pinned host buffer, one device buffer, every
  array a view at a fixed offset), the host gather writes the feature rows
  straight into the pinned buffer, and one copy moves it to the card. On
  the card the forward is ONE CUDA graph a bucket, captured at the
  bucket's first request (``warmup`` makes that request for every bucket)
  and replayed after; on the CPU it is the eager forward over the same
  views.
* :class:`ServingRuntime` is the frontend: ``predict`` (one request = one
  micro-batch, the deterministic path) and ``submit`` (a Future, drained
  by a dispatcher thread through the coalescer).

The forward is ``gnn.models.forward`` over the batch the reference's
``batch_to_arrays`` builds, which carries no kernel layout: every model
takes its plain edge-list aggregation (on the card, segment sums by
``index_put_``), whatever ``aggregate_backend`` says, as in the reference.

RNG discipline (the reference's): each micro-batch is addressed
``(partition=0, SERVE_EPOCH, request_index, targets)``; ``SERVE_EPOCH``
lies far above any training epoch, and the request index grows by one a
micro-batch (warm-up batches included), so both packages sample the same
neighbourhoods request by request and a respawned or speculated worker
re-materializes the same batch.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition import get_partitioner
from repro_torch.core.sampler import (MiniBatch, NeighborSampler,
                                      layer_capacities_for, slice_minibatch)
from repro_torch.core.sampler_pool import SamplerPool
from repro_torch.core.scheduling import BatchTask, SchedulingCore
from repro_torch.core.staging import pack_offsets, typed_view
from repro_torch.core.trainer import ALGORITHMS
from repro_torch.data.graphs import Graph
from repro_torch.device import resolve_device
from repro_torch.gnn import models as gnn_models
from repro_torch.nn.param import flatten, params_from_numpy, unflatten

# RNG epoch coordinate reserved for serving streams — far above any
# realistic training epoch count, so (seed, partition, epoch, tag) streams
# of the two modes never collide
SERVE_EPOCH = 1 << 30

# eager runs of a bucket's forward on a side stream before its capture
# (cuBLAS handles and workspaces, the sort's scratch), as torch.cuda.graph
# asks
CAPTURE_WARMUP_RUNS = 3

# a bucket's per-request stages, in ms, that bucket_stats reports
STAGES = ("sample_ms", "gather_ms", "upload_ms", "forward_ms", "service_ms")

# device index -> the side stream every capture on that card runs on.
# cuBLAS keeps a 32 MiB workspace for each stream it has run on, for the
# life of the process, so a stream a runtime (or a capture) would leak one
# each time; one stream a card keeps one, however many runtimes come and
# go. Captures on it are serialised by _CAPTURE_LOCK (runtimes on other
# threads share it).
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}
_CAPTURE_LOCK = threading.Lock()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The process's one capture stream for ``device`` (made at first
    use)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return stream


def bucket_ladder(batch_targets: int,
                  buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The menu of micro-batch target counts, ascending.

    Explicit ``buckets`` are validated (deduplicated, sorted, each within
    ``1..batch_targets``); the default ladder grows geometrically (x4)
    from 8 and always tops out at ``batch_targets``, so a handful of
    captured forwards covers every request size up to the training batch
    shape."""
    if buckets is not None:
        out = sorted(set(int(b) for b in buckets))
        if not out:
            raise ValueError("bucket ladder must not be empty")
        if out[0] < 1 or out[-1] > batch_targets:
            raise ValueError(
                f"buckets must lie in 1..{batch_targets} (= batch_targets); "
                f"got {out}")
        return tuple(out)
    ladder = []
    b = min(8, batch_targets)
    while b < batch_targets:
        ladder.append(b)
        b *= 4
    ladder.append(batch_targets)
    return tuple(ladder)


@dataclass(frozen=True)
class ServeConfig:
    """Serving-frontend knobs (fault tolerance, speculation and fault
    injection ride on ``GNNModelConfig.fault``).

    * ``slo_ms`` — per-request latency objective; the coalescer budgets
      its waiting against it and misses are reported, never errored.
    * ``buckets`` — explicit bucket ladder (None = default, see
      :func:`bucket_ladder`).
    * ``num_workers`` — sampler-pool worker processes (0 = sample
      in-process; bit-identical either way).
    * ``fetch_timeout_s`` — absolute deadline for one micro-batch's
      payloads; a faulted pool recovers within it, so requests complete
      past SLO rather than erroring.
    * ``safety_frac`` — fraction of the SLO held back as slack when the
      coalescer decides how long waiting is still safe.
    """

    slo_ms: float = 50.0
    buckets: Optional[Tuple[int, ...]] = None
    num_workers: int = 0
    fetch_timeout_s: float = 30.0
    safety_frac: float = 0.1


class MicroBatcher:
    """SLO-deadline micro-batch coalescing — pure policy, no threads.

    Requests enter with an absolute deadline (arrival + SLO). The batcher
    flushes when (a) pending targets fill the largest bucket, or (b) the
    clock reaches :meth:`flush_at` — the point where waiting any longer
    would push the OLDEST request past its deadline, given the EWMA
    service-time estimate for the bucket the pending set would flush into
    plus a safety fraction of the SLO."""

    def __init__(self, buckets: Sequence[int], slo_s: float,
                 safety_frac: float = 0.1):
        self.buckets = tuple(sorted(buckets))
        self.slo_s = float(slo_s)
        self.safety_s = safety_frac * self.slo_s
        self._pending: List[Tuple[float, int, Any]] = []  # (deadline, n, it)
        self._est: Dict[int, float] = {b: 0.0 for b in self.buckets}

    def bucket_for(self, n_targets: int) -> int:
        """Smallest bucket admitting ``n_targets`` (the largest bucket
        for anything bigger — the caller chunks oversized requests)."""
        for b in self.buckets:
            if n_targets <= b:
                return b
        return self.buckets[-1]

    def estimate(self, bucket: int) -> float:
        return self._est[bucket]

    def observe(self, bucket: int, service_s: float) -> None:
        """Fold a measured micro-batch service time into the bucket's
        EWMA (the coalescer's notion of how expensive waiting is)."""
        prev = self._est[bucket]
        self._est[bucket] = (service_s if prev == 0.0
                             else 0.7 * prev + 0.3 * service_s)

    # -- pending set ---------------------------------------------------------
    def add(self, item: Any, n_targets: int, deadline: float) -> None:
        self._pending.append((deadline, n_targets, item))

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def pending_targets(self) -> int:
        return sum(n for _, n, _ in self._pending)

    def flush_at(self) -> Optional[float]:
        """Absolute time the pending set must flush to protect the oldest
        request's SLO (None = nothing pending). New arrivals only ever
        move this EARLIER (they cannot relax an existing deadline)."""
        if not self._pending:
            return None
        oldest = min(d for d, _, _ in self._pending)
        b = self.bucket_for(min(self.pending_targets, self.buckets[-1]))
        return oldest - self.estimate(b) - self.safety_s

    def due(self, now: float) -> bool:
        if not self._pending:
            return False
        if self.pending_targets >= self.buckets[-1]:
            return True
        return now >= self.flush_at()

    def take(self) -> List[Any]:
        """Pop the flushing micro-batch: requests in arrival order until
        the next one would overflow the largest bucket (it stays pending
        for the following flush)."""
        out, total = [], 0
        keep: List[Tuple[float, int, Any]] = []
        for deadline, n, item in self._pending:
            if out and total + n > self.buckets[-1]:
                keep.append((deadline, n, item))
                continue
            out.append(item)
            total += n
        self._pending = keep
        return out


@dataclass
class _Request:
    ids: np.ndarray
    arrival: float
    future: Future = field(default_factory=Future)


# the arrays of a micro-batch that the forward reads besides the features,
# per layer, in the order they are packed
_LAYER_FIELDS = ("edge_src", "edge_dst", "edge_mask", "node_mask",
                 "self_idx")


def _entries(bucket: int, fanouts: Sequence[int], feat_dim: int) -> list:
    """``(key, layer, shape, dtype)`` of every static array of a bucket's
    batch, at the bucket's capacities: the dtypes of
    ``core/trainer.batch_host_arrays``."""
    n_caps, e_caps = layer_capacities_for(bucket, fanouts)
    out = [("feats", None, (n_caps[0], feat_dim), np.dtype(np.float32))]
    for key in _LAYER_FIELDS:
        caps = {"node_mask": n_caps, "self_idx": n_caps[1:]}.get(key, e_caps)
        dtype = np.dtype(bool if key.endswith("mask") else np.int32)
        out += [(key, l, (c,), dtype) for l, c in enumerate(caps)]
    return out


class BucketForward:
    """One bucket's forward over static buffers: the counterpart of the
    reference's ``jax.jit`` a bucket.

    Every array of the bucket's batch (``feats`` and each layer's
    ``edge_src``, ``edge_dst``, ``edge_mask``, ``node_mask`` and
    ``self_idx``, at the bucket's capacities) is a view at a fixed,
    256-byte aligned offset of one host buffer (pinned on the card's path)
    and of one device buffer. :meth:`__call__` stages a batch (the host
    gather writes the feature rows into the host buffer, the other arrays
    are copied in, one asynchronous copy moves the bytes to the device),
    runs the forward and returns the logits as a numpy array.

    On the card the forward is one CUDA graph: captured at the first call
    (after ``CAPTURE_WARMUP_RUNS`` eager runs) on the card's one capture
    stream (:func:`capture_stream`), under ``torch.no_grad()`` and
    ``capture_error_mode="thread_local"``, into the memory pool ``pool``,
    which every bucket of a runtime shares (the caller serialises
    replays). The graph is replayed at every call. A capture that fails
    raises: there is no eager fallback. On the CPU the forward is the
    eager one over the same views.

    ``last`` holds the last call's ``gather_ms``, ``upload_ms`` and
    ``forward_ms`` (device times by CUDA events on the card, host times
    elsewhere); :meth:`record` keeps a request's :data:`STAGES` in
    ``samples`` (the caller leaves out the request that built the
    forward, whose time is ``build_ms``); ``static_bytes`` is the device
    buffer's size and ``pool_growth_bytes`` what the capture added to the
    shared pool."""

    def __init__(self, cfg: GNNModelConfig, params, bucket: int,
                 feat_dim: int, device: torch.device, pool=None):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.pool = pool
        self._cuda = device.type == "cuda"
        entries = _entries(bucket, cfg.fanouts, feat_dim)
        offs, total = pack_offsets((shape, dtype)
                                   for _, _, shape, dtype in entries)
        self.static_bytes = total
        self._host = torch.zeros(total, dtype=torch.uint8,
                                 pin_memory=self._cuda)
        self._dev = (torch.zeros(total, dtype=torch.uint8, device=device)
                     if self._cuda else self._host)
        self.host: Dict[str, Any] = {}
        self.batch: Dict[str, Any] = {}
        for (key, l, shape, dtype), off in zip(entries, offs):
            h = typed_view(self._host, off, shape, dtype).numpy()
            d = typed_view(self._dev, off, shape, dtype)
            if l is None:
                self.host[key], self.batch[key] = h, d
            else:
                self.host.setdefault(key, []).append(h)
                self.batch.setdefault(key, []).append(d)
        self.n0 = entries[0][2][0]
        self.built = False  # captured (card) or run once (CPU)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self.pool_growth_bytes = 0
        self._events = ([torch.cuda.Event(enable_timing=True)
                         for _ in range(3)] if self._cuda else None)
        self.last: Dict[str, float] = {}
        self.samples: Dict[str, List[float]] = {k: [] for k in STAGES}
        self.build_ms = 0.0

    def stage(self, mb: MiniBatch, store: FeatureStore) -> None:
        """Write ``mb`` (at this bucket's capacities) and its layer-0
        feature rows into the host buffer and queue the copy to the device
        on the current stream."""
        t0 = time.perf_counter()
        store.gather(0, mb.nodes[0], mb.node_mask[0], out=self.host["feats"])
        self.last = {"gather_ms": (time.perf_counter() - t0) * 1e3}
        for key in _LAYER_FIELDS:
            for dst, src in zip(self.host[key], getattr(mb, key)):
                np.copyto(dst, src, casting="no")
        if self._cuda:
            self._events[0].record()
            self._dev.copy_(self._host, non_blocking=True)
            self._events[1].record()

    def _forward(self) -> torch.Tensor:
        with torch.no_grad():
            return gnn_models.forward(self.cfg, self.params, self.batch)

    def capture(self) -> None:
        """Capture the forward over the staged buffers as a CUDA graph.
        Raises if the capture fails (an op that waits for the host, or
        another thread's unsafe call in this one)."""
        stream = torch.cuda.current_stream(self.device)
        with _CAPTURE_LOCK:
            side = capture_stream(self.device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for _ in range(CAPTURE_WARMUP_RUNS):
                    self._forward()
            stream.wait_stream(side)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                      capture_error_mode="thread_local"):
                    out = self._forward()
            finally:  # a failed capture_end leaves the capture stream current
                torch.cuda.set_stream(stream)
        self.graph, self._out = graph, out
        self.pool_growth_bytes = (torch.cuda.memory_reserved(self.device)
                                  - reserved)

    def replay(self) -> torch.Tensor:
        """The captured forward over what the device buffer holds: the
        graph's output tensor, rewritten at every replay."""
        self.graph.replay()
        return self._out

    def __call__(self, mb: MiniBatch, store: FeatureStore) -> np.ndarray:
        self.stage(mb, store)
        if not self._cuda:
            t0 = time.perf_counter()
            logits = self._forward().numpy()
            self.last["forward_ms"] = (time.perf_counter() - t0) * 1e3
            self.built = True
            return logits
        if self.graph is None:
            self.capture()
            self.built = True
        out = self.replay()
        self._events[2].record()
        logits = out.cpu().numpy()  # waits for the replay
        ev = self._events
        self.last["upload_ms"] = ev[0].elapsed_time(ev[1])
        self.last["forward_ms"] = ev[1].elapsed_time(ev[2])
        return logits

    def record(self, sample_ms: float, service_ms: float) -> None:
        """Keep a request's stages: the caller's sample (or pool fetch)
        and whole service ms beside the last call's."""
        row = {"upload_ms": 0.0, **self.last, "sample_ms": sample_ms,
               "service_ms": service_ms}
        for k in STAGES:
            self.samples[k].append(row[k])


def _own_params(params, device: torch.device) -> dict:
    """The runtime's own float32 copy of a parameter tree (tensors, e.g.
    ``TrainResult.params``, or numpy arrays) on ``device``: a trainer that
    steps on after ``serve()`` does not change what is served."""
    leaves = flatten(params)
    if leaves and isinstance(leaves[0], torch.Tensor):
        return unflatten(params, [t.detach().to(device=device,
                                                dtype=torch.float32,
                                                copy=True)
                                  for t in leaves])
    return params_from_numpy(params, device)


class ServingRuntime:
    """Target-node inference over a trained (or fresh) parameter set.

    ``predict(ids)`` is the synchronous path: one request becomes one
    micro-batch immediately (deterministic — the bitwise contracts and
    chaos tests pin it). ``submit(ids)`` is the concurrent path: requests
    queue to a dispatcher thread that coalesces them through the
    :class:`MicroBatcher` before sampling. Both share ``_serve_targets``:
    pad the target ids cyclically up to the bucket, submit one
    explicit-target task through the scheduling core (pool or in-process
    twin — payloads bitwise equal either way), gather features into the
    bucket's staging buffer, and run the bucket's forward
    (:class:`BucketForward`). ``device`` is the card unless the caller
    asks for the CPU (``device="cpu"``)."""

    def __init__(self, graph: Graph, model_cfg: GNNModelConfig, params,
                 *, algorithm: str = "distdgl",
                 serve_cfg: Optional[ServeConfig] = None,
                 store: Optional[FeatureStore] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.graph = graph
        self.cfg = model_cfg
        self.params = _own_params(params, self.device)
        self.serve_cfg = serve_cfg if serve_cfg is not None else ServeConfig()
        self.seed = seed
        self.buckets = bucket_ladder(model_cfg.batch_targets,
                                     self.serve_cfg.buckets)
        self.slo_s = self.serve_cfg.slo_ms / 1e3
        if store is None:
            part_name, store_name = ALGORITHMS[algorithm]
            partition = get_partitioner(part_name)(graph, 1, seed)
            store = FeatureStore(graph, partition, store_name)
        self.store = store
        # private sampler: the in-process twin of a pool worker. Request
        # batches never draw the tail-pad stream (the runtime pads targets
        # itself), so the train-id set does not influence the payload.
        self._sampler = NeighborSampler(graph, model_cfg, graph.train_ids,
                                        0, seed)
        self._pool: Optional[SamplerPool] = None
        if self.serve_cfg.num_workers >= 1:
            fault = model_cfg.fault
            self._pool = SamplerPool(
                graph, model_cfg, [graph.train_ids], seed=seed,
                num_workers=self.serve_cfg.num_workers,
                max_respawns=fault.max_respawns,
                straggler_timeout_s=fault.straggler_timeout_s,
                speculative=fault.speculative_sampling,
                fault_spec=fault.fault_spec)
        self._core = SchedulingCore(
            pool=self._pool, local_fn=self._local_payload,
            fetch_timeout=self.serve_cfg.fetch_timeout_s)
        self.batcher = MicroBatcher(self.buckets, self.slo_s,
                                    self.serve_cfg.safety_frac)
        # bucket -> its forward; every bucket's CUDA graph allocates from
        # one pool (replays are serialised by the lock)
        self._fwd: Dict[int, BucketForward] = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self._builds = 0
        self._next_rid = 0
        self._lock = threading.Lock()
        self._closed = False
        # dispatcher state (submit path)
        self._queue: "Queue[_Request]" = Queue()
        self._dispatcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # service metrics
        self.latencies_s: List[float] = []
        self.slo_misses = 0
        self.completed = 0

    # -- the bucket forwards --------------------------------------------------
    def _forward_for(self, bucket: int) -> BucketForward:
        fwd = self._fwd.get(bucket)
        if fwd is None:
            fwd = self._fwd[bucket] = BucketForward(
                self.cfg, self.params, bucket, self.graph.features.shape[1],
                self.device, self._graph_pool)
        return fwd

    @property
    def forward_compiles(self) -> int:
        """Bucket forwards built: CUDA graphs captured on the card, eager
        forwards run once on the CPU — flat after warmup is the
        zero-steady-state-recompile contract."""
        return self._builds

    def warmup(self) -> int:
        """Build every bucket's forward up front (one dummy micro-batch
        each, smallest first) so the first real request never pays a
        capture. Returns the build count."""
        anchor = int(self.graph.train_ids[0])
        for b in self.buckets:
            self._serve_targets(np.full(b, anchor, np.int32))
        return self.forward_compiles

    def bucket_stats(self) -> Dict[int, Dict[str, Any]]:
        """For each bucket built: the layer-0 rows ``n0``; the number of
        ``requests`` it served since the last :meth:`reset_stats` (the one
        that built its forward left out) and their median
        :data:`STAGES` (None before any): host ms of sampling (or fetching
        from the pool) and of the feature gather, the upload and forward
        ms (device times by CUDA events on the card, the forward's host
        time on the CPU) and the micro-batch's whole service ms; the build
        request's ``build_ms`` (on the card, the capture included); the
        static buffers' bytes and what its capture added to the shared
        graph pool."""
        out = {}
        for b, f in sorted(self._fwd.items()):
            med = {k: float(np.median(v)) if v else None
                   for k, v in f.samples.items()}
            out[b] = {"n0": f.n0, "requests": len(f.samples["service_ms"]),
                      **med, "build_ms": f.build_ms,
                      "static_bytes": f.static_bytes,
                      "pool_growth_bytes": f.pool_growth_bytes}
        return out

    # -- the request path -----------------------------------------------------
    def _local_payload(self, task: BatchTask) -> dict:
        """Workers=0 twin of a pool request task — the bucket-shaped batch
        straight from the sampler (no codec pad/slice round trip, which is
        exact, so both paths hand identical arrays downstream)."""
        mb = self._sampler.request_batch(task.epoch, task.index,
                                         task.targets)
        return {"minibatch": mb, "layout": None, "features": None,
                "ring_bytes": 0, "load": mb.work_estimate()}

    def _serve_targets(self, ids: np.ndarray) -> np.ndarray:
        """One micro-batch end to end; returns (len(ids), n_classes)
        logits aligned with ``ids``. Thread-confined to the caller — the
        lock serializes device work between predict() callers and the
        dispatcher, and the logits reach the host before it is released."""
        ids = np.asarray(ids, np.int32)
        m = len(ids)
        bucket = self.batcher.bucket_for(m)
        # cyclic pad: deterministic (no RNG), and np.unique inside the
        # sampler collapses the duplicates so padding costs ~nothing
        padded = ids[np.arange(bucket) % m]
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            ts = time.perf_counter()
            task = BatchTask(0, SERVE_EPOCH, rid, 0, 0, padded)
            self._core.submit_unit(rid, [task])
            _, payloads = self._core.collect_unit(
                timeout=self.serve_cfg.fetch_timeout_s)
            mb = payloads[0]["minibatch"]
            if len(mb.targets) != bucket:  # pool path: codec-shaped — slice
                n_caps, e_caps = layer_capacities_for(bucket,
                                                      self.cfg.fanouts)
                mb = slice_minibatch(mb, n_caps, e_caps)
            t0 = time.perf_counter()
            fwd = self._forward_for(bucket)
            built = fwd.built
            logits = fwd(mb, self.store)
            t1 = time.perf_counter()
            if built:
                fwd.record((t0 - ts) * 1e3, (t1 - ts) * 1e3)
            else:
                self._builds += 1
                fwd.build_ms = (t1 - t0) * 1e3
            self.batcher.observe(bucket, t1 - t0)
        return logits[:m]

    def predict(self, ids: np.ndarray) -> np.ndarray:
        """Synchronous inference for ``ids`` (chunked through the largest
        bucket when oversized). Records one latency/SLO sample."""
        if self._closed:
            raise RuntimeError("ServingRuntime is closed")
        t0 = time.monotonic()
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        cap = self.buckets[-1]
        out = [self._serve_targets(ids[lo:lo + cap])
               for lo in range(0, len(ids), cap)]
        self._record(time.monotonic() - t0)
        return np.concatenate(out, axis=0)

    def _record(self, latency_s: float) -> None:
        self.latencies_s.append(latency_s)
        self.completed += 1
        if latency_s > self.slo_s:
            self.slo_misses += 1

    # -- concurrent frontend --------------------------------------------------
    def start(self) -> "ServingRuntime":
        """Start the dispatcher thread serving :meth:`submit` requests."""
        if self._dispatcher is None:
            self._stop.clear()
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, name="hitgnn-serve-dispatch",
                daemon=True)
            self._dispatcher.start()
        return self

    def submit(self, ids: np.ndarray) -> Future:
        """Enqueue one request; the Future resolves to its
        (len(ids), n_classes) logits once a coalesced micro-batch carries
        it through the substrate."""
        if self._closed:
            raise RuntimeError("ServingRuntime is closed")
        if self._dispatcher is None:
            self.start()
        req = _Request(np.atleast_1d(np.asarray(ids, np.int32)),
                       time.monotonic())
        self._queue.put(req)
        return req.future

    def _dispatch_loop(self) -> None:
        batcher = self.batcher
        while not self._stop.is_set():
            now = time.monotonic()
            flush_at = batcher.flush_at()
            wait = (0.05 if flush_at is None
                    else max(0.0, min(flush_at - now, 0.05)))
            try:
                req = self._queue.get(timeout=wait)
                batcher.add(req, len(req.ids),
                            req.arrival + self.slo_s)
            except Empty:
                pass
            while batcher.due(time.monotonic()):
                self._flush(batcher.take())
        # drain: fail any still-queued requests loudly on shutdown
        while True:
            try:
                req = self._queue.get_nowait()
            except Empty:
                break
            req.future.set_exception(RuntimeError("serving runtime closed"))
        for _, _, req in batcher._pending:
            req.future.set_exception(RuntimeError("serving runtime closed"))
        batcher._pending = []

    def _flush(self, requests: List[_Request]) -> None:
        if not requests:
            return
        ids = np.concatenate([r.ids for r in requests])
        try:
            logits = self._serve_targets(ids)
        except BaseException as e:  # handed to every waiting caller
            for r in requests:
                r.future.set_exception(e)
            return
        now = time.monotonic()
        lo = 0
        for r in requests:
            r.future.set_result(logits[lo:lo + len(r.ids)])
            lo += len(r.ids)
            self._record(now - r.arrival)

    # -- reporting / lifecycle ------------------------------------------------
    def stats(self) -> dict:
        lat = np.asarray(self.latencies_s, np.float64)
        out = {
            "completed": self.completed,
            "slo_ms": self.serve_cfg.slo_ms,
            "slo_misses": self.slo_misses,
            "slo_miss_rate": (self.slo_misses / self.completed
                              if self.completed else 0.0),
            "p50_ms": float(np.percentile(lat, 50) * 1e3) if lat.size
            else 0.0,
            "p99_ms": float(np.percentile(lat, 99) * 1e3) if lat.size
            else 0.0,
            "buckets": list(self.buckets),
            "forward_compiles": self.forward_compiles,
            "pool_workers": self.serve_cfg.num_workers,
        }
        if self._pool is not None:
            out["pool"] = dict(self._pool.stats)
            out["pool_degraded"] = self._pool.degraded
        return out

    def reset_stats(self) -> None:
        """Zero the latency/SLO counters and the buckets' stage samples
        (load points call this between measurements; build counts are NOT
        reset — steady-state captures must stay visible across points)."""
        self.latencies_s = []
        self.slo_misses = 0
        self.completed = 0
        with self._lock:
            for f in self._fwd.values():
                f.samples = {k: [] for k in STAGES}

    def close(self) -> None:
        """Stop the dispatcher, tear down the pool and release the
        buckets' buffers and graphs. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5.0)
            self._dispatcher = None
        if self._pool is not None:
            self._pool.close()
        with self._lock:
            self._fwd.clear()

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def closed_loop_load(runtime: ServingRuntime, target_pool: np.ndarray,
                     clients: int, requests_per_client: int,
                     ids_per_request: int = 1, seed: int = 0) -> dict:
    """Closed-loop load generator: ``clients`` threads each issue
    ``requests_per_client`` back-to-back requests (submit, wait, repeat) —
    offered load scales with the client count, the classic way to sweep a
    latency/throughput curve without open-loop timer drift. Returns the
    load point's measurements from the runtime's counters (reset first)."""
    runtime.reset_stats()
    target_pool = np.asarray(target_pool, np.int32)
    errors: List[BaseException] = []

    def client(cid: int) -> None:
        rng = np.random.default_rng((seed, cid))
        try:
            for _ in range(requests_per_client):
                ids = rng.choice(target_pool, size=ids_per_request)
                runtime.submit(ids).result(
                    timeout=runtime.serve_cfg.fetch_timeout_s + 30.0)
        except BaseException as e:  # surfaced after the join
            errors.append(e)

    runtime.start()
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    stats = runtime.stats()
    done = stats["completed"]
    return {"clients": clients, "requests": done,
            "offered_rps": done / wall if wall > 0 else 0.0,
            "wall_s": wall, "p50_ms": stats["p50_ms"],
            "p99_ms": stats["p99_ms"],
            "slo_miss_rate": stats["slo_miss_rate"]}

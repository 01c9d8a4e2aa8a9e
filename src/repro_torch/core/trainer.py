"""Synchronous GNN trainer on one card (counterpart of
``repro.core.trainer.SyncGNNTrainer``).

Per synchronous iteration (paper Fig. 2 / Alg. 2 + gradient sync):
  1. the two-stage scheduler picks p mini-batches, one per simulated device;
  2. the host samples each batch, builds each layer's layout under a kernel
     ``aggregate_backend`` (the compact triples for "pallas", the edge
     segments for "pallas_edges" and "pallas_fused") and gathers its
     feature rows through the FeatureStore (beta accounting); the
     ``LoadBalancer`` places each batch on a device ("round_robin" keeps the
     schedule's device, "load" runs greedy LPT over the Eq. 5 loads);
  3. each batch crosses the bus from a slot of a pinned staging ring in one
     asynchronous copy on the trainer's upload stream
     (``core/staging.py``); the step waits for the copies' event, takes
     each batch's loss and gradients in turn (a Python loop in place of the
     reference's ``vmap``) and combines them as ``sum_b w_b g_b /
     max(sum_b w_b, 1)``: idle-device fill batches carry weight 0;
  4. one AdamW update.

The host runtime is the reference's. With ``pipeline=True`` (the default)
a prefetch thread (``core/pipeline.PrefetchExecutor``) runs stages 1-2 and
issues the copies of iteration t+1 while the main thread launches step t,
and the main thread reads no metric until the epoch ends: at most
``prefetch_depth`` steps stay in flight, each behind an event. With
``num_sampler_workers=N`` stages 1 and 2b (sample, layout) run in N
spawned worker processes over a shared-memory graph
(``core/sampler_pool.SamplerPool``), fed through
``core/scheduling.SchedulingCore``; with ``gather_in_workers`` the workers
also gather the rows that must cross the bus. Payloads come back in
submission order, so every combination trains bitwise like the in-process
sequential epoch.

Under ``data_parallel=True`` (the reference's mesh dataflow, with all p
simulated devices on the one card) step 2 gathers no feature block: every
device's resident rows live on the card for the trainer's life
(``FeatureStore.build_shard_matrix``, uploaded once at the first step),
each batch ships its shard positions and exactly its miss rows (gathered
straight into its staging slot), and step 3 assembles each batch's layer-0
block on the card just before its loss
(``gnn.models.assemble_device_feats``).

Host stages are bitwise copies of the reference's, so from one seed both
trainers sample the same batches and build the same layouts. Knobs the port
does not run yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.gnn import CacheConfig, GNNModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition import Partition, get_partitioner
from repro_torch.core.pipeline import PipelineStats, PrefetchExecutor
from repro_torch.core.sampler import (MiniBatch, NeighborSampler,
                                      layer_capacities)
from repro_torch.core.sampler_pool import SamplerPool, suggest_ship_rows_cap
from repro_torch.core.scheduling import BatchTask, EpochSource, SchedulingCore
from repro_torch.core.staging import StagingRing, UploadPack
from repro_torch.data.graphs import Graph
from repro_torch.device import resolve_device
from repro_torch.gnn import models as gnn_models
from repro_torch.kernels.layout import (BLK, EDGE_STREAM_BACKENDS,
                                        block_capacities, build_layer_layouts,
                                        compact_layout_bytes,
                                        dense_layout_bytes,
                                        densified_tile_bytes,
                                        edge_stream_layout_bytes)
from repro_torch.nn.param import (flatten, init_params, params_from_numpy,
                                  unflatten)
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedules import cosine

ALGORITHMS = {
    # name: (partitioner, feature-storing strategy)
    "distdgl": ("metis_like", "distdgl"),
    "pagraph": ("pagraph", "pagraph"),
}


# the host-runtime fields that override model_cfg.host / model_cfg.fault
# when set (None inherits the config's value), as aggregate_backend does
HOST_KNOBS = ("num_sampler_workers", "balance_policy", "gather_in_workers",
              "worker_affinity")
FAULT_KNOBS = ("max_respawns", "straggler_timeout_s", "speculative_sampling",
               "fault_spec")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def batch_host_arrays(mb: MiniBatch, feats: Optional[np.ndarray],
                      layout: Optional[dict] = None) -> dict:
    """One mini-batch (+ its layer-0 features, unless ``feats`` is None,
    and, for the kernel path, its edge-segment layout) as a dict of numpy
    arrays and per-layer lists of them: what the step reads."""
    out = {
        "edge_src": list(mb.edge_src),
        "edge_dst": list(mb.edge_dst),
        "edge_mask": list(mb.edge_mask),
        "node_mask": list(mb.node_mask),
        "self_idx": list(mb.self_idx),
        "labels": np.asarray(mb.labels, np.int32),
    }
    if feats is not None:
        out["feats"] = np.asarray(feats, np.float32)
    out.update(layout or {})
    return out


def batch_to_arrays(mb: MiniBatch, feats: Optional[np.ndarray], device,
                    layout: Optional[dict] = None) -> dict:
    """``batch_host_arrays`` as tensors on ``device``, with the batch's
    loss weight in the synchronous step (``weight``; fill batches get 0)."""
    out = {k: ([_to_device(a, device) for a in v] if isinstance(v, list)
               else _to_device(v, device))
           for k, v in batch_host_arrays(mb, feats, layout).items()}
    out["weight"] = 1.0
    return out


def resident_payload(core, dev: int, ids: np.ndarray,
                     valid: np.ndarray) -> dict:
    """The index half of a batch's ``data_parallel`` payload for device
    ``dev`` (int64 arrays for ``gnn.models.assemble_device_feats``):
    ``hit_idx``, the valid rows resident on ``dev``, ``hit_pos``, their
    rows in its shard (``ResidencyCore.resident_positions``), and
    ``miss_pos``, the valid rows that are not resident — the rows
    ``ResidencyCore.select_ship_rows`` ships, derived from the hit mask
    without a second search."""
    pos, hit = core.resident_positions(dev, ids, valid)
    hit_idx = np.flatnonzero(hit)
    return {"hit_idx": hit_idx, "hit_pos": pos[hit_idx].astype(np.int64),
            "miss_pos": np.flatnonzero(valid & ~hit)}


@dataclass
class SyncGNNTrainer:
    graph: Graph
    model_cfg: GNNModelConfig
    num_devices: int
    algorithm: str = "distdgl"
    lr: float = 1e-2
    seed: int = 0
    workload_balancing: bool = True        # paper WB optimization
    grad_compression: bool = False
    mesh: Optional[object] = None
    data_parallel: bool = False
    optimizer_name: str = "adam"
    pipeline: bool = True                  # overlap host stages w/ device step
    prefetch_depth: int = 2
    aggregate_backend: Optional[str] = None  # overrides model_cfg when set
    # the sampling service (model_cfg.host) and its fault tolerance
    # (model_cfg.fault): None inherits the config's value, a value here
    # overrides it
    num_sampler_workers: Optional[int] = None
    balance_policy: Optional[str] = None
    gather_in_workers: Optional[bool] = None
    worker_affinity: Optional[bool] = None
    max_respawns: Optional[int] = None
    straggler_timeout_s: Optional[float] = None
    speculative_sampling: Optional[bool] = None
    fault_spec: Optional[str] = None
    cache_capacity: Optional[int] = None
    checkpointer: Optional[object] = None
    # "cuda" when None; "cpu" runs the plain PyTorch path
    device: Optional[str] = None
    # initial parameters as numpy ({"layers": [{name: array}]}), e.g. the
    # reference's materialize(spec, PRNGKey(seed)); None = the port's own
    # seeded init
    params: Optional[dict] = None

    def __post_init__(self):
        cfg = self.model_cfg
        if self.aggregate_backend is not None:
            cfg = dataclasses.replace(
                cfg, aggregate_backend=self.aggregate_backend)
        host = {k: getattr(self, k) for k in HOST_KNOBS
                if getattr(self, k) is not None}
        fault = {k: getattr(self, k) for k in FAULT_KNOBS
                 if getattr(self, k) is not None}
        self.model_cfg = dataclasses.replace(
            cfg, host=dataclasses.replace(cfg.host, **host),
            fault=dataclasses.replace(cfg.fault, **fault))
        host = self.model_cfg.host
        self.num_sampler_workers = host.num_sampler_workers
        self.balance_policy = host.balance_policy
        self.gather_in_workers = (host.gather_in_workers
                                  and host.num_sampler_workers > 0)
        self.worker_affinity = host.worker_affinity
        self._check_ported()
        self.device = resolve_device(self.device)
        part_name, store_name = ALGORITHMS[self.algorithm]
        self.partition: Partition = get_partitioner(part_name)(
            self.graph, self.num_devices, self.seed)
        self.store = FeatureStore(self.graph, self.partition, store_name)
        self.samplers = [
            NeighborSampler(self.graph, self.model_cfg,
                            self._train_ids(i), i, self.seed)
            for i in range(self.num_devices)]
        self.spec = gnn_models.param_spec(
            self.model_cfg, self.graph.features.shape[1],
            self.graph.num_classes)
        self.params = (init_params(self.spec, self.seed, self.device)
                       if self.params is None
                       else params_from_numpy(self.params, self.device))
        # the reference's schedule: 10 warmup steps of a 100k-step cosine
        self.optimizer = AdamW(cosine(self.lr, 10, 100_000), weight_decay=0.0)
        self.opt_state = self.optimizer.init(flatten(self.params))
        # static per-layer layout capacities: one shape per config
        self._blk_caps = (block_capacities(self.model_cfg)
                          if self.model_cfg.aggregate_backend
                          in gnn_models.KERNEL_BACKENDS else [])
        self._balancer = sched.LoadBalancer(self.num_devices,
                                            self.balance_policy)
        self._pstats = PipelineStats()
        self._pool: Optional[SamplerPool] = None
        self._pool_stats0: Dict[str, float] = {}
        # data_parallel: the (p, shard_rows, f) resident shards on the card
        # (uploaded at the first step). At most _miss_cap rows miss a
        # batch: every layer-0 row in the worst case, unless ship_rows_cap
        # says fewer.
        self._shard: Optional[torch.Tensor] = None
        self._miss_cap = 0
        if self.data_parallel:
            cap = self.model_cfg.cache.ship_rows_cap
            self._miss_cap = (cap if cap is not None
                              else layer_capacities(self.model_cfg)[0][0])
        # every batch crosses the bus from a slot of the staging ring, in
        # one copy on the upload stream: a slot per batch of the groups
        # the prefetch queue holds, the one being filled and the one the
        # step is reading
        self._upload_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)
        self._ring = StagingRing((self.prefetch_depth + 2) * self.num_devices,
                                 self.device)
        # main-thread seconds spent launching device steps (up to the last
        # launch, before any metric is read): what a producer thread that
        # holds the GIL takes from the step; and the epoch's seconds
        # pulling payloads from the sampler pool (_timed_fetch)
        self._issue_s = 0.0
        self._fetch_s = 0.0

    def _check_ported(self) -> None:
        cfg = self.model_cfg
        if self.algorithm == "p3":
            raise _unported("algorithm 'p3'", "queue A, item A.2")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; "
                             f"expected one of {tuple(ALGORITHMS)}")
        if cfg.name not in gnn_models.MODELS:
            raise _unported(f"model {cfg.name!r}", "queue A, item A.1")
        backend = cfg.aggregate_backend
        if backend not in gnn_models.BACKENDS:
            raise ValueError(f"unknown aggregate_backend {backend!r}; "
                             f"expected one of {gnn_models.BACKENDS}")
        if self.balance_policy not in sched.BALANCE_POLICIES:
            raise ValueError(
                f"unknown balance_policy {self.balance_policy!r}; "
                f"expected one of {sched.BALANCE_POLICIES}")
        if self.num_sampler_workers < 0:
            raise ValueError("num_sampler_workers must be >= 0")
        if self.prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        # the ship-rows cap alone is no cache: it bounds the rows a batch
        # ships (data_parallel's miss rows, the pool's ring slot)
        if self.cache_capacity is not None or dataclasses.replace(
                cfg.cache, ship_rows_cap=None,
                auto_ship_rows_cap=True) != CacheConfig():
            raise _unported(f"cache {cfg.cache} / cache_capacity="
                            f"{self.cache_capacity} (the feature cache)",
                            "queue A, item A.6")
        if cfg.cache.ship_rows_cap is not None and cfg.cache.ship_rows_cap < 1:
            raise ValueError("ship_rows_cap must be >= 1")
        if self.checkpointer is not None:
            raise _unported("checkpointer", "queue A, item A.7")
        if self.grad_compression:
            raise _unported("grad_compression", "queue A, item A.8")
        if self.mesh is not None:
            raise _unported("mesh (data parallelism over several cards)",
                            "queue A, item A.9")
        if self.optimizer_name != "adam":
            raise _unported(f"optimizer {self.optimizer_name!r}",
                            "queue A, item A.11")

    def _train_ids(self, i: int) -> np.ndarray:
        mask = self.partition.assignment[self.graph.train_ids] == i
        ids = self.graph.train_ids[mask]
        return ids if len(ids) else self.graph.train_ids[:1]

    def epoch_schedule(self) -> List[sched.Assignment]:
        counts = [s.batches_remaining() for s in self.samplers]
        fn = (sched.two_stage_schedule if self.workload_balancing
              else sched.naive_schedule)
        return fn(counts)

    def _edge_stream(self) -> bool:
        return self.model_cfg.aggregate_backend in EDGE_STREAM_BACKENDS

    def densified_hbm_bytes(self) -> int:
        """Device bytes per batch of the dense (Nd, max_blk, 128, 128)
        tiles of A and A^T that ``"pallas"`` densifies from the compact
        triples (the reference's formula; the port never forms layer 0's
        A^T, whose input features need no gradient). 0 under the
        edge-segment backends, whose kernels never form a tile in device
        memory, and under ``"reference"``."""
        if not self._blk_caps or self._edge_stream():
            return 0
        return densified_tile_bytes(self._blk_caps)

    def aggregate_h2d_bytes(self, layout: str = "compact") -> int:
        """Host->device bytes per batch of the aggregate path's layout:
        ``"compact"`` is what ``"pallas"`` ships (per-edge triples and the
        cols tables), ``"edges"`` the edge segments of ``"pallas_edges"``
        and ``"pallas_fused"``, ``"dense"`` full 64 KB tiles."""
        fn = {"compact": compact_layout_bytes,
              "edges": edge_stream_layout_bytes,
              "dense": dense_layout_bytes}[layout]
        total = 0
        for n_src, n_dst, max_blk, max_blk_t, e_cap in self._blk_caps:
            n_srcb = (n_src + BLK - 1) // BLK
            n_dstb = (n_dst + BLK - 1) // BLK
            total += fn(e_cap, n_dstb, max_blk, n_srcb, max_blk_t)
        return total

    def aggregate_intermediate_bytes(self) -> int:
        """Device-memory bytes per batch of the layer aggregates that the
        unfused kernel paths (``"pallas"``, ``"pallas_edges"``) write as
        (n_dstb*128, f_in) f32 and read back for the update matmul
        (autograd keeps them for the backward). 0 under
        ``"pallas_fused"``, whose kernels keep each aggregate on chip,
        forward and backward, and under ``"reference"``, which has no
        layout."""
        if (not self._blk_caps
                or self.model_cfg.aggregate_backend == "pallas_fused"):
            return 0
        f_in = self.graph.features.shape[1]
        total = 0
        for (_, n_dst, _, _, _) in self._blk_caps:
            total += -(-n_dst // BLK) * BLK * f_in * 4
            f_in = self.model_cfg.hidden
        return total

    # -- host stages (the prefetch thread runs them under pipeline=True) -------
    def _local_payload(self, task: BatchTask) -> dict:
        """The scheduling core's workers=0 runner: stage 1 through the
        partition's cursor-stateful sampler (bitwise ``batch_at(task.epoch,
        task.index)``, because the schedule visits each partition's batches
        in index order) plus stage 2b (the layout build), each timed."""
        t0 = time.perf_counter()
        mb = self.samplers[task.partition].next_batch()
        t1 = time.perf_counter()
        layout = (build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                                      self._blk_caps,
                                      gnn_models.AGG_KIND[self.model_cfg.name],
                                      edge_stream=self._edge_stream())
                  if self._blk_caps else None)
        return {"minibatch": mb, "layout": layout,
                "load": mb.work_estimate(), "sample_s": t1 - t0,
                "layout_s": time.perf_counter() - t1}

    def _sample_payload(self, a: sched.Assignment) -> dict:
        """In-process twin of one SamplerPool task for assignment ``a``."""
        return self._local_payload(
            BatchTask(a.partition, self.samplers[a.partition].epoch,
                      a.batch_index, a.device))

    def _batch_load(self, a: sched.Assignment, payload: dict) -> float:
        """Eq. 5 load estimate for the dynamic balancer, including stage 2:
        vertices + edges traversed plus the feature elements that must
        cross the bus to the scheduled device (miss rows x feature dim).
        When the worker already gathered for ``a.device`` its shipped row
        count is that miss count. Under ``round_robin`` the balancer
        ignores loads, so the miss probe is skipped."""
        if self.balance_policy == "round_robin":
            return payload["load"]
        fpay = payload.get("features")
        if fpay is not None and fpay["device"] == a.device:
            miss = len(fpay["pos"])
        else:
            mb = payload["minibatch"]
            miss = self.store.core.miss_count(a.device, mb.nodes[0],
                                              mb.node_mask[0])
        return sched.LoadBalancer.batch_load(
            payload["load"], miss, self.graph.features.shape[1])

    def _batch_features(self, dev: int, payload: dict) -> np.ndarray:
        """Stage 2 on the host-gather path: the in-process gather, or — when
        the payload carries worker-gathered rows — their placement
        (``FeatureStore.place_gathered``). Timed into ``gather_s``."""
        mb = payload["minibatch"]
        t0 = time.perf_counter()
        fpay = payload.get("features")
        if fpay is not None:
            feats = self.store.place_gathered(
                dev, mb.nodes[0], mb.node_mask[0], fpay["pos"], fpay["rows"],
                shipped_for=fpay["device"])
        else:
            feats = self.store.gather(dev, mb.nodes[0], mb.node_mask[0])
        self._pstats.gather_s += time.perf_counter() - t0
        self._pstats.ring_bytes += payload.get("ring_bytes", 0)
        return feats

    def _resident_payload(self, dev: int, payload: dict,
                          pack: UploadPack) -> int:
        """Stage 2 under ``data_parallel`` (the reference's
        ``_batch_mesh_payload``): in place of the (N_0, f) block, the
        batch's hit rows and their positions in device ``dev``'s shard
        (``resident_payload``) and its miss rows go into ``pack``. The miss
        rows are the worker's (``gather_in_workers``) when it gathered for
        ``dev``, else gathered here, straight into the staging slot.
        Accounting equals ``FeatureStore.gather``'s. Returns the miss
        count."""
        mb = payload["minibatch"]
        t0 = time.perf_counter()
        ids = np.asarray(mb.nodes[0])
        valid = np.asarray(mb.node_mask[0], bool)
        idx = resident_payload(self.store.core, dev, ids, valid)
        fpay = payload.get("features")
        shipped = fpay is not None and fpay["device"] == dev
        if shipped:
            idx["miss_pos"] = fpay["pos"].astype(np.int64)
        mpos = idx["miss_pos"]
        n_miss = len(mpos)
        self.store.account_rows(dev, int(valid.sum()) - n_miss, n_miss)
        if n_miss > self._miss_cap:
            raise ValueError(
                f"batch ships {n_miss} miss rows to device {dev} but the "
                f"miss segment holds {self._miss_cap} "
                f"(ship_rows_cap={self.model_cfg.cache.ship_rows_cap}); "
                f"raise ship_rows_cap")
        for k, a in idx.items():
            pack.add(k, a)
        if shipped:
            pack.add("miss_rows", fpay["rows"])
        else:
            miss_ids = ids[mpos]
            pack.add_fill("miss_rows", (n_miss, self.graph.features.shape[1]),
                          np.float32,
                          lambda out: np.take(self.graph.features, miss_ids,
                                              axis=0, mode="clip", out=out))
        self._pstats.gather_s += time.perf_counter() - t0
        self._pstats.ring_bytes += payload.get("ring_bytes", 0)
        return n_miss

    def _assemble_group(self, assignments: List[sched.Assignment],
                        payloads: List[dict]) -> dict:
        """Stage 2 (gather, placement of worker-gathered rows, or the
        resident index payload) and the upload of one synchronous
        iteration's batches, from sampled payloads (in-process or pool).
        The balancer maps batches to devices; under ``round_robin`` on the
        host-gather path the batches keep group order with idle-device
        fills appended, otherwise slot d holds device d's batch (the
        resident path needs it: slot d runs against device d's shard) and
        empty slots repeat the last real batch at weight 0. All copies run
        on the upload stream and the group records one event after them;
        no kernel is launched here."""
        gather0, fill0 = self._pstats.gather_s, self._ring.fill_s
        stage_s = {"sample_s": sum(p.get("sample_s", 0.0) for p in payloads),
                   "layout_s": sum(p.get("layout_s", 0.0) for p in payloads),
                   "gather_s": 0.0, "upload_s": 0.0}
        if self.data_parallel:
            stage_s["miss_rows"] = 0
        t_start = time.perf_counter()
        loads = [self._batch_load(a, p) for a, p in zip(assignments, payloads)]
        devices = self._balancer.assign(assignments, loads)
        vertices = 0
        slots: List[Optional[dict]] = [None] * self.num_devices
        order: List[dict] = []
        uploaded: List[torch.Tensor] = []
        event = None
        with (torch.cuda.stream(self._upload_stream)
              if self._upload_stream is not None
              else contextlib.nullcontext()):
            for dev, payload in zip(devices, payloads):
                mb = payload["minibatch"]
                vertices += mb.vertices_traversed()
                pack = UploadPack()
                if self.data_parallel:
                    feats = None
                    stage_s["miss_rows"] += self._resident_payload(
                        dev, payload, pack)
                else:
                    feats = self._batch_features(dev, payload)
                for k, v in batch_host_arrays(mb, feats,
                                              payload["layout"]).items():
                    pack.add(k, v)
                arrs, base = self._ring.upload(pack)
                arrs["weight"] = 1.0
                uploaded.append(base)
                slots[dev] = arrs
                order.append(arrs)
            if self._upload_stream is not None:
                event = torch.cuda.Event()
                event.record(self._upload_stream)
        # the miss rows gathered straight into their slots count as gather
        self._pstats.gather_s += self._ring.fill_s - fill0
        stage_s["gather_s"] = self._pstats.gather_s - gather0
        stage_s["upload_s"] = (time.perf_counter() - t_start
                               - stage_s["gather_s"])
        if self.balance_policy == "round_robin" and not self.data_parallel:
            batches = order
            while len(batches) < self.num_devices:
                batches.append(dict(batches[-1], weight=0.0))
        else:
            batches = [b if b is not None else dict(order[-1], weight=0.0)
                       for b in slots]
        return {"batches": batches, "vertices": vertices,
                "n_batches": len(assignments), "stage_s": stage_s,
                "event": event, "uploaded": uploaded}

    def _prepare_group(self, assignments: List[sched.Assignment]) -> dict:
        """Stages 1, 2b and 2 and the upload for one synchronous iteration,
        sampled in-process."""
        return self._assemble_group(
            assignments, [self._sample_payload(a) for a in assignments])

    # -- stage 3: the device step -------------------------------------------------
    def _grads(self, batches: List[dict]):
        """Per-batch loss and gradients, combined by loss weight: returns
        (loss, acc, grads in ``flatten`` order)."""
        leaves = flatten(self.params)
        # the weights are written on the device (no copy from pageable host
        # memory, which would wait for the stream's earlier work)
        w = torch.zeros(len(batches), dtype=torch.float32, device=self.device)
        for d, b in enumerate(batches):
            if b["weight"]:
                w[d] = b["weight"]
        w_sum = w.sum().clamp_min(1.0)
        losses, accs, per_dev = [], [], []
        for d, b in enumerate(batches):
            if self.data_parallel:
                # one (N_0, f) block lives at a time: the next rebinding of
                # b frees this one
                b = dict(b, feats=gnn_models.assemble_device_feats(
                    self._shard[d], b))
            ps = [p.detach().requires_grad_(True) for p in leaves]
            loss, m = gnn_models.loss_fn(self.model_cfg,
                                         unflatten(self.params, ps), b)
            per_dev.append(torch.autograd.grad(loss, ps))
            losses.append(loss.detach())
            accs.append(m["acc"])
        loss = (torch.stack(losses) * w).sum() / w_sum
        acc = (torch.stack(accs) * w).sum() / w_sum
        grads = [torch.tensordot(w, torch.stack(gs), dims=1) / w_sum
                 for gs in zip(*per_dev)]
        return loss, acc, grads

    def _upload_shards(self) -> float:
        """Build every device's resident feature block and put it on the
        card once, from pinned memory, where it stays for the trainer's
        life (the reference's ``_upload_shards``). Returns its seconds:
        the build, the pinning and the copy. Runs on the main thread before
        the first step; its synchronize runs once a trainer."""
        t0 = time.perf_counter()
        mat = torch.from_numpy(self.store.build_shard_matrix())
        if self.device.type == "cuda":
            self._shard = mat.pin_memory().to(self.device, non_blocking=True)
            torch.cuda.synchronize(self.device)
        else:
            self._shard = mat
        return time.perf_counter() - t0

    def _receive(self, prepared: dict) -> List[dict]:
        """The prepared batches, usable on the current stream: it waits for
        the group's copies, and each uploaded buffer is recorded as in use
        there, so the caching allocator does not hand its memory (allocated
        on the upload stream) to another tensor before the step is done."""
        event = prepared.get("event")
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in prepared["uploaded"]:
                t.record_stream(current)
        return prepared["batches"]

    def _execute(self, prepared: dict, sync: bool = True) -> dict:
        """Run the step on the prepared batches. ``sync=True`` reads its
        metrics (which waits for the device) and returns them with the
        stage seconds; ``sync=False`` returns the metrics as 0-d tensors
        without reading them, so the main thread goes on launching while
        the device computes."""
        shard_s = None
        if self.data_parallel:
            shard_s = self._upload_shards() if self._shard is None else 0.0
        t0 = time.perf_counter()
        loss, acc, grads = self._grads(self._receive(prepared))
        new_leaves, self.opt_state, om = self.optimizer.update(
            grads, self.opt_state, flatten(self.params))
        self.params = unflatten(self.params, new_leaves)
        self._issue_s += time.perf_counter() - t0
        metrics = {"loss": loss, "acc": acc, "lr": om["lr"],
                   "grad_norm": om["grad_norm"]}
        if not sync:
            return metrics
        out = {k: float(v) for k, v in metrics.items()}
        out["vertices_traversed"] = prepared["vertices"]
        out.update(prepared["stage_s"])
        out["step_s"] = time.perf_counter() - t0
        if shard_s is not None:
            out["shard_upload_s"] = shard_s
        return out

    def run_iteration(self, assignments: List[sched.Assignment]) -> dict:
        """One synchronous iteration: loss, acc, lr, grad_norm, vertices
        traversed, and the seconds of each stage (sample, layout, gather,
        upload — the host's share of the copies, which run asynchronously
        — and the device step up to its metrics being read); under
        ``data_parallel`` also the miss rows shipped (``miss_rows``) and
        the seconds of the shard upload (``shard_upload_s``, 0 after the
        first step)."""
        return self._execute(self._prepare_group(assignments))

    # -- the sampling service ---------------------------------------------------
    def _ensure_pool(self) -> SamplerPool:
        """Lazily spawn the sampling service (first epoch); reused across
        epochs, torn down by close()."""
        if self._pool is None:
            kind = (gnn_models.AGG_KIND[self.model_cfg.name]
                    if self._blk_caps else None)
            fault = self.model_cfg.fault
            self._pool = SamplerPool(
                self.graph, self.model_cfg,
                [self._train_ids(i) for i in range(self.num_devices)],
                seed=self.seed, num_workers=self.num_sampler_workers,
                agg_kind=kind,
                blk_caps=self._blk_caps if self._blk_caps else None,
                residency=(self.store.core if self.gather_in_workers
                           else None),
                feat_rows_cap=self._ring_rows_cap(),
                worker_affinity=self.worker_affinity,
                max_respawns=fault.max_respawns,
                straggler_timeout_s=fault.straggler_timeout_s,
                speculative=fault.speculative_sampling,
                fault_spec=fault.fault_spec)
        return self._pool

    def _ring_rows_cap(self) -> Optional[int]:
        """Rows capacity of the sampling service's ring slot. An explicit
        ``CacheConfig.ship_rows_cap`` wins; with it unset and
        ``auto_ship_rows_cap`` on (the default) the cap is measured: the
        next three epochs' schedules are replayed through the pure
        ``batch_at`` streams, each batch's miss rows for its scheduled
        device counted, and the slot sized by ``suggest_ship_rows_cap``
        (the largest count plus 25%, at most the layer-0 node cap). A batch
        that outgrows it fails in ``PayloadCodec.encode`` naming the
        knob."""
        cfg = self.model_cfg
        if cfg.cache.ship_rows_cap is not None:
            return cfg.cache.ship_rows_cap
        if not self.gather_in_workers or not cfg.cache.auto_ship_rows_cap:
            return None
        fn = (sched.two_stage_schedule if self.workload_balancing
              else sched.naive_schedule)
        schedule = fn([s.epoch_batches() for s in self.samplers])
        counts = []
        epoch0 = self.samplers[0].epoch
        for epoch in range(epoch0, epoch0 + 3):
            for a in schedule:
                mb = self.samplers[a.partition].batch_at(epoch,
                                                         a.batch_index)
                counts.append(self.store.core.miss_count(
                    a.device, np.asarray(mb.nodes[0]),
                    np.asarray(mb.node_mask[0], bool)))
        cap = suggest_ship_rows_cap(counts, percentile=100.0, margin=1.25)
        return min(cap, layer_capacities(cfg)[0][0])

    # -- the synchronous loop ---------------------------------------------------
    def run_epoch(self) -> dict:
        """One synchronous epoch; returns the batch-weighted mean of the
        step metrics plus the epoch's throughput, traffic, host-runtime and
        sampling-service figures (the reference's keys)."""
        for s in self.samplers:
            s.reset_epoch()
        self.store.reset_stats()
        self._balancer = sched.LoadBalancer(self.num_devices,
                                            self.balance_policy)
        schedule = self.epoch_schedule()
        groups = list(sched.iterations(schedule))
        t0 = time.time()
        pstats = self._pstats = PipelineStats()
        # one unit per iteration group, tasks addressed by pure RNG
        # coordinates (partition, epoch, batch_index); a.device is the
        # scheduler's static target, the device a worker gathers for
        source = EpochSource(groups, self.samplers[0].epoch)
        if self.num_sampler_workers > 0:
            # stages 1 and 2b in the worker processes, payloads back in
            # submission order; the window bounds staged batches as the
            # prefetch depth bounds prepared groups
            core = SchedulingCore(
                pool=self._ensure_pool(),
                window=max(4 * self.num_sampler_workers,
                           (self.prefetch_depth + 1) * self.num_devices))
            items = self._timed_fetch(core.payload_stream(source))

            def prepare(item):
                return self._assemble_group(*item)
        else:
            items = source.units()

            def prepare(item):
                group, tasks = item
                return self._assemble_group(
                    group, [self._local_payload(t) for t in tasks])
        self._pool_stats0 = (dict(self._pool.stats)
                             if self._pool is not None else {})
        try:
            return self._run_epoch_loop(schedule, items, prepare, pstats, t0)
        except BaseException:
            # an abandoned epoch leaves in-flight pool tasks whose sequence
            # numbers would bleed into the next epoch's reorder stream
            self.close()
            raise

    def _timed_fetch(self, items):
        """``items``, timing each pull into ``_fetch_s``: with the pool,
        the seconds the consuming thread waits for a group's payloads and
        copies them (with their CRC check) out of the ring."""
        it = iter(items)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self._fetch_s += time.perf_counter() - t0
            yield item

    def _step_event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _run_epoch_loop(self, schedule, items, prepare, pstats, t0) -> dict:
        step_metrics: List[tuple] = []  # (metric dict, n_batches)
        vertices = n_batches = 0
        issue0, self._fetch_s = self._issue_s, 0.0
        if self.pipeline:
            prepared_iter = PrefetchExecutor(
                prepare, self.prefetch_depth, pstats).run(items)
            # at most prefetch_depth launched-but-unfinished steps, each
            # behind an event: a fast host would otherwise pile up live
            # batches on the card
            inflight: deque = deque()
            for prepared in prepared_iter:
                step_metrics.append((self._execute(prepared, sync=False),
                                     prepared["n_batches"]))
                inflight.append(self._step_event())
                if len(inflight) > self.prefetch_depth:
                    event = inflight.popleft()
                    if event is not None:
                        event.synchronize()
                vertices += prepared["vertices"]
                n_batches += prepared["n_batches"]
            if inflight and inflight[-1] is not None:
                inflight[-1].synchronize()  # one sync at the epoch's end
        else:
            for prepared in (prepare(it) for it in items):
                m = self._execute(prepared)
                vertices += m["vertices_traversed"]
                step_metrics.append((m, prepared["n_batches"]))
                n_batches += prepared["n_batches"]
        metrics: Dict[str, float] = {}
        if step_metrics:
            metrics = {k: sum(float(m[k]) * nb for m, nb in step_metrics)
                       / n_batches
                       for k in ("loss", "acc", "lr", "grad_norm")}
        wall = time.time() - t0
        stats = sched.schedule_stats(schedule, self.num_devices)
        n_iter = stats["iterations"]
        local_rows = sum(s.local_rows for s in self.store.stats)
        host_rows = sum(s.host_rows for s in self.store.stats)
        host_bytes = sum(s.host_bytes for s in self.store.stats)
        total_rows = local_rows + host_rows
        # this epoch's recovery actions: the supervisor's lifetime counters
        # minus the epoch-start snapshot
        pool = self._pool
        base = self._pool_stats0
        pstat = pool.stats if pool is not None else {}
        recov = {k: pstat.get(k, 0) - base.get(k, 0)
                 for k in ("respawns", "resubmissions", "speculative",
                           "duplicates_dropped", "stale_results",
                           "crc_failures", "degraded_tasks", "recovery_s")}
        return {**metrics, "epoch_time_s": wall, "batches": n_batches,
                "pool_respawns": recov["respawns"],
                "pool_resubmissions": recov["resubmissions"],
                "pool_speculative_hits": recov["duplicates_dropped"],
                "pool_speculative_launched": recov["speculative"],
                "pool_stale_results": recov["stale_results"],
                "pool_crc_failures": recov["crc_failures"],
                "pool_degraded_batches": recov["degraded_tasks"],
                "pool_recovery_s": recov["recovery_s"],
                "pool_degraded": pool.degraded if pool is not None
                else False,
                "iterations": n_iter,
                "utilization": stats["utilization"],
                "mesh_devices": self.num_devices if self.data_parallel else 0,
                "fill_slots": stats["fill_slots"],
                "vertices_traversed": vertices,
                "nvtps": vertices / wall if wall > 0 else 0.0,
                "beta": self.store.beta(),
                "pipeline": self.pipeline,
                "sampler_workers": self.num_sampler_workers,
                "balance_policy": self.balance_policy,
                "gather_in_workers": self.gather_in_workers,
                "load_imbalance": self._balancer.imbalance(),
                "host_produce_s": pstats.produce_s,
                "host_wait_s": pstats.wait_s,
                "host_gather_s": pstats.gather_s,
                "host_issue_s": self._issue_s - issue0,
                "host_fetch_s": self._fetch_s,
                "ring_bytes": pstats.ring_bytes,
                "ring_bytes_per_iter": (pstats.ring_bytes / n_iter
                                        if n_iter else 0.0),
                "cache_hit_rate": (local_rows / total_rows
                                   if total_rows else 1.0),
                "miss_bytes": host_bytes,
                "miss_bytes_per_iter": (host_bytes / n_iter
                                        if n_iter else 0.0)}

    def train(self, epochs: int = 1) -> List[dict]:
        return [self.run_epoch() for _ in range(epochs)]

    # -- lifecycle --------------------------------------------------------------
    def close(self) -> None:
        """Tear down the sampling service (worker processes and shared-
        memory segments). Idempotent; trainers without workers are
        no-ops."""
        if getattr(self, "_pool", None) is not None:
            self._pool.close()
            self._pool = None

    def __enter__(self) -> "SyncGNNTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

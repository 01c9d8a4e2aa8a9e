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
  4. one optimizer update: AdamW, or SGD with momentum under
     ``optimizer_name="sgdm"`` (``optim/adam.py``), over the reference's
     cosine schedule.

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

P3 (``algorithm="p3"``) partitions the topology by hash and the features
along their dimension: every device holds its slice of every row, so no
row misses (beta is 1). On the host-gather path each batch's block is the
full rows its p slices tile (``FeatureStore.gather_p3_full``, the
reference's non-mesh path); under ``data_parallel`` the (p, V, chunk)
slice matrix stays on the card and each slot's block is the concatenation
of every device's slice of its valid rows (``gnn.models.assemble_p3_feats``,
the reference's layer-1 all-to-all as an index on one card).

With ``mesh=`` (a ``DeviceMesh`` with a ``"data"`` axis of extent p, from
``distributed.sharding.make_data_mesh``; ``distributed.launch.
spawn_data_parallel`` starts the ranks) the p slots are p processes, as
the reference's ``shard_map`` step places slot d on mesh device d: rank d
holds only device d's shard (under P3 its slice), samples and uploads only
its slot's batch, and runs only its slot's loss and gradients. One
``all_gather`` brings every slot's ``[weight, loss, acc, gradients]`` to
every rank, and each rank combines them in slot order exactly as the
one-card path does, so every replica applies the same AdamW update to the
same bits. P3's layer-1 exchange is a real ``all_to_all``
(``gnn.models.p3_all_to_all_feats``). Every collective runs on the main
thread, in step order. An epoch's counters (vertices, the store's
accounting, ring bytes, the balancer's loads) are summed over the ranks at
the epoch's end, so every rank reports the one-card run's epoch. With
``grad_compression`` the combined gradient goes through int8 compression
with error feedback (``distributed.compression``) on either path, as in
the reference.

With ``cache_capacity`` (or ``CacheConfig(capacity=)``) the static
residency becomes the reference's frequency-driven cache
(``core/feature_cache.FeatureCache``; P3 builds none): each consumed real
batch's layer-0 ids are counted in consumption order, and every
``cache_refresh_every`` iterations (0: at each epoch's start) the
top-capacity rows replace every device's resident set under a new
generation, which the sampler pool's tasks are stamped with. Cached rows
are copies of host rows, so training is bitwise the cache-off run's;
only the accounting (hit rate, miss bytes) moves. Under ``data_parallel``
the cache refreshes at epoch boundaries only, and the next step re-uploads
the shards; under a mesh each rank counts its own slot's batch and the
ranks sum the epoch's counts, so every rank admits the one-process run's
set.

With a ``checkpointer`` (``checkpoint/checkpointing.Checkpointer``) and
``checkpoint_every=k``, every k-th iteration of an epoch is checkpointed
as in the reference: its assembly (on the prefetch thread when pipelined)
snapshots the host state (``_host_snapshot``: iteration counters, sampler
cursors, balancer loads and, with a cache, its counter, resident sets,
generation, pending ranking and counters), and the main thread saves it
with the parameters and optimizer state right after that iteration's
update. A killed run restores with ``restore_checkpoint()`` and finishes
with ``run_epoch(resume=True)``, bitwise the uninterrupted run. The
checkpoint's format is the reference's, so either package resumes the
other's. Under a mesh every rank saves at the same iteration: rank 0 the
arrays (replicated on every rank) and its manifest, each other rank its
own manifest (its host state is its slot's: balancer loads and the
cache's counts since the last sum over the ranks, kept under
``mesh_cache``), then the ranks meet at a barrier; every rank restores.
As in the reference, ``grad_compression``'s error feedback is not saved:
a resumed run with compression starts it from zero.

Host stages are bitwise copies of the reference's, so from one seed both
trainers sample the same batches and build the same layouts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.feature_cache import FeatureCache
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition import Partition, get_partitioner
from repro_torch.core.pipeline import PipelineStats, PrefetchExecutor
from repro_torch.core.sampler import (MiniBatch, NeighborSampler,
                                      layer_capacities)
from repro_torch.core.sampler_pool import SamplerPool, suggest_ship_rows_cap
from repro_torch.core.residency import GatherStats
from repro_torch.core.scheduling import (BatchTask, EpochSource,
                                         IterableSource, SchedulingCore)
from repro_torch.core.staging import StagingRing, UploadPack
from repro_torch.data.graphs import Graph
from repro_torch.device import resolve_device
from repro_torch.distributed import compression
from repro_torch.distributed.sharding import (all_gather_flat,
                                               require_data_axis)
from repro_torch.gnn import models as gnn_models
from repro_torch.kernels.layout import (BLK, EDGE_STREAM_BACKENDS,
                                        block_capacities, build_layer_layouts,
                                        compact_layout_bytes,
                                        dense_layout_bytes,
                                        densified_tile_bytes,
                                        edge_stream_layout_bytes)
from repro_torch.nn.param import (flatten, init_params, params_from_numpy,
                                  unflatten)
from repro_torch.optim.adam import SGDM, AdamW
from repro_torch.optim.schedules import get_schedule

ALGORITHMS = {
    # name: (partitioner, feature-storing strategy)
    "distdgl": ("metis_like", "distdgl"),
    "pagraph": ("pagraph", "pagraph"),
    "p3": ("p3", "p3"),
}


# the host-runtime fields that override model_cfg.host / model_cfg.fault
# when set (None inherits the config's value), as aggregate_backend does
HOST_KNOBS = ("num_sampler_workers", "balance_policy", "gather_in_workers",
              "worker_affinity")
FAULT_KNOBS = ("max_respawns", "straggler_timeout_s", "speculative_sampling",
               "fault_spec")
# the trainer fields that override model_cfg.cache: field -> CacheConfig's
CACHE_KNOBS = {"cache_capacity": "capacity",
               "cache_refresh_every": "refresh_every",
               "ship_rows_cap": "ship_rows_cap"}


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


def combine_slots(slots: torch.Tensor, leaves: List[torch.Tensor]):
    """The synchronous step's combine, from the (p, 3 + n) slot matrix
    whose row d is slot d's ``[weight, loss, acc, gradients in flatten
    order]``: (loss, acc, gradients shaped like ``leaves``), each the
    loss-weighted mean ``sum_d w_d x_d / max(sum_d w_d, 1)`` over the slots
    in slot order. The one-card path stacks its slots' rows and the mesh
    path all-gathers them, so both run this one function on the same bits
    and give the same bits."""
    w = slots[:, 0]
    w_sum = w.sum().clamp_min(1.0)
    loss = (slots[:, 1] * w).sum() / w_sum
    acc = (slots[:, 2] * w).sum() / w_sum
    flat = torch.tensordot(w, slots[:, 3:], dims=1) / w_sum
    grads = [g.view_as(p) for g, p in
             zip(flat.split([p.numel() for p in leaves]), leaves)]
    return loss, acc, grads


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
    # the sampling service (model_cfg.host), its fault tolerance
    # (model_cfg.fault) and the feature cache (model_cfg.cache): None
    # inherits the config's value, a value here overrides it
    num_sampler_workers: Optional[int] = None
    balance_policy: Optional[str] = None
    gather_in_workers: Optional[bool] = None
    worker_affinity: Optional[bool] = None
    max_respawns: Optional[int] = None
    straggler_timeout_s: Optional[float] = None
    speculative_sampling: Optional[bool] = None
    fault_spec: Optional[str] = None
    cache_capacity: Optional[int] = None
    cache_refresh_every: Optional[int] = None
    ship_rows_cap: Optional[int] = None
    # mid-epoch checkpoints: a checkpoint.checkpointing.Checkpointer and
    # the iterations of an epoch between two saves (0: none)
    checkpointer: Optional[object] = None
    checkpoint_every: int = 0
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
        cache = {c: getattr(self, k) for k, c in CACHE_KNOBS.items()
                 if getattr(self, k) is not None}
        self.model_cfg = dataclasses.replace(
            cfg, host=dataclasses.replace(cfg.host, **host),
            cache=dataclasses.replace(cfg.cache, **cache),
            fault=dataclasses.replace(cfg.fault, **fault))
        host = self.model_cfg.host
        self.num_sampler_workers = host.num_sampler_workers
        self.balance_policy = host.balance_policy
        self.gather_in_workers = (host.gather_in_workers
                                  and host.num_sampler_workers > 0)
        self.worker_affinity = host.worker_affinity
        self._check_ported()
        # the mesh: this process is the rank of one device slot, which
        # holds only that slot's shard (the reference's shard_map step)
        self._rank: Optional[int] = None
        self._group = None
        if self.mesh is not None:
            require_data_axis(self.mesh, self.num_devices)
            self.data_parallel = True
            self._rank = self.mesh.get_local_rank("data")
            self._group = self.mesh.get_group("data")
            if (self.device is None and self.mesh.device_type == "cuda"
                    and torch.cuda.is_available()):
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.device = resolve_device(self.device)
        if self.mesh is not None and self.device.type != self.mesh.device_type:
            raise ValueError(
                f"device {self.device} is not of the mesh's device type "
                f"{self.mesh.device_type!r}")
        part_name, store_name = ALGORITHMS[self.algorithm]
        self.partition: Partition = get_partitioner(part_name)(
            self.graph, self.num_devices, self.seed)
        self.store = FeatureStore(self.graph, self.partition, store_name)
        # the frequency-driven cache over the store's residency core (None:
        # the static partition; P3 has every row resident as a slice). It
        # reseeds the core before anything sizes a buffer from it: the
        # pool's shared segment (_ensure_pool) and the shard matrix
        self.cache: Optional[FeatureCache] = None
        ccfg = self.model_cfg.cache
        if ccfg.capacity is not None and self.algorithm != "p3":
            self.cache = FeatureCache(self.store.core,
                                      self.graph.out_degree(),
                                      ccfg.capacity, ccfg.refresh_every)
        if (self.data_parallel and self.cache is not None
                and ccfg.refresh_every > 0):
            raise ValueError(
                "mid-epoch cache refresh (cache_refresh_every > 0) is not "
                "supported under data_parallel: the device shards upload "
                "once per epoch. Use epoch-boundary refresh "
                "(cache_refresh_every=0) or the host gather.")
        self._iter_no = 0  # synchronous iterations assembled, over all epochs
        self._epoch_iter = 0  # iterations assembled in the current epoch
        # under a mesh: the cache's counts as of the last sum over the
        # ranks, and the iteration count then (_sum_counts_over_ranks)
        self._counts = (self.cache.freq.copy()
                        if self.cache is not None and self.mesh is not None
                        else None)
        self._counts_iter = 0
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
        schedule = get_schedule("cosine", self.lr, 10, 100_000)
        self.optimizer = (AdamW(schedule, weight_decay=0.0)
                          if self.optimizer_name == "adam"
                          else SGDM(schedule))
        self.opt_state = self.optimizer.init(flatten(self.params))
        self.step_no = 0  # optimizer steps taken: a checkpoint's step
        # the step metrics the epoch averages: loss, acc and the
        # optimizer's (SGDM reports no grad_norm)
        self._step_keys: tuple = ()
        self._err = None  # compression's error feedback, flatten order
        # static per-layer layout capacities: one shape per config
        self._blk_caps = (block_capacities(self.model_cfg)
                          if self._use_kernel_layout() else [])
        self._balancer = sched.LoadBalancer(self.num_devices,
                                            self.balance_policy)
        self._pstats = PipelineStats()
        self._pool: Optional[SamplerPool] = None
        self._pool_stats0: Dict[str, float] = {}
        # data_parallel: the (p, shard_rows, f) resident shards on the card
        # (under a mesh, this rank's (shard_rows, f) shard alone; uploaded
        # at the first step). At most _miss_cap rows miss a
        # batch: every layer-0 row in the worst case, unless ship_rows_cap
        # says fewer.
        self._shard: Optional[torch.Tensor] = None
        self._shard_gen = 0  # the residency generation the shard holds
        self._miss_cap = 0
        if self.data_parallel:
            cap = self.model_cfg.cache.ship_rows_cap
            self._miss_cap = (cap if cap is not None
                              else layer_capacities(self.model_cfg)[0][0])
        # every batch crosses the bus from a slot of the staging ring, in
        # one copy on the upload stream: a slot per batch of the groups
        # the prefetch queue holds, the one being filled and the one the
        # step is reading (a rank uploads one batch a group)
        self._upload_stream = (torch.cuda.Stream(self.device)
                               if self.device.type == "cuda" else None)
        per_group = 1 if self.mesh is not None else self.num_devices
        self._ring = StagingRing((self.prefetch_depth + 2) * per_group,
                                 self.device)
        # main-thread seconds spent launching device steps (up to the last
        # launch, before any metric is read): what a producer thread that
        # holds the GIL takes from the step; and the epoch's seconds
        # pulling payloads from the sampler pool (_timed_fetch)
        self._issue_s = 0.0
        self._fetch_s = 0.0

    def _check_ported(self) -> None:
        cfg = self.model_cfg
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; "
                             f"expected one of {tuple(ALGORITHMS)}")
        if cfg.name not in gnn_models.MODELS:
            raise ValueError(f"unknown model {cfg.name!r}; expected one of "
                             f"{gnn_models.MODELS}")
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
        if cfg.cache.refresh_every < 0:
            raise ValueError("cache_refresh_every must be >= 0")
        if cfg.cache.ship_rows_cap is not None and cfg.cache.ship_rows_cap < 1:
            raise ValueError("ship_rows_cap must be >= 1")

    def _train_ids(self, i: int) -> np.ndarray:
        mask = self.partition.assignment[self.graph.train_ids] == i
        ids = self.graph.train_ids[mask]
        return ids if len(ids) else self.graph.train_ids[:1]

    def epoch_schedule(self, counts: Optional[List[int]] = None
                       ) -> List[sched.Assignment]:
        """The schedule of ``counts`` batches a partition (default: each
        sampler's remaining batches) under the balancing policy."""
        if counts is None:
            counts = [s.batches_remaining() for s in self.samplers]
        fn = (sched.two_stage_schedule if self.workload_balancing
              else sched.naive_schedule)
        return fn(counts)

    def _use_kernel_layout(self) -> bool:
        """A kernel backend and a model whose aggregation it can run (GAT's
        weights are computed on the device: no layout, no kernel)."""
        return (self.model_cfg.aggregate_backend
                in gnn_models.KERNEL_BACKENDS
                and gnn_models.AGG_KIND[self.model_cfg.name] is not None)

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
        in index order) plus stage 2b (the layout build), each timed. A
        rank of a mesh samples only some of the batches, so it addresses
        each by ``batch_at``."""
        t0 = time.perf_counter()
        sampler = self.samplers[task.partition]
        mb = (sampler.batch_at(task.epoch, task.index)
              if self.mesh is not None else sampler.next_batch())
        t1 = time.perf_counter()
        layout = (build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                                      self._blk_caps,
                                      gnn_models.AGG_KIND[self.model_cfg.name],
                                      edge_stream=self._edge_stream())
                  if self._blk_caps else None)
        return {"minibatch": mb, "layout": layout,
                "load": mb.work_estimate(), "sample_s": t1 - t0,
                "layout_s": time.perf_counter() - t1}

    def _task(self, a: sched.Assignment) -> BatchTask:
        return BatchTask(a.partition, self.samplers[a.partition].epoch,
                         a.batch_index, a.device)

    def _sample_payload(self, a: sched.Assignment) -> dict:
        """In-process twin of one SamplerPool task for assignment ``a``."""
        return self._local_payload(self._task(a))

    def _rank_indices(self, group: List[sched.Assignment]) -> List[int]:
        """Under a mesh, the indices into ``group`` of the batches this
        rank samples: under ``"load"`` every one (the balancer needs each
        batch's load), under ``"round_robin"`` the one the schedule places
        on this rank or, when none is, the group's last, which this rank
        runs as its slot's weight-0 fill."""
        if self.balance_policy == "load":
            return list(range(len(group)))
        mine = [j for j, a in enumerate(group) if a.device == self._rank]
        return mine or [len(group) - 1]

    def _rank_slot(self, group: List[sched.Assignment],
                   payloads: List[dict]) -> tuple:
        """Under a mesh, this rank's slot of the group from the payloads of
        ``_rank_indices(group)``: (device, payload, weight) of the batch
        the balancer places on this rank, or, when none lands here, of the
        group's last real batch at weight 0 with the device it was placed
        on — the one-card path's fill, whose payload this rank assembles
        against its own shard as that path does. The balancer sees only
        real batches placed here (``"load"``: every batch, on every
        rank)."""
        sub = [group[j] for j in self._rank_indices(group)]
        loads = [self._batch_load(a, p) for a, p in zip(sub, payloads)]
        if self.balance_policy == "load" or sub[0].device == self._rank:
            devices = self._balancer.assign(sub, loads)
        else:
            devices = [sub[0].device]
        if self._rank in devices:
            j = devices.index(self._rank)
            return self._rank, payloads[j], 1.0
        return devices[-1], payloads[-1], 0.0

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
        if self.algorithm == "p3":
            miss = 0  # every row resident (sliced): nothing crosses
        elif fpay is not None and fpay["device"] == a.device:
            miss = len(fpay["pos"])
        else:
            mb = payload["minibatch"]
            miss = self.store.core.miss_count(a.device, mb.nodes[0],
                                              mb.node_mask[0])
        return sched.LoadBalancer.batch_load(
            payload["load"], miss, self.graph.features.shape[1])

    def _batch_features(self, dev: int, payload: dict) -> np.ndarray:
        """Stage 2 on the host-gather path: the in-process gather (under P3
        the full rows of ``gather_p3_full``), or — when the payload carries
        worker-gathered rows — their placement
        (``FeatureStore.place_gathered``). Timed into ``gather_s``."""
        mb = payload["minibatch"]
        t0 = time.perf_counter()
        fpay = payload.get("features")
        p3 = self.algorithm == "p3"
        if fpay is not None:
            feats = self.store.place_gathered(
                dev, mb.nodes[0], mb.node_mask[0], fpay["pos"], fpay["rows"],
                p3_full=p3, shipped_for=fpay["device"])
        elif p3:
            feats = self.store.gather_p3_full(mb.nodes[0], mb.node_mask[0])
        else:
            feats = self.store.gather(dev, mb.nodes[0], mb.node_mask[0])
        self._pstats.gather_s += time.perf_counter() - t0
        self._pstats.ring_bytes += payload.get("ring_bytes", 0)
        return feats

    def _resident_payload(self, dev: int, payload: dict,
                          pack: UploadPack, account: bool = True) -> int:
        """Stage 2 under ``data_parallel`` (the reference's
        ``_batch_mesh_payload``): in place of the (N_0, f) block, the
        batch's hit rows and their positions in device ``dev``'s shard
        (``resident_payload``) and its miss rows go into ``pack``. The miss
        rows are the worker's (``gather_in_workers``) when it gathered for
        ``dev``, else gathered here, straight into the staging slot.
        Accounting equals ``FeatureStore.gather``'s. Under P3 every valid
        row is a hit (pos = id): no miss row ships (a worker's full rows are
        not needed) and the accounting is ``gather_p3_full``'s. A mesh
        rank's fill (``account=False``) ships the same payload and adds
        nothing to the accounting. Returns the miss count."""
        mb = payload["minibatch"]
        t0 = time.perf_counter()
        ids = np.asarray(mb.nodes[0])
        valid = np.asarray(mb.node_mask[0], bool)
        idx = resident_payload(self.store.core, dev, ids, valid)
        ring_bytes = payload.get("ring_bytes", 0) if account else 0
        if self.algorithm == "p3":
            if account:
                self.store.account_p3_full(int(valid.sum()))
            pack.add("hit_idx", idx["hit_idx"])
            pack.add("hit_pos", idx["hit_pos"])
            self._pstats.gather_s += time.perf_counter() - t0
            self._pstats.ring_bytes += ring_bytes
            return 0
        fpay = payload.get("features")
        shipped = fpay is not None and fpay["device"] == dev
        if shipped:
            idx["miss_pos"] = fpay["pos"].astype(np.int64)
        mpos = idx["miss_pos"]
        n_miss = len(mpos)
        if account:
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
        self._pstats.ring_bytes += ring_bytes
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
        empty slots repeat the last real batch at weight 0. Under a mesh
        ``payloads`` are those of ``_rank_indices(assignments)`` and only
        this rank's slot is built (``_rank_slot``). All copies run on the
        upload stream and the group records one event after them; no
        kernel is launched here. With a cache, the group's real batches
        are then counted (``_observe``)."""
        gather0, fill0 = self._pstats.gather_s, self._ring.fill_s
        stage_s = {"sample_s": sum(p.get("sample_s", 0.0) for p in payloads),
                   "layout_s": sum(p.get("layout_s", 0.0) for p in payloads),
                   "gather_s": 0.0, "upload_s": 0.0}
        if self.data_parallel:
            stage_s["miss_rows"] = 0
        t_start = time.perf_counter()
        if self.mesh is not None:
            placed = [self._rank_slot(assignments, payloads)]
        else:
            loads = [self._batch_load(a, p)
                     for a, p in zip(assignments, payloads)]
            placed = [(dev, payload, 1.0) for dev, payload in zip(
                self._balancer.assign(assignments, loads), payloads)]
        vertices = 0
        slots: List[Optional[dict]] = [None] * self.num_devices
        order: List[dict] = []
        uploaded: List[torch.Tensor] = []
        event = None
        with (torch.cuda.stream(self._upload_stream)
              if self._upload_stream is not None
              else contextlib.nullcontext()):
            for dev, payload, weight in placed:
                mb = payload["minibatch"]
                if weight:
                    vertices += mb.vertices_traversed()
                pack = UploadPack()
                if self.data_parallel:
                    feats = None
                    stage_s["miss_rows"] += self._resident_payload(
                        dev, payload, pack, account=weight > 0)
                else:
                    feats = self._batch_features(dev, payload)
                for k, v in batch_host_arrays(mb, feats,
                                              payload["layout"]).items():
                    pack.add(k, v)
                arrs, base = self._ring.upload(pack)
                arrs["weight"] = weight
                uploaded.append(base)
                slots[dev] = arrs
                order.append(arrs)
            if self._upload_stream is not None:
                event = torch.cuda.Event()
                event.record(self._upload_stream)
        self._observe(placed)
        # the miss rows gathered straight into their slots count as gather
        self._pstats.gather_s += self._ring.fill_s - fill0
        stage_s["gather_s"] = self._pstats.gather_s - gather0
        stage_s["upload_s"] = (time.perf_counter() - t_start
                               - stage_s["gather_s"])
        if self.mesh is not None:
            batches = order
        elif self.balance_policy == "round_robin" and not self.data_parallel:
            batches = order
            while len(batches) < self.num_devices:
                batches.append(dict(batches[-1], weight=0.0))
        else:
            batches = [b if b is not None else dict(order[-1], weight=0.0)
                       for b in slots]
        out = {"batches": batches, "vertices": vertices,
               "n_batches": len(assignments), "stage_s": stage_s,
               "event": event, "uploaded": uploaded}
        if (self.checkpointer is not None and self.checkpoint_every > 0
                and self._epoch_iter % self.checkpoint_every == 0):
            # the host state as of this assembly, which leads the
            # parameters: the main thread saves it right after this same
            # iteration's update
            out["host_ckpt"] = self._host_snapshot()
        return out

    def _observe(self, placed: List[tuple]) -> None:
        """Once an iteration's payloads are consumed: fold each real
        batch's layer-0 ids into the cache's counter in consumption order
        (fills, at weight 0, are not counted), then run the cache's
        iteration hook, which at ``(iter+1) % K == 0`` installs the
        generation that iteration ``iter+1``'s tasks were stamped with
        (``_task_gen``). Under a mesh ``placed`` is this rank's slot alone:
        the ranks sum their counts at the epoch's end
        (``_sum_counts_over_ranks``). On the prefetch thread when
        pipelined, as in the reference."""
        if self.cache is not None:
            for _, payload, weight in placed:
                if weight:
                    mb = payload["minibatch"]
                    self.cache.observe(mb.nodes[0], mb.node_mask[0])
            self.cache.end_iteration(self._iter_no)
        self._iter_no += 1
        self._epoch_iter += 1

    def _prepare_group(self, assignments: List[sched.Assignment]) -> dict:
        """Stages 1, 2b and 2 and the upload for one synchronous iteration,
        sampled in-process (under a mesh, the batches this rank needs)."""
        tasks = [self._task(a) for a in assignments]
        if self.mesh is not None:
            tasks = [tasks[j] for j in self._rank_indices(assignments)]
        return self._assemble_group(
            assignments, [self._local_payload(t) for t in tasks])

    # -- stage 3: the device step -------------------------------------------------
    def _slot_feats(self, b: dict, d: int) -> torch.Tensor:
        """Slot ``d``'s layer-0 block, assembled where the shard lives:
        from device d's shard, or under P3 from every device's slice of
        the batch's rows (on one card an index, under a mesh the
        all-to-all among the ranks)."""
        f = self.graph.features.shape[1]
        if self.algorithm == "p3" and self.mesh is not None:
            return gnn_models.p3_all_to_all_feats(self._shard, b, f,
                                                  self._group)
        if self.algorithm == "p3":
            return gnn_models.assemble_p3_feats(self._shard, b, f)
        return gnn_models.assemble_device_feats(
            self._shard if self.mesh is not None else self._shard[d], b)

    def _slot_row(self, leaves: List[torch.Tensor], b: dict,
                  d: int) -> torch.Tensor:
        """Slot ``d``'s row of the combine: ``[weight, loss, acc,
        gradients in flatten order]``, fp32. Its (N_0, f) block lives only
        inside this call."""
        if self.data_parallel:
            b = dict(b, feats=self._slot_feats(b, d))
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss, m = gnn_models.loss_fn(self.model_cfg,
                                     unflatten(self.params, ps), b)
        grads = torch.autograd.grad(loss, ps)
        # the weight is written on the device (no copy from pageable host
        # memory, which would wait for the stream's earlier work)
        w = torch.full((1,), float(b["weight"]), device=self.device)
        return torch.cat([w, loss.detach().reshape(1), m["acc"].reshape(1),
                          *(g.reshape(-1) for g in grads)])

    def _grads(self, batches: List[dict]):
        """Per-slot loss and gradients, combined by loss weight
        (``combine_slots``): returns (loss, acc, grads in ``flatten``
        order). Under a mesh ``batches`` is this rank's slot alone, and one
        ``all_gather`` of the slots' rows, p x (3 + parameter count) x 4
        bytes, brings every slot to every rank."""
        leaves = flatten(self.params)
        if self.mesh is None:
            rows = torch.stack([self._slot_row(leaves, b, d)
                                for d, b in enumerate(batches)])
        else:
            mine = self._slot_row(leaves, batches[0], self._rank)
            rows = mine.new_empty((self.num_devices, mine.numel()))
            all_gather_flat(rows.view(-1), mine, group=self._group)
        return combine_slots(rows, leaves)

    def _upload_shards(self) -> float:
        """Build every device's resident feature block and put it on the
        card from pinned memory, where it stays until a cache refresh
        changes the residency (the reference's ``_upload_shards``):
        (p, shard_rows, f), or under P3 the (p, V, chunk) slice matrix;
        under a mesh only this rank's row of it. Returns its seconds: the
        build, the pinning and the copy. Runs on the main thread before
        the first step and before the first step of an epoch whose
        refresh changed the residency; the previous shard is dropped
        first, after the previous epoch's steps were waited for."""
        t0 = time.perf_counter()
        self._shard = None
        self._shard_gen = self.store.core.generation
        if self.mesh is not None:
            mat = torch.from_numpy(
                self.store.build_shard_matrix([self._rank])[0])
        else:
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
            # a cache refresh at the epoch's start changes the residency
            # (under data_parallel only there): re-upload before its first
            # step
            stale = (self._shard is None
                     or self._shard_gen != self.store.core.generation)
            shard_s = self._upload_shards() if stale else 0.0
        t0 = time.perf_counter()
        loss, acc, grads = self._grads(self._receive(prepared))
        if self.grad_compression:
            payload, self._err = compression.compress_tree(grads, self._err)
            grads = compression.decompress_tree(payload)
        new_leaves, self.opt_state, om = self.optimizer.update(
            grads, self.opt_state, flatten(self.params))
        self.params = unflatten(self.params, new_leaves)
        self.step_no += 1
        self._issue_s += time.perf_counter() - t0
        metrics = {"loss": loss, "acc": acc, **om}
        self._step_keys = tuple(metrics)
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
        """One synchronous iteration: loss, acc, lr, grad_norm (AdamW's),
        vertices
        traversed, and the seconds of each stage (sample, layout, gather,
        upload — the host's share of the copies, which run asynchronously
        — and the device step up to its metrics being read); under
        ``data_parallel`` also the miss rows shipped (``miss_rows``) and
        the seconds of the shard upload (``shard_upload_s``, 0 but on the
        first step and the first after a cache refresh)."""
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
                p3_full=self.algorithm == "p3",
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
        device counted (every valid row under P3, whose workers ship the
        full rows), and the slot sized by ``suggest_ship_rows_cap``
        (the largest count plus 25%, at most the layer-0 node cap). A batch
        that outgrows it fails in ``PayloadCodec.encode`` naming the
        knob."""
        cfg = self.model_cfg
        if cfg.cache.ship_rows_cap is not None:
            return cfg.cache.ship_rows_cap
        if not self.gather_in_workers or not cfg.cache.auto_ship_rows_cap:
            return None
        schedule = self.epoch_schedule(
            [s.epoch_batches() for s in self.samplers])
        counts = []
        epoch0 = self.samplers[0].epoch
        for epoch in range(epoch0, epoch0 + 3):
            for a in schedule:
                mb = self.samplers[a.partition].batch_at(epoch,
                                                         a.batch_index)
                valid = np.asarray(mb.node_mask[0], bool)
                if self.algorithm == "p3":
                    counts.append(int(valid.sum()))
                else:
                    counts.append(self.store.core.miss_count(
                        a.device, np.asarray(mb.nodes[0]), valid))
        cap = suggest_ship_rows_cap(counts, percentile=100.0, margin=1.25)
        return min(cap, layer_capacities(cfg)[0][0])

    def _task_gen(self, global_iter: int) -> int:
        """The cache generation the batches of synchronous iteration
        ``global_iter`` are gathered against (the reference's stamp): 0
        without a cache (the residency never changes); ``global_iter // K``
        with refresh every K iterations, installed at the end of iteration
        ``global_iter // K * K - 1``'s assembly, after every payload of the
        previous generation was consumed; the current generation, constant
        within the epoch, with epoch-boundary refresh."""
        if self.cache is None:
            return 0
        K = self.model_cfg.cache.refresh_every
        return global_iter // K if K > 0 else self.cache.generation

    # -- the synchronous loop ---------------------------------------------------
    def run_epoch(self, resume: bool = False) -> dict:
        """One synchronous epoch; returns the batch-weighted mean of the
        step metrics plus the epoch's throughput, traffic, host-runtime,
        sampling-service and cache figures (the reference's keys).
        ``resume=True`` finishes the epoch a restored checkpoint
        interrupted (``restore_checkpoint``): the sampler cursors, balancer
        loads and cache state are already the mid-epoch values, so their
        resets are skipped, the whole epoch's schedule is rebuilt from the
        cursor-independent batch counts, and its first ``_epoch_iter``
        groups, run before the kill, are skipped."""
        if not resume:
            for s in self.samplers:
                s.reset_epoch()
            self._epoch_iter = 0
        # per-epoch accounting, then the cache's epoch hook (its counters'
        # reset and, at K = 0, the refresh), both before any task is
        # submitted, so tasks stamp the refreshed generation; under
        # data_parallel a refresh (or a restore) re-uploads the shards
        # before the first step (_execute)
        self.store.reset_stats()
        if self.cache is not None and not resume:
            self._sum_counts_over_ranks()
            self.cache.start_epoch()
        if not resume:
            self._balancer = sched.LoadBalancer(self.num_devices,
                                                self.balance_policy)
        # the whole epoch's schedule, from the cursor-independent counts
        # (after reset_epoch they equal the remaining batches)
        schedule = self.epoch_schedule(
            [s.epoch_batches() for s in self.samplers])
        groups = list(sched.iterations(schedule))
        if resume:
            groups = groups[self._epoch_iter:]
        t0 = time.time()
        pstats = self._pstats = PipelineStats()
        # one unit per iteration group, tasks addressed by pure RNG
        # coordinates (partition, epoch, batch_index); a.device is the
        # scheduler's static target, the device a worker gathers for, and
        # the stamp the cache generation it gathers against
        base = self._iter_no
        source = EpochSource(groups, self.samplers[0].epoch,
                             gen_for_group=lambda gi: self._task_gen(
                                 base + gi))
        if self.mesh is not None:
            # a rank samples (in-process or in its pool) only what it
            # needs; the tasks keep their stamps
            source = IterableSource(
                (g, [tasks[j] for j in self._rank_indices(g)])
                for g, tasks in source.units())
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
                if "host_ckpt" in prepared:
                    # the parameters hold this iteration's update (queued
                    # on the card: the snapshot's copies are queued behind
                    # it), matching the host state of its assembly
                    self._save_checkpoint(prepared["host_ckpt"])
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
                if "host_ckpt" in prepared:
                    self._save_checkpoint(prepared["host_ckpt"])
                n_batches += prepared["n_batches"]
        metrics: Dict[str, float] = {}
        if step_metrics:
            metrics = {k: sum(float(m[k]) * nb for m, nb in step_metrics)
                       / n_batches
                       for k in self._step_keys}
        wall = time.time() - t0
        if self.mesh is not None:
            vertices, wall = self._sum_over_ranks(vertices, wall, pstats)
        stats = sched.schedule_stats(schedule, self.num_devices)
        n_iter = stats["iterations"]
        cache = self.cache
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
                                        if n_iter else 0.0),
                # every process applies each admitted set to every
                # device's residency: whole on each rank, never summed
                "cache_enabled": cache is not None,
                "cache_admissions": cache.admissions_epoch if cache else 0,
                "cache_evictions": cache.evictions_epoch if cache else 0,
                "cache_refresh_bytes": (cache.refresh_bytes_epoch if cache
                                        else 0)}

    def _sum_over_ranks(self, vertices: int, wall: float,
                        pstats: PipelineStats) -> tuple:
        """Under a mesh, at the epoch's end: one ``all_reduce`` (sum) of
        this rank's counters — its slots' vertices, ring bytes and store
        accounting, its device's balancer load (each rank counted only
        its own slot's batches) and, from rank 0 alone, the wall time —
        after which every rank holds the one-card epoch's counters, and
        the cache's access counts (``_sum_counts_over_ranks``). Returns
        (vertices, rank 0's wall seconds)."""
        fields = [f.name for f in dataclasses.fields(GatherStats)]
        own = [self._balancer.load[d] if d == self._rank else 0.0
               for d in range(self.num_devices)]
        vals = [vertices, pstats.ring_bytes,
                wall if self._rank == 0 else 0.0, *own,
                *(getattr(st, f) for st in self.store.stats for f in fields)]
        # float64 holds every count below 2^53 exactly
        t = torch.tensor(vals, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=self._group)
        vals = t.tolist()
        p = self.num_devices
        pstats.ring_bytes = int(vals[1])
        self._balancer.load = vals[3:3 + p]
        it = iter(vals[3 + p:])
        for st in self.store.stats:
            for f in fields:
                setattr(st, f, int(next(it)))
        self._sum_counts_over_ranks()
        return int(vals[0]), vals[2]

    def _sum_counts_over_ranks(self) -> None:
        """Under a mesh with a cache: one ``all_reduce`` (sum) of the
        int64 access counts this rank added since the last call (V x 8
        bytes). A rank counts only its own slot's batches, and integer
        sums are exact in any order, so afterwards every rank's counter is
        the one-card run's and every refresh admits its set. Runs at each
        epoch's end and, for counts ``run_iteration`` added since, before
        the next epoch's refresh; every rank calls it alike (the condition
        is the iteration count, the same on each)."""
        if (self.mesh is None or self.cache is None
                or self._iter_no == self._counts_iter):
            return
        delta = torch.from_numpy(self.cache.freq - self._counts).to(
            self.device)
        dist.all_reduce(delta, group=self._group)
        self.cache.freq = self._counts + delta.cpu().numpy()
        self._counts = self.cache.freq.copy()
        self._counts_iter = self._iter_no

    def train(self, epochs: int = 1) -> List[dict]:
        return [self.run_epoch() for _ in range(epochs)]

    # -- mid-epoch checkpoint and resume ----------------------------------------
    def _opt_tree(self) -> dict:
        """The optimizer state as the reference's tree: each moment list
        (flatten order) as a tree shaped like the parameters, the step a
        0-d int32."""
        tree = {k: unflatten(self.params, v)
                for k, v in self.opt_state.items() if k != "step"}
        tree["step"] = np.int32(self.opt_state["step"])
        return tree

    def _host_snapshot(self) -> dict:
        """JSON-serializable host state as of the just-assembled iteration
        (the reference's keys): the global and epoch iteration counters,
        each sampler's cursor, the balancer's loads and, with a cache, its
        counter, the resident ids of every device that is not
        all-resident, the generation, the pending ranking's result and
        the seven counters; under a mesh with a cache also the counts as
        of the last sum over the ranks (``mesh_cache``, a key the
        reference ignores). Runs where the iteration was assembled (the
        prefetch thread when pipelined), one assembly ahead of the
        parameters."""
        snap: dict = {"iter_no": self._iter_no,
                      "epoch_iter": self._epoch_iter,
                      "samplers": [s.state() for s in self.samplers],
                      "balancer_load": [float(x)
                                        for x in self._balancer.load]}
        c = self.cache
        if c is not None:
            pending = None
            if c._pending is not None:
                gen, t, holder = c._pending
                # the ranking is fixed by the counter's copy taken at its
                # launch: joining here moves only its timing
                t.join()
                pending = {"gen": int(gen), "ids": holder[0].tolist()}
            resident = {str(d): c.core.resident_ids(d).tolist()
                        for d in range(c.core.num_devices)
                        if not c.core._all_resident[d]}
            snap["cache"] = {
                "freq": c.freq.tolist(),
                "epochs_run": c._epochs_run,
                "generation": int(c.generation),
                "resident": resident,
                "pending": pending,
                "counters": [c.admissions_total, c.evictions_total,
                             c.refresh_bytes_total, c.refreshes,
                             c.admissions_epoch, c.evictions_epoch,
                             c.refresh_bytes_epoch]}
            if self._counts is not None:
                snap["mesh_cache"] = {"counts": self._counts.tolist(),
                                      "counts_iter": self._counts_iter}
        return snap

    def _save_checkpoint(self, host_ckpt: dict) -> None:
        """Save this step's parameters and optimizer state with the host
        state of its assembly. Under a mesh every rank saves (rank 0 the
        arrays, each rank its manifest), waits for its write and meets the
        others at a barrier: no rank goes on while a rank's files of this
        step are half-written, so the ranks' newest complete steps are at
        most one save apart (``restore_checkpoint`` takes the older)."""
        if self.mesh is None:
            self.checkpointer.save(self.step_no, self.params,
                                   self._opt_tree(), extra=host_ckpt)
            return
        self.checkpointer.save(self.step_no, self.params, self._opt_tree(),
                               extra=host_ckpt, blocking=True,
                               rank=self._rank)
        dist.barrier(group=self._group)

    def _over_ranks(self, step: int) -> tuple:
        """Under a mesh: (min, max) of ``step`` over the ranks."""
        t = torch.tensor([step, -step], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        return -int(t[1]), int(t[0])

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Restore the parameters, the optimizer state and the host state
        from the newest (or the given) verified checkpoint into this
        trainer, built with the killed run's arguments; then
        ``run_epoch(resume=True)`` finishes the interrupted epoch, and the
        run's final parameters are bitwise the uninterrupted run's. Under
        a mesh each rank restores its own manifest, every rank the same
        step (without ``step``, the newest that verifies at every rank;
        ranks that restore different steps raise). The resident shards
        upload again before the first resumed step, and a restored cache
        generation reaches the sampler pool's shared segment before any
        task is submitted. Returns the restored step."""
        if self.checkpointer is None:
            raise RuntimeError("trainer has no checkpointer")
        rank = self._rank or 0
        if step is None:
            step = self.checkpointer.latest_step(rank)
            if self.mesh is not None:
                # the newest step that verifies at every rank (a kill
                # during a save can leave one rank's files of it torn)
                step = self._over_ranks(-1 if step is None else step)[0]
                step = None if step < 0 else step
            if step is None:
                raise FileNotFoundError("no valid checkpoint to restore")
        out = self.checkpointer.restore(step, self.params, self._opt_tree(),
                                        rank=rank)
        if self.mesh is not None:
            lo, hi = self._over_ranks(int(out["step"]))
            if lo != hi:
                raise RuntimeError(
                    f"the ranks restored different steps ({lo} to {hi}): "
                    f"a rank's checkpoint of step {step} does not verify")
        self.params = out["params"]
        self.opt_state = {k: (int(v) if k == "step" else flatten(v))
                          for k, v in out["opt"].items()}
        self.step_no = int(out["step"])
        extra = out["extra"]
        self._iter_no = int(extra["iter_no"])
        self._epoch_iter = int(extra["epoch_iter"])
        for s, st in zip(self.samplers, extra["samplers"]):
            s.restore_state(st)
        self._balancer = sched.LoadBalancer(self.num_devices,
                                            self.balance_policy)
        self._balancer.load = [float(x) for x in extra["balancer_load"]]
        # the shard is rebuilt from the restored residency before the
        # first resumed step: its generation alone could match by chance
        self._shard = None
        cstate = extra.get("cache")
        if self.cache is not None and cstate is not None:
            c = self.cache
            c.freq[:] = np.asarray(cstate["freq"], np.int64)
            c._epochs_run = int(cstate["epochs_run"])
            (c.admissions_total, c.evictions_total, c.refresh_bytes_total,
             c.refreshes, c.admissions_epoch, c.evictions_epoch,
             c.refresh_bytes_epoch) = cstate["counters"]
            for d_str, ids in cstate["resident"].items():
                c.core.set_resident(int(d_str), np.asarray(ids, np.int32))
            # written through to a live pool's shared segment, stamp last
            c.core.publish_generation(int(cstate["generation"]))
            if c._pending is not None:  # drop any stale in-flight ranking
                _, t, _ = c._pending
                c._pending = None
                t.join()
            p = cstate.get("pending")
            if p is not None:
                # the checkpoint holds the ranking's result: a finished
                # thread and a filled holder make the install identical
                holder = [np.asarray(p["ids"], np.int32)]
                t = threading.Thread(target=lambda: None,
                                     name="hitgnn-cache-refresh")
                t.start()
                c._pending = (int(p["gen"]), t, holder)
            mc = extra.get("mesh_cache")
            if self._counts is not None and mc is not None:
                self._counts = np.asarray(mc["counts"], np.int64)
                self._counts_iter = int(mc["counts_iter"])
        return int(out["step"])

    # -- lifecycle --------------------------------------------------------------
    def close(self) -> None:
        """Tear down the sampling service (worker processes and shared-
        memory segments) and join any ranking thread of the cache without
        installing its set. Idempotent; trainers without workers or cache
        are no-ops."""
        if getattr(self, "_pool", None) is not None:
            self._pool.close()
            self._pool = None
        if getattr(self, "cache", None) is not None:
            self.cache.close()

    def __enter__(self) -> "SyncGNNTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""Synchronous GNN trainer on one card (counterpart of
``repro.core.trainer.SyncGNNTrainer``, sequential single-device path).

Per synchronous iteration (paper Fig. 2 / Alg. 2 + gradient sync):
  1. the two-stage scheduler picks p mini-batches, one per simulated device;
  2. the host samples each batch in-process, builds each layer's layout
     under a kernel ``aggregate_backend`` (the compact triples for
     "pallas", the edge segments for "pallas_edges" and "pallas_fused")
     and gathers its feature rows through the FeatureStore (beta
     accounting);
  3. the batches move to the card, and the step takes each batch's loss and
     gradients in turn (a Python loop in place of the reference's ``vmap``)
     and combines them as ``sum_b w_b g_b / max(sum_b w_b, 1)``: idle-device
     fill batches carry weight 0 and contribute nothing;
  4. one AdamW update.

Under ``data_parallel=True`` (the reference's mesh dataflow, with all p
simulated devices on the one card) step 2 gathers no feature block: every
device's resident rows live on the card for the trainer's life
(``FeatureStore.build_shard_matrix``, uploaded once at the first step),
each batch ships its shard positions and exactly its miss rows (through a
pinned staging buffer), and step 3 assembles each batch's layer-0 block on
the card just before its loss (``gnn.models.assemble_device_feats``).

Host stages are bitwise copies of the reference's, so from one seed both
trainers sample the same batches and build the same layouts. Knobs the port
does not run yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.gnn import (CacheConfig, FaultConfig, GNNModelConfig,
                                     HostConfig)
from repro_torch.core import scheduler as sched
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition import Partition, get_partitioner
from repro_torch.core.sampler import (MiniBatch, NeighborSampler,
                                      layer_capacities)
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

def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def batch_to_arrays(mb: MiniBatch, feats: Optional[np.ndarray], device,
                    layout: Optional[dict] = None) -> dict:
    """One mini-batch (+ its layer-0 features, unless ``feats`` is None,
    and, for the kernel path, its edge-segment layout) as a dict of tensors
    on ``device``. ``weight`` is the batch's loss weight in the synchronous
    step (fill batches get 0)."""
    out = {
        "edge_src": [_to_device(a, device) for a in mb.edge_src],
        "edge_dst": [_to_device(a, device) for a in mb.edge_dst],
        "edge_mask": [_to_device(a, device) for a in mb.edge_mask],
        "node_mask": [_to_device(a, device) for a in mb.node_mask],
        "self_idx": [_to_device(a, device) for a in mb.self_idx],
        "labels": _to_device(np.asarray(mb.labels, np.int32), device),
        "weight": 1.0,
    }
    if feats is not None:
        out["feats"] = _to_device(np.asarray(feats, np.float32), device)
    for k, arrs in (layout or {}).items():
        out[k] = [_to_device(a, device) for a in arrs]
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
    # the reference overlaps host stages with the device step by default;
    # the port runs them in sequence and takes pipeline=False
    pipeline: bool = False
    aggregate_backend: Optional[str] = None  # overrides model_cfg when set
    num_sampler_workers: Optional[int] = None
    balance_policy: Optional[str] = None
    cache_capacity: Optional[int] = None
    checkpointer: Optional[object] = None
    # "cuda" when None; "cpu" runs the plain PyTorch path
    device: Optional[str] = None
    # initial parameters as numpy ({"layers": [{name: array}]}), e.g. the
    # reference's materialize(spec, PRNGKey(seed)); None = the port's own
    # seeded init
    params: Optional[dict] = None

    def __post_init__(self):
        if self.aggregate_backend is not None:
            self.model_cfg = dataclasses.replace(
                self.model_cfg, aggregate_backend=self.aggregate_backend)
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
        self._balancer = sched.LoadBalancer(self.num_devices)
        # data_parallel: the (p, shard_rows, f) resident shards on the card
        # (uploaded at the first step) and the pinned staging buffer the
        # miss rows cross the bus from. At most _miss_cap rows miss a batch:
        # every layer-0 row in the worst case, unless ship_rows_cap says
        # fewer.
        self._shard: Optional[torch.Tensor] = None
        self._miss_cap = 0
        if self.data_parallel:
            cap = self.model_cfg.cache.ship_rows_cap
            self._miss_cap = (cap if cap is not None
                              else layer_capacities(self.model_cfg)[0][0])
            self._miss_stage = torch.empty(
                (self._miss_cap, self.graph.features.shape[1]),
                dtype=torch.float32, pin_memory=self.device.type == "cuda")

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
        if self.pipeline:
            raise _unported("pipeline=True (the prefetch pipeline)",
                            "queue A, item A.4")
        if self.num_sampler_workers or cfg.host != HostConfig():
            raise _unported(f"host {cfg.host} / num_sampler_workers="
                            f"{self.num_sampler_workers} (the sampler pool "
                            f"and the load balance policy)",
                            "queue A, item A.5")
        if self.balance_policy not in (None, "round_robin"):
            raise _unported(f"balance_policy {self.balance_policy!r}",
                            "queue A, item A.5")
        if cfg.fault != FaultConfig():
            raise _unported(f"fault {cfg.fault} (sampler-pool fault "
                            f"tolerance)", "queue A, item A.5")
        # the ship-rows cap alone is no cache: it bounds data_parallel's
        # miss rows a batch
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

    # -- host stages ------------------------------------------------------------
    def _local_payload(self, partition: int, stage_s: Dict[str, float]
                       ) -> dict:
        """Stage 1 (sample, through the partition's cursor) + stage 2b (the
        layout build) for one scheduled batch."""
        t0 = time.perf_counter()
        mb = self.samplers[partition].next_batch()
        t1 = time.perf_counter()
        layout = (build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                                      self._blk_caps,
                                      gnn_models.AGG_KIND[self.model_cfg.name],
                                      edge_stream=self._edge_stream())
                  if self._blk_caps else None)
        stage_s["sample_s"] += t1 - t0
        stage_s["layout_s"] += time.perf_counter() - t1
        return {"minibatch": mb, "layout": layout,
                "load": mb.work_estimate()}

    def _resident_payload(self, dev: int, mb: MiniBatch,
                          stage_s: Dict[str, float]) -> dict:
        """Stage 2 under ``data_parallel`` (the reference's
        ``_batch_mesh_payload``): in place of the (N_0, f) block, the
        batch's hit rows and their positions in device ``dev``'s shard
        (``resident_payload``) and its miss rows, gathered into the pinned
        staging buffer and copied to the card (``_prepare_group``
        synchronises after each batch's copies, so the next batch may
        refill the buffer). Accounting equals ``FeatureStore.gather``'s."""
        t0 = time.perf_counter()
        ids = np.asarray(mb.nodes[0])
        valid = np.asarray(mb.node_mask[0], bool)
        idx = resident_payload(self.store.core, dev, ids, valid)
        mpos = idx["miss_pos"]
        n_miss = len(mpos)
        self.store.account_rows(dev, int(valid.sum()) - n_miss, n_miss)
        if n_miss > self._miss_cap:
            raise ValueError(
                f"batch ships {n_miss} miss rows to device {dev} but the "
                f"miss segment holds {self._miss_cap} "
                f"(ship_rows_cap={self.model_cfg.cache.ship_rows_cap}); "
                f"raise ship_rows_cap")
        np.take(self.graph.features, ids[mpos], axis=0, mode="clip",
                out=self._miss_stage.numpy()[:n_miss])
        t1 = time.perf_counter()
        out = {k: _to_device(a, self.device) for k, a in idx.items()}
        out["miss_rows"] = self._miss_stage[:n_miss].to(
            self.device, non_blocking=True, copy=True)
        stage_s["gather_s"] += t1 - t0
        stage_s["upload_s"] += time.perf_counter() - t1
        stage_s["miss_rows"] += n_miss
        return out

    def _prepare_group(self, assignments: List[sched.Assignment]) -> dict:
        """Stages 1, 2b and 2 (gather) for one synchronous iteration, then
        the upload of its p batches to the device. Fill batches for idle
        devices repeat the last real batch with weight 0: appended after
        the real ones, or, under ``data_parallel``, in the empty device
        slots (slot d runs against device d's shard)."""
        stage_s = {"sample_s": 0.0, "layout_s": 0.0, "gather_s": 0.0,
                   "upload_s": 0.0}
        if self.data_parallel:
            stage_s["miss_rows"] = 0
        payloads = [self._local_payload(a.partition, stage_s)
                    for a in assignments]
        devices = self._balancer.assign(assignments,
                                        [p["load"] for p in payloads])
        vertices = 0
        batches = []
        slots: List[Optional[dict]] = [None] * self.num_devices
        for dev, payload in zip(devices, payloads):
            mb = payload["minibatch"]
            vertices += mb.vertices_traversed()
            if self.data_parallel:
                feats, resident = None, self._resident_payload(dev, mb,
                                                               stage_s)
            else:
                t0 = time.perf_counter()
                feats = self.store.gather(dev, mb.nodes[0], mb.node_mask[0])
                resident = {}
                stage_s["gather_s"] += time.perf_counter() - t0
            t1 = time.perf_counter()
            arrs = batch_to_arrays(mb, feats, self.device, payload["layout"])
            arrs.update(resident)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            stage_s["upload_s"] += time.perf_counter() - t1
            batches.append(arrs)
            slots[dev] = arrs
        if self.data_parallel:
            batches = [b if b is not None else dict(batches[-1], weight=0.0)
                       for b in slots]
        while len(batches) < self.num_devices:
            fill = dict(batches[-1])
            fill["weight"] = 0.0
            batches.append(fill)
        return {"batches": batches, "vertices": vertices,
                "n_batches": len(assignments), "stage_s": stage_s}

    # -- stage 3: the device step -------------------------------------------------
    def _grads(self, batches: List[dict]):
        """Per-batch loss and gradients, combined by loss weight: returns
        (loss, acc, grads in ``flatten`` order)."""
        leaves = flatten(self.params)
        w = torch.tensor([b["weight"] for b in batches], dtype=torch.float32,
                         device=self.device)
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
        the build, the pinning and the copy."""
        t0 = time.perf_counter()
        mat = torch.from_numpy(self.store.build_shard_matrix())
        if self.device.type == "cuda":
            self._shard = mat.pin_memory().to(self.device, non_blocking=True)
            torch.cuda.synchronize(self.device)
        else:
            self._shard = mat
        return time.perf_counter() - t0

    def _execute(self, prepared: dict) -> dict:
        """Run the step on the prepared batches and read its metrics."""
        shard_s = None
        if self.data_parallel:
            shard_s = self._upload_shards() if self._shard is None else 0.0
        t0 = time.perf_counter()
        loss, acc, grads = self._grads(prepared["batches"])
        new_leaves, self.opt_state, om = self.optimizer.update(
            grads, self.opt_state, flatten(self.params))
        self.params = unflatten(self.params, new_leaves)
        out = {"loss": float(loss), "acc": float(acc), "lr": float(om["lr"]),
               "grad_norm": float(om["grad_norm"])}
        out["vertices_traversed"] = prepared["vertices"]
        out.update(prepared["stage_s"])
        out["step_s"] = time.perf_counter() - t0
        if shard_s is not None:
            out["shard_upload_s"] = shard_s
        return out

    def run_iteration(self, assignments: List[sched.Assignment]) -> dict:
        """One synchronous iteration: loss, acc, lr, grad_norm, vertices
        traversed, and the seconds of each stage (sample, layout, gather,
        upload, and the device step up to its metrics being read); under
        ``data_parallel`` also the miss rows shipped (``miss_rows``) and
        the seconds of the shard upload (``shard_upload_s``, 0 after the
        first step)."""
        return self._execute(self._prepare_group(assignments))

    def run_epoch(self) -> dict:
        """One synchronous epoch; returns the batch-weighted mean of the
        step metrics plus the epoch's throughput and traffic figures."""
        for s in self.samplers:
            s.reset_epoch()
        self.store.reset_stats()
        self._balancer = sched.LoadBalancer(self.num_devices)
        schedule = self.epoch_schedule()
        t0 = time.time()
        step_metrics: List[tuple] = []
        vertices = n_batches = 0
        gather_s = 0.0
        for group in sched.iterations(schedule):
            m = self.run_iteration(group)
            vertices += m["vertices_traversed"]
            gather_s += m["gather_s"]
            step_metrics.append((m, len(group)))
            n_batches += len(group)
        metrics: Dict[str, float] = {}
        if step_metrics:
            metrics = {k: sum(m[k] * nb for m, nb in step_metrics) / n_batches
                       for k in ("loss", "acc", "lr", "grad_norm")}
        wall = time.time() - t0
        stats = sched.schedule_stats(schedule, self.num_devices)
        n_iter = stats["iterations"]
        local_rows = sum(s.local_rows for s in self.store.stats)
        host_rows = sum(s.host_rows for s in self.store.stats)
        host_bytes = sum(s.host_bytes for s in self.store.stats)
        total_rows = local_rows + host_rows
        return {**metrics, "epoch_time_s": wall, "batches": n_batches,
                "iterations": n_iter,
                "utilization": stats["utilization"],
                "mesh_devices": self.num_devices if self.data_parallel else 0,
                "fill_slots": stats["fill_slots"],
                "vertices_traversed": vertices,
                "nvtps": vertices / wall if wall > 0 else 0.0,
                "beta": self.store.beta(),
                "load_imbalance": self._balancer.imbalance(),
                "host_gather_s": gather_s,
                "cache_hit_rate": (local_rows / total_rows
                                   if total_rows else 1.0),
                "miss_bytes": host_bytes,
                "miss_bytes_per_iter": (host_bytes / n_iter
                                        if n_iter else 0.0)}

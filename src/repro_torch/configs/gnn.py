"""GNN model, dataset and platform configs (copy of ``repro.configs.gnn``).

The paper trains 2-layer GCN / GraphSAGE, hidden 128, mini-batch of 1024
target vertices, neighbor fanouts (25, 10), on Reddit / Yelp / Amazon /
ogbn-products (paper Tables 4-7). ``GNNModelConfig`` keeps the model and
datapath fields flat and groups the host runtime knobs into ``host``,
``cache`` and ``fault``, as the reference does. The port runs every
value of each: the sampler pool and its fault tolerance, and the feature
cache (``core/feature_cache.py``) with its shipped-rows cap. The
reference's deprecated flat-kwarg spellings
(``cache_capacity=...`` on the config) are not copied: pass the nested
groups.

The port runs every ``aggregate_backend`` of the reference: "reference",
"pallas", "pallas_edges" and "pallas_fused" (the backend names are kept:
they name a layout and datapath, not Pallas), for GraphSAGE, GCN, GIN and
GAT. GAT's attention weights are computed on the device, so it takes the
plain "reference" datapath under every backend, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class HostConfig:
    """Host sampling-service knobs: sampler worker processes (0 samples
    in-process), how batches map to devices (``"round_robin"`` or
    ``"load"``), gathering in the workers, and worker CPU pinning."""

    num_sampler_workers: int = 0
    balance_policy: str = "round_robin"
    gather_in_workers: bool = False
    worker_affinity: bool = False


@dataclass(frozen=True)
class CacheConfig:
    """Per-device feature cache: row capacity (None = off; P3 builds no
    cache), refresh cadence in iterations (0 = at epoch boundaries, the
    only cadence ``data_parallel`` takes), and the shipped-rows cap (of
    the resident path's miss rows and of the sampler pool's ring slot;
    measured when unset and ``auto_ship_rows_cap``)."""

    capacity: Optional[int] = None
    refresh_every: int = 0
    ship_rows_cap: Optional[int] = None
    auto_ship_rows_cap: bool = True


@dataclass(frozen=True)
class FaultConfig:
    """Sampler-pool fault tolerance: respawn budget, straggler
    speculation, and fault injection (``core/faults.py``'s grammar).
    Meaningful with the sampler pool only."""

    max_respawns: int = 2
    straggler_timeout_s: Optional[float] = None
    speculative_sampling: bool = True
    fault_spec: Optional[str] = None


@dataclass(frozen=True)
class PlatformConfig:
    """The paper's platform metadata: what the user states about the
    hardware so the framework maps the algorithm onto it."""

    num_devices: int = 1
    host_cores: Optional[int] = None
    hbm_bytes_per_device: int = 8 << 30
    pcie_bw: float = 16e9
    host_bw: float = 205e9
    data_parallel: bool = False

    def to_metadata(self):
        """The analytic-model twin (``core.dse.PlatformMetadata``)."""
        from repro_torch.core.dse import PlatformMetadata
        return PlatformMetadata(num_devices=self.num_devices,
                                pcie_bw=self.pcie_bw, host_bw=self.host_bw)


@dataclass(frozen=True)
class GNNModelConfig:
    """Model + datapath fields plus the grouped host runtime.

    ``name`` is "gcn" | "graphsage" | "gin" | "gat"; ``num_layers``,
    ``hidden``, ``fanouts`` and ``batch_targets`` are the paper's Table 5
    shapes. ``aggregate_backend`` picks the aggregation datapath:
    "reference" (masked segment sum in plain PyTorch), "pallas" (compact
    per-edge triples densified into 128x128 tiles on the card, through the
    hand-written CUDA block-CSR kernel, then the update matmul),
    "pallas_edges" (per-tile edge segments through the hand-written CUDA
    aggregation kernel, then the update matmul) or "pallas_fused"
    (aggregation and update matmul in one hand-written CUDA kernel,
    forward and backward). GAT runs the "reference" datapath whatever
    the backend says (no layout, no kernel).
    The reference's ``kernel_interpret`` (Pallas execution mode) has no
    counterpart here.
    """

    name: str
    num_layers: int = 2
    hidden: int = 128
    fanouts: Tuple[int, ...] = (25, 10)
    batch_targets: int = 1024
    aggregate_backend: str = "reference"
    host: HostConfig = field(default_factory=HostConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    fault: FaultConfig = field(default_factory=FaultConfig)

    def __post_init__(self):
        object.__setattr__(self, "fanouts", tuple(self.fanouts))


@dataclass(frozen=True)
class GraphDatasetConfig:
    name: str
    num_vertices: int
    num_edges: int
    feat_dim: int        # f0
    hidden: int          # f1
    num_classes: int     # f2


# Paper Table 4 (full-scale stats; used by the DSE and the simulator).
REDDIT = GraphDatasetConfig("reddit", 232_965, 23_213_838, 602, 128, 41)
YELP = GraphDatasetConfig("yelp", 716_847, 13_954_819, 300, 128, 100)
AMAZON = GraphDatasetConfig("amazon", 1_569_960, 264_339_468, 200, 128, 107)
OGBN_PRODUCTS = GraphDatasetConfig("ogbn-products", 2_449_029, 61_859_140,
                                   100, 128, 47)

DATASETS = {d.name: d for d in (REDDIT, YELP, AMAZON, OGBN_PRODUCTS)}

GCN = GNNModelConfig("gcn")
GRAPHSAGE = GNNModelConfig("graphsage")

GNN_MODELS = {"gcn": GCN, "graphsage": GRAPHSAGE,
              "gin": GNNModelConfig("gin"), "gat": GNNModelConfig("gat")}

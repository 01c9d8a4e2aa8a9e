"""Feature store: gathers + beta accounting over a residency core (copy of
the in-process path of ``repro.core.feature_store``).

The host always holds the full X (paper §4.2): cache hits are device-HBM
reads, misses are fetched from host memory, and ``gather`` returns the
batch's (N, f) block with its per-device Eq. 7 accounting.
``build_shard_matrix`` is the host image of every device's HBM-resident
rows, which the trainer's ``data_parallel`` path keeps on the card, and
``place_gathered`` places the miss rows a sampler-pool worker gathered
(``gather_in_workers``). The P3 paths wait for P3.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.partition import Partition
from repro_torch.core.residency import (GatherStats, ResidencyCore,
                                        assemble_rows, build_residency)
from repro_torch.data.graphs import Graph

STRATEGY_BY_ALGORITHM = {
    "distdgl": "distdgl",
    "pagraph": "pagraph",
}


class FeatureStore:
    """Per-device feature residency + gather with beta accounting."""

    def __init__(self, graph: Graph, partition: Partition, strategy: str):
        self.g = graph
        self.p = partition.num_parts
        self.strategy = strategy
        self.stats = [GatherStats() for _ in range(self.p)]
        self.core: ResidencyCore = build_residency(graph, partition,
                                                   strategy)

    # -- residency queries (delegated) ----------------------------------------
    def num_resident(self, device: int) -> int:
        """How many vertex rows live in ``device``'s HBM."""
        return self.core.num_resident(device)

    def resident_ids(self, device: int) -> np.ndarray:
        """Sorted vertex ids resident on ``device``."""
        return self.core.resident_ids(device)

    def device_bytes(self, device: int) -> int:
        return self.core.device_bytes(device)

    def account_rows(self, device: int, n_hit: int, n_miss: int) -> None:
        """Fold one batch's hit/miss row counts into ``device``'s Eq. 7
        accounting (rows x the device's feature width x 4 bytes)."""
        st = self.stats[device]
        width = self.core.slice_width(device)
        st.local_rows += n_hit
        st.host_rows += n_miss
        st.local_bytes += n_hit * width * 4
        st.host_bytes += n_miss * width * 4

    def gather(self, device: int, vertex_ids: np.ndarray,
               mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Gather feature rows for a mini-batch onto ``device``: the (N, f)
        block with invalid (padding) rows zeroed; updates beta."""
        ids = np.asarray(vertex_ids)
        valid = np.ones(len(ids), bool) if mask is None else np.asarray(mask)
        res = self.core.is_resident(device, ids)
        hit = res & valid
        miss = (~res) & valid
        self.account_rows(device, int(hit.sum()), int(miss.sum()))
        out = self.g.features[ids]  # fancy indexing: already a fresh array
        out[~valid] = 0.0
        return out

    def place_gathered(self, device: int, vertex_ids: np.ndarray,
                       mask: np.ndarray, pos: np.ndarray, rows: np.ndarray,
                       shipped_for: Optional[int] = None) -> np.ndarray:
        """Device placement for rows gathered INSIDE a sampler worker
        (``ResidencyCore.select_ship_rows``): the shipped rows land by
        memcpy, the remaining valid rows are resident HBM reads, and beta is
        accounted for THIS device. ``shipped_for`` names the device the
        worker gathered for: when it matches (always under round_robin),
        the shipped row count IS this device's miss count and no residency
        probe runs here; when the dynamic balancer moved the batch, the
        accounting is re-derived for the actual placement (the values are
        device-independent, so the output stays bitwise identical to the
        in-process ``gather`` either way)."""
        ids = np.asarray(vertex_ids)
        valid = np.asarray(mask, bool)
        n_valid = int(valid.sum())
        if shipped_for == device:
            self.account_rows(device, n_valid - len(pos), len(pos))
        else:
            res = self.core.is_resident(device, ids)
            n_hit = int((res & valid).sum())
            self.account_rows(device, n_hit, n_valid - n_hit)
        return assemble_rows(self.g.features, ids, valid, pos, rows)

    # -- shard materialization ------------------------------------------------
    def shard_rows(self) -> int:
        """Row capacity of the per-device HBM shard: the largest resident
        buffer, so the stacked (p, rows, f) matrix is rectangular."""
        return max(self.core.capacities) if self.core.capacities else 0

    def shard_width(self) -> int:
        """Column width of the per-device shard: the full f (row-resident
        strategies)."""
        return self.g.features.shape[1]

    def build_shard_matrix(self) -> np.ndarray:
        """Every device's HBM-resident feature block as one (p, shard_rows,
        shard_width) float32 matrix: row d holds
        ``features[resident_ids(d)]`` in sorted-id order, zero-padded to
        the largest capacity — the order
        ``ResidencyCore.resident_positions`` indexes into."""
        rows, width = self.shard_rows(), self.shard_width()
        out = np.zeros((self.p, rows, width), np.float32)
        for d in range(self.p):
            rid = self.core.resident_ids(d)
            if len(rid):
                out[d, :len(rid)] = self.g.features[rid]
        return out

    def reset_stats(self) -> None:
        """Fresh per-device Eq. 7 accounting (the trainer calls this at
        every epoch start)."""
        self.stats = [GatherStats() for _ in range(self.p)]

    def beta(self, device: Optional[int] = None) -> float:
        if device is not None:
            return self.stats[device].beta
        tot = GatherStats()
        for s in self.stats:
            tot.merge(s)
        return tot.beta

"""Feature store: gathers + beta accounting over a residency core (copy of
the in-process path of ``repro.core.feature_store``).

The host always holds the full X (paper §4.2): cache hits are device-HBM
reads, misses are fetched from host memory, and ``gather`` returns the
batch's (N, f) block with its per-device Eq. 7 accounting. The
worker-gathered placement, P3 and mesh-shard paths wait for the sampler
pool, P3 and data parallelism.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.partition import Partition
from repro_torch.core.residency import (GatherStats, ResidencyCore,
                                        build_residency)
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

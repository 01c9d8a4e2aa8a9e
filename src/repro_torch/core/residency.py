"""Feature residency (copy of the static half of ``repro.core.residency``).

Which feature rows live in each device's memory (paper Table 1 placement),
as a sorted int32 id array per device, with one vectorized
``searchsorted`` membership test per batch. The reference's mutable,
generation-stamped and shared-memory parts serve the feature cache and the
sampler pool; they wait for those. P3's feature-dimension slices wait for
the P3 algorithm.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class GatherStats:
    """Per-device byte/row accounting for beta (paper Eq. 7)."""

    local_bytes: int = 0
    host_bytes: int = 0
    local_rows: int = 0
    host_rows: int = 0

    @property
    def beta(self) -> float:
        t = self.local_bytes + self.host_bytes
        return self.local_bytes / t if t else 1.0

    def merge(self, other: "GatherStats") -> None:
        self.local_bytes += other.local_bytes
        self.host_bytes += other.host_bytes
        self.local_rows += other.local_rows
        self.host_rows += other.host_rows


class ResidencyCore:
    """Which feature rows live in each device's HBM — numpy only."""

    def __init__(self, num_vertices: int, feat_dim: int,
                 resident_ids: Sequence[np.ndarray]):
        self.num_vertices = num_vertices
        self.feat_dim = feat_dim
        self._resident_ids: List[np.ndarray] = [
            np.asarray(r, np.int32) for r in resident_ids]

    def resident_ids(self, device: int) -> np.ndarray:
        return self._resident_ids[device]

    def is_resident(self, device: int, vertex_ids: np.ndarray) -> np.ndarray:
        """Vectorized membership: bool mask of which ids are device-local."""
        ids = np.asarray(vertex_ids)
        r = self._resident_ids[device]
        if len(r) == 0:
            return np.zeros(len(ids), bool)
        pos = np.searchsorted(r, ids)
        pos_clip = np.minimum(pos, len(r) - 1)
        return (pos < len(r)) & (r[pos_clip] == ids)

    def slice_width(self, device: int) -> int:
        del device  # row-resident strategies hold full rows
        return self.feat_dim


# PaGraph replicates the hottest (highest out-degree) quarter of the rows
PAGRAPH_CACHE_FRAC = 0.25


def build_residency(graph, partition, strategy: str) -> ResidencyCore:
    """Feature-storing strategy -> ResidencyCore (paper Table 1).

    * DistDGL : X_i = rows owned by partition i.
    * PaGraph : X_i = partition rows + highest OUT-degree rows up to a cache
                budget (replicated hot set).
    """
    p = partition.num_parts
    V = graph.num_vertices
    f = graph.features.shape[1]
    if strategy in ("distdgl", "metis_like"):
        resident = [np.sort(partition.part_vertices(i)).astype(np.int32)
                    for i in range(p)]
    elif strategy == "pagraph":
        budget = int(V * PAGRAPH_CACHE_FRAC)
        hot = np.argsort(-graph.out_degree())[:budget]
        resident = [np.union1d(partition.part_vertices(i), hot).astype(np.int32)
                    for i in range(p)]
    else:
        raise ValueError(f"unknown feature-storing strategy {strategy!r}")
    return ResidencyCore(V, f, resident)

"""Feature residency (copy of the static half of ``repro.core.residency``).

Which feature rows live in each device's memory (paper Table 1 placement),
as a sorted int32 id array per device, with one vectorized
``searchsorted`` membership test per batch, each batch row's position in
its device's resident shard, and the miss rows that must cross the bus.
The reference's mutable, generation-stamped and shared-memory parts serve
the feature cache and the sampler pool; they wait for those. P3's
feature-dimension slices wait for the P3 algorithm.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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
        # each device's resident buffer holds its (immutable) set exactly
        self.capacities: List[int] = [len(r) for r in self._resident_ids]

    def num_resident(self, device: int) -> int:
        """How many vertex rows live in ``device``'s HBM."""
        return len(self._resident_ids[device])

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

    def resident_positions(self, device: int, vertex_ids: np.ndarray,
                           mask: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Positions of a batch's rows inside ``device``'s resident buffer.

        Returns ``(pos, hit)``: ``pos[i]`` is the index of ``vertex_ids[i]``
        in the device's sorted resident-id array (its row in the shard
        built by ``FeatureStore.build_shard_matrix``) and ``hit[i]`` is
        True where the id is resident AND valid. Where ``hit`` is False,
        ``pos`` is 0, so the placeholder index is always in bounds."""
        ids = np.asarray(vertex_ids)
        valid = (np.ones(len(ids), bool) if mask is None
                 else np.asarray(mask, bool))
        r = self._resident_ids[device]
        if len(r) == 0:
            return (np.zeros(len(ids), np.int32),
                    np.zeros(len(ids), bool))
        pos = np.searchsorted(r, ids)
        pos_clip = np.minimum(pos, len(r) - 1)
        hit = (pos < len(r)) & (r[pos_clip] == ids) & valid
        return np.where(hit, pos_clip, 0).astype(np.int32), hit

    def slice_width(self, device: int) -> int:
        del device  # row-resident strategies hold full rows
        return self.feat_dim

    def device_bytes(self, device: int) -> int:
        return self.num_resident(device) * self.slice_width(device) * 4

    def select_ship_rows(self, device: int, features: np.ndarray,
                         vertex_ids: np.ndarray, mask: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The rows of a batch that must travel to ``device``: ``(pos,
        rows)``, ``pos`` (int32) indexing into ``vertex_ids`` where the id
        is valid and not resident, ``rows`` the (M, f) float32 block of
        those rows. Resident rows are device-HBM reads."""
        ids = np.asarray(vertex_ids)
        valid = np.asarray(mask, bool)
        pos = np.flatnonzero((~self.is_resident(device, ids)) & valid)
        rows = np.ascontiguousarray(features[ids[pos]], dtype=np.float32)
        return pos.astype(np.int32), rows


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

"""Feature residency (copy of the row-resident half of
``repro.core.residency``).

Which feature rows live in each device's memory (paper Table 1 placement),
as a sorted int32 id array per device, with one vectorized
``searchsorted`` membership test per batch, each batch row's position in
its device's resident shard, and the miss rows that must cross the bus.
The core is numpy only, so the sampler pool's worker processes import it
next to the sampler: ``to_shared`` copies the id arrays once into named
shared-memory segments (with a generation-stamped meta header for a
mutable cache) and ``from_shared`` attaches them zero-copy in a worker,
whose ``select_ship_rows`` then picks the rows that must cross the bus.
P3's feature-dimension slices wait for the P3 algorithm.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.graphs import attach_arrays, share_arrays


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


@dataclass(frozen=True)
class SharedResidencySpec:
    """Picklable descriptor of a shared-memory-resident ResidencyCore: the
    segment holding the concatenated id buffers, the mutable meta header
    (generation + per-device lengths), plus the (tiny) geometry.

    Offsets are CAPACITY offsets: device i's id buffer is
    ``ids_cat[off[i]:off[i+1]]`` and its LIVE prefix length is
    ``meta[1 + i]`` (for an immutable core length == capacity forever)."""

    segment: "object"               # data.graphs.SharedArraySpec (ids)
    meta: "object"                  # data.graphs.SharedArraySpec (int64 hdr)
    offsets: Tuple[int, ...]        # capacity offsets into ids_cat
    num_vertices: int
    feat_dim: int


class ResidencyCore:
    """Which feature rows live in each device's HBM — numpy only.

    The id sets are MUTABLE and generation-stamped: :meth:`set_resident`
    replaces a device's set between iterations and
    :meth:`publish_generation` makes the new contents visible, and
    ``capacities`` bound each device's id buffer so the shared-memory twin
    can be sized once and updated in place. Sampler workers holding an
    attached core handshake on the generation (:meth:`wait_generation`).
    A core that is never mutated (no feature cache) keeps generation 0 and
    capacity == length.
    """

    def __init__(self, num_vertices: int, feat_dim: int,
                 resident_ids: Sequence[np.ndarray],
                 capacities: Optional[Sequence[int]] = None):
        self.num_vertices = num_vertices
        self.feat_dim = feat_dim
        self._resident_ids: List[np.ndarray] = [
            np.asarray(r, np.int32) for r in resident_ids]
        self.capacities: List[int] = (
            [len(r) for r in self._resident_ids] if capacities is None
            else [int(c) for c in capacities])
        for i, r in enumerate(self._resident_ids):
            if len(r) > self.capacities[i]:
                raise ValueError(
                    f"device {i} resident set ({len(r)} ids) exceeds its "
                    f"buffer capacity {self.capacities[i]}")
        self.generation = 0
        self._shared_mirror: Optional["SharedResidency"] = None

    @property
    def num_devices(self) -> int:
        return len(self._resident_ids)

    # -- mutation (the feature cache's write path) ----------------------------
    def set_resident(self, device: int, sorted_ids: np.ndarray) -> None:
        """Replace ``device``'s resident-id set (must be sorted int32,
        within the device's buffer capacity). Writes through to the shared
        twin when one exists — but does NOT bump the generation: callers
        update every device, then :meth:`publish_generation` once, so
        attached workers never observe a half-updated cache."""
        ids = np.asarray(sorted_ids, np.int32)
        if len(ids) > self.capacities[device]:
            raise ValueError(
                f"resident set of {len(ids)} ids exceeds device {device}'s "
                f"cache capacity {self.capacities[device]}")
        self._resident_ids[device] = ids
        if self._shared_mirror is not None:
            self._shared_mirror.write_device(device, ids)

    def publish_generation(self, generation: int) -> None:
        """Stamp the current resident sets as ``generation`` (monotone).
        With a shared twin the stamp is written LAST, after every id write,
        so an attached worker that observes the new generation also
        observes the new contents."""
        if generation < self.generation:
            raise ValueError(
                f"generation must be monotone: {generation} < "
                f"{self.generation}")
        self.generation = generation
        if self._shared_mirror is not None:
            self._shared_mirror.publish(generation)

    # -- residency queries ----------------------------------------------------
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

    def miss_count(self, device: int, vertex_ids: np.ndarray,
                   mask: Optional[np.ndarray] = None) -> int:
        """How many of the (valid) rows would cross the bus to ``device`` —
        the gathered-feature term of the Eq. 5 work estimate."""
        ids = np.asarray(vertex_ids)
        valid = np.ones(len(ids), bool) if mask is None else np.asarray(mask)
        return int(((~self.is_resident(device, ids)) & valid).sum())

    def slice_width(self, device: int) -> int:
        del device  # row-resident strategies hold full rows
        return self.feat_dim

    def device_bytes(self, device: int) -> int:
        return self.num_resident(device) * self.slice_width(device) * 4

    def select_ship_rows(self, device: int, features: np.ndarray,
                         vertex_ids: np.ndarray, mask: np.ndarray,
                         p3_full: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The rows of a batch that must travel to ``device``: ``(pos,
        rows)``, ``pos`` (int32) indexing into ``vertex_ids`` where the id
        is valid and not resident, ``rows`` the (M, f) float32 block of
        those rows. Resident rows are device-HBM reads. ``p3_full`` ships
        every valid row (the reference's P3 all-to-all shipping, which the
        sampler pool's codec keeps)."""
        ids = np.asarray(vertex_ids)
        valid = np.asarray(mask, bool)
        if p3_full:
            pos = np.flatnonzero(valid)
        else:
            pos = np.flatnonzero((~self.is_resident(device, ids)) & valid)
        rows = np.ascontiguousarray(features[ids[pos]], dtype=np.float32)
        return pos.astype(np.int32), rows

    # -- shared-memory residency ----------------------------------------------
    def to_shared(self) -> "SharedResidency":
        """Copy the resident-id buffers ONCE into named shared-memory
        segments (ids at full buffer CAPACITY + the mutable meta header).
        Returns the owning handle (same close/unlink discipline as
        ``data.graphs.SharedGraph``); its picklable ``spec`` attaches
        workers zero-copy via :meth:`from_shared`. The handle registers
        itself as this core's write-through mirror, so later
        :meth:`set_resident`/:meth:`publish_generation` calls update the
        segments in place — the cache-refresh path."""
        shared = SharedResidency(self)
        self._shared_mirror = shared
        return shared

    @classmethod
    def from_shared(cls, spec: SharedResidencySpec) -> "ResidencyCore":
        """Attach a core whose id arrays are zero-copy views over the shared
        segment described by ``spec``. The attachment handle rides on the
        instance (``_shm_handles``) for its lifetime; attachers never
        unlink. The views cover each device's LIVE prefix (meta lengths) at
        the meta generation; :meth:`sync_shared` re-derives them after the
        owner publishes a new generation."""
        handles, arrays = attach_arrays({"resident_cat": spec.segment,
                                         "resident_meta": spec.meta})
        cat = arrays["resident_cat"]
        meta = arrays["resident_meta"]
        off = spec.offsets
        ids = [cat[off[i]:off[i] + int(meta[1 + i])]
               for i in range(len(off) - 1)]
        caps = [off[i + 1] - off[i] for i in range(len(off) - 1)]
        core = cls(spec.num_vertices, spec.feat_dim, ids, capacities=caps)
        core._shm_handles = handles
        core._shared_cat = cat
        core._shared_meta = meta
        core._shared_offsets = off
        core.generation = int(meta[0])
        return core

    def sync_shared(self) -> None:
        """Re-derive the resident-id views from the shared meta header
        (attached cores only): after the owner publishes generation g, the
        live prefix lengths may have changed. One slice per device — the id
        bytes themselves are never copied."""
        meta = self._shared_meta
        off = self._shared_offsets
        for i in range(self.num_devices):
            self._resident_ids[i] = self._shared_cat[
                off[i]:off[i] + int(meta[1 + i])]
        self.generation = int(meta[0])

    def wait_generation(self, generation: int, timeout: float = 60.0,
                        poll_s: float = 2e-4) -> None:
        """Block until the shared cache reaches exactly ``generation`` and
        sync the views to it (attached cores only; owners are already
        current). A task stamped with generation g may arrive at a worker
        BEFORE the trainer has installed g (the submission window runs
        ahead of the refresh point) — the worker spins here. The owner
        never overwrites contents a stamped task still needs (it installs
        g+1 only after every g-stamped payload was consumed), so observing
        a generation PAST the stamp means the handshake was violated and
        raises."""
        if not hasattr(self, "_shared_meta"):
            if self.generation != generation:
                raise RuntimeError(
                    f"core at generation {self.generation} cannot wait for "
                    f"{generation} without a shared meta header")
            return
        deadline = time.monotonic() + timeout
        while True:
            gen = int(self._shared_meta[0])
            if gen == generation:
                self.sync_shared()
                return
            if gen > generation:
                raise RuntimeError(
                    f"cache generation ran ahead of a stamped task: shared "
                    f"generation {gen} > stamped {generation} (refresh "
                    f"published before all prior payloads were consumed)")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"cache generation {generation} not published within "
                    f"{timeout:.0f}s (shared generation still {gen})")
            time.sleep(poll_s)



class SharedResidency:
    """Owner handle for a ResidencyCore copied into shared memory.

    One segment holds every device's sorted id BUFFER back to back at full
    capacity (the per-device capacity offsets travel in the picklable
    spec); a second, mutable int64 meta segment holds
    ``[generation, len_0, ..., len_{p-1}]`` — the cache-refresh write path
    updates a device's prefix + length in place and publishes the
    generation LAST. ``close`` is idempotent and unlinks; context-manager
    exit and ``__del__`` both run it so the segments never outlive their
    pool."""

    def __init__(self, core: ResidencyCore):
        p = core.num_devices
        caps = list(core.capacities)
        lengths = [len(r) for r in core._resident_ids]
        offsets = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
        cat = np.zeros(int(offsets[-1]), np.int32)
        for i in range(p):
            if lengths[i]:
                cat[int(offsets[i]):int(offsets[i]) + lengths[i]] = \
                    core._resident_ids[i]
        meta = np.array([core.generation] + lengths, np.int64)
        self._segments, specs = share_arrays({"resident_cat": cat,
                                              "resident_meta": meta})
        # writable views over the OWNER's mapping (share_arrays copied the
        # seed values in; re-attach the arrays for in-place refresh writes)
        self._own_handles, own = attach_arrays(
            {"resident_cat": specs["resident_cat"],
             "resident_meta": specs["resident_meta"]})
        self._cat = own["resident_cat"]
        self._meta = own["resident_meta"]
        self._offsets = [int(o) for o in offsets]
        self._core = core
        self.spec = SharedResidencySpec(
            specs["resident_cat"], specs["resident_meta"],
            tuple(int(o) for o in offsets),
            core.num_vertices, core.feat_dim)
        self._closed = False

    # -- cache-refresh write path --------------------------------------------
    def write_device(self, device: int, sorted_ids: np.ndarray) -> None:
        lo = self._offsets[device]
        n = len(sorted_ids)
        if n > self._offsets[device + 1] - lo:
            raise ValueError(
                f"device {device} resident set ({n}) exceeds its shared "
                f"buffer capacity {self._offsets[device + 1] - lo}")
        self._cat[lo:lo + n] = sorted_ids
        self._meta[1 + device] = n

    def publish(self, generation: int) -> None:
        self._meta[0] = generation

    def close(self, unlink: bool = True) -> None:
        if getattr(self, "_closed", False):
            return
        self._closed = True
        core = getattr(self, "_core", None)
        if core is not None and core._shared_mirror is self:
            core._shared_mirror = None  # refresh writes stop hitting shm
        for shm in list(getattr(self, "_own_handles", [])):
            try:
                shm.close()
            except Exception:
                pass
        for shm in self._segments:
            try:
                shm.close()
            except Exception:
                pass
            if unlink:
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass

    def __enter__(self) -> "SharedResidency":
        return self

    def __exit__(self, *exc) -> None:
        self.close(unlink=True)

    def __del__(self):
        try:
            self.close(unlink=True)
        except Exception:
            pass


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


def assemble_rows(features: np.ndarray, vertex_ids: np.ndarray,
                  mask: np.ndarray, pos: np.ndarray, rows: np.ndarray
                  ) -> np.ndarray:
    """Device placement for a worker-gathered batch: shipped rows memcpy in,
    the remaining valid rows are resident reads out of ``features`` (the
    simulated device HBM — the host holds the full X, paper §4.2), invalid
    (padding) rows stay zero. Bitwise identical to the in-process
    ``FeatureStore.gather`` output for the same batch,
    whichever device the rows were selected for."""
    ids = np.asarray(vertex_ids)
    valid = np.asarray(mask, bool)
    out = np.zeros((len(ids), features.shape[1]), np.float32)
    local = valid.copy()
    local[pos] = False
    out[local] = features[ids[local]]
    out[pos] = rows
    return out

"""Frequency-driven per-device feature cache (copy of
``repro.core.feature_cache``).

The static partition keeps a row resident only where it happens to be
partition-local; the rows a batch touches follow the sampler. This module
turns the static residency (``core/residency.ResidencyCore``) into a
fixed-capacity cache:

  * **Seeding** — each device's cache starts as its static partition's
    highest-out-degree rows up to ``capacity`` (PaGraph's degree
    heuristic).
  * **Frequency counting** — the trainer folds every consumed batch's
    valid layer-0 ids into one access counter, in consumption order, so
    admission is a pure function of the batch stream whatever the sampler
    worker count. Workers gather against the generation-stamped cache
    contents (``ResidencyCore.wait_generation``).
  * **Admission and eviction** — every ``refresh_every`` iterations (at
    epoch boundaries when 0) the top-``capacity`` rows by frequency
    (out-degree, then id, break ties) replace the resident set on every
    cached device: one replicated hot set. Cached rows are copies of host
    rows, so admission moves where a gather reads from, never what it
    reads.
  * **Asynchronous refresh** — with ``refresh_every=K>0`` the next
    generation's ranking runs on a background thread launched one
    iteration early and is installed between iterations, at a point the
    iteration schedule fixes, so every worker count sees one residency
    timeline.

P3 never constructs a cache: every row is already resident as a
feature-dimension slice.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.residency import ResidencyCore

__all__ = ["FeatureCache"]


class FeatureCache:
    """Fixed-capacity frequency-driven admission over a ResidencyCore.

    Construction reseeds the core: each device that is not all-resident
    gets its static partition's top-``capacity`` rows by out-degree (the
    whole static set when it fits), and its buffer capacity becomes
    ``capacity`` so later admissions have room. Construct the cache before
    the core is shared with sampler workers (``ResidencyCore.to_shared``):
    the shared segment is sized from the capacities.

    Iteration protocol (driven by the trainer, in consumption order):
      * ``observe(ids, mask)`` once per consumed batch;
      * ``end_iteration(j)`` after iteration ``j``'s batches are observed:
        joins and installs a pending refresh when ``(j+1) % K == 0`` (so
        iteration ``j+1`` onward runs at generation ``(j+1)//K``, the task
        stamps ``gen(i) = i//K``) and launches the next ranking one
        iteration early at ``(j+2) % K == 0``;
      * ``start_epoch()`` before an epoch's first submission: resets the
        per-epoch counters and, with ``K == 0``, refreshes synchronously at
        generation = epochs completed.
    """

    def __init__(self, core: ResidencyCore, out_degree: np.ndarray,
                 capacity: int, refresh_every: int = 0):
        if capacity < 1:
            raise ValueError("cache_capacity must be >= 1")
        if refresh_every < 0:
            raise ValueError("cache_refresh_every must be >= 0")
        if core._shared_mirror is not None:
            raise ValueError(
                "FeatureCache must wrap the core before to_shared(): the "
                "shared segment is sized from the cache capacity")
        self.core = core
        self.capacity = int(capacity)
        self.refresh_every = int(refresh_every)
        self._deg = np.ascontiguousarray(out_degree)
        if len(self._deg) != core.num_vertices:
            raise ValueError("out_degree must have one entry per vertex")
        self.freq = np.zeros(core.num_vertices, np.int64)
        # lifetime and per-epoch accounting (the epoch metrics report it)
        self.admissions_total = 0
        self.evictions_total = 0
        self.refresh_bytes_total = 0
        self.refreshes = 0
        self.admissions_epoch = 0
        self.evictions_epoch = 0
        self.refresh_bytes_epoch = 0
        # host seconds, over the cache's life, of installing admitted sets,
        # of waiting on the ranking thread and of ranking on the caller's
        # thread (the epoch-boundary refresh)
        self.apply_s = 0.0
        self.wait_s = 0.0
        self.rank_s = 0.0
        self._epochs_run = 0
        self._pending: Optional[tuple] = None  # (gen, thread, result holder)
        self._seed()

    # -- seeding ---------------------------------------------------------------
    def _seed(self) -> None:
        """Static partition -> degree-ranked cache seed, per device."""
        for d in range(self.core.num_devices):
            if self.core._all_resident[d]:
                continue
            static = self.core._resident_ids[d]
            self.core.capacities[d] = self.capacity
            if len(static) > self.capacity:
                # top-capacity by out-degree; the stable sort keeps the
                # lowest id on ties (static is sorted ascending)
                order = np.argsort(-self._deg[static], kind="stable")
                keep = np.sort(static[order[:self.capacity]])
            else:
                keep = static
            self.core.set_resident(d, keep)

    # -- frequency counting (consumer side, consumption order) -----------------
    def observe(self, vertex_ids: np.ndarray, mask: np.ndarray) -> None:
        """Fold one consumed batch's valid layer-0 ids into the counter.
        Padded frontiers repeat ids, so ``np.add.at`` (unbuffered) counts
        every occurrence."""
        ids = np.asarray(vertex_ids)
        np.add.at(self.freq, ids[np.asarray(mask, bool)], 1)

    # -- admission ranking -----------------------------------------------------
    def _select(self, freq: np.ndarray) -> np.ndarray:
        """Top-``capacity`` vertex ids by (frequency desc, out-degree desc,
        id asc), one ranking for every cached device. ``lexsort`` is
        stable, so rows equal on both keys keep ascending-id order."""
        order = np.lexsort((-self._deg, -freq))
        return np.sort(order[:self.capacity]).astype(np.int32)

    def _apply(self, ids: np.ndarray, generation: int) -> None:
        """Install one admitted set on every cached device and publish the
        generation (the core writes through to its shared twin)."""
        t0 = time.perf_counter()
        for d in range(self.core.num_devices):
            if self.core._all_resident[d]:
                continue
            old = self.core._resident_ids[d]
            kept = np.intersect1d(old, ids, assume_unique=True).size
            admitted = len(ids) - kept
            evicted = len(old) - kept
            self.admissions_epoch += admitted
            self.evictions_epoch += evicted
            self.admissions_total += admitted
            self.evictions_total += evicted
            # the refresh stream: admitted rows are host-to-device copies
            bytes_moved = admitted * self.core.slice_width(d) * 4
            self.refresh_bytes_epoch += bytes_moved
            self.refresh_bytes_total += bytes_moved
            self.core.set_resident(d, ids)
        self.core.publish_generation(generation)
        self.refreshes += 1
        self.apply_s += time.perf_counter() - t0

    # -- refresh scheduling ----------------------------------------------------
    def _launch(self, generation: int) -> None:
        """Snapshot the counter and rank the next admitted set on a
        background thread (the O(V log V) sort), overlapped with the next
        iteration's device step."""
        snap = self.freq.copy()
        holder: List[np.ndarray] = []
        t = threading.Thread(
            target=lambda: holder.append(self._select(snap)),
            name="hitgnn-cache-refresh", daemon=True)
        t.start()
        self._pending = (generation, t, holder)

    def _join_apply(self, generation: int) -> None:
        gen, t, holder = self._pending
        self._pending = None
        t0 = time.perf_counter()
        t.join()
        self.wait_s += time.perf_counter() - t0
        if gen != generation:
            raise RuntimeError(
                f"pending cache refresh targets generation {gen}, "
                f"expected {generation}")
        self._apply(holder[0], generation)

    def end_iteration(self, iteration: int) -> None:
        """Hook after iteration ``iteration``'s batches were observed.
        No-op with epoch-boundary refresh (``refresh_every == 0``)."""
        K = self.refresh_every
        if K <= 0:
            return
        if (iteration + 1) % K == 0:
            target = (iteration + 1) // K
            if self._pending is None:  # first refresh: no lead iteration
                self._launch(target)
            self._join_apply(target)
        if (iteration + 2) % K == 0:
            self._launch((iteration + 2) // K)

    def start_epoch(self) -> None:
        """Per-epoch reset and the epoch-boundary refresh. Call before the
        epoch's first task submission so workers stamp against the
        refreshed generation."""
        self.admissions_epoch = 0
        self.evictions_epoch = 0
        self.refresh_bytes_epoch = 0
        if self.refresh_every == 0 and self._epochs_run > 0:
            self.refresh_now(self._epochs_run)
        self._epochs_run += 1

    def refresh_now(self, generation: int) -> None:
        """Synchronous admission and eviction at ``generation``."""
        t0 = time.perf_counter()
        ids = self._select(self.freq)
        self.rank_s += time.perf_counter() - t0
        self._apply(ids, generation)

    @property
    def generation(self) -> int:
        return self.core.generation

    def hit_ids(self, device: int) -> np.ndarray:
        return self.core.resident_ids(device)

    def close(self) -> None:
        """Join any in-flight ranking thread without installing it."""
        if self._pending is not None:
            _, t, _ = self._pending
            self._pending = None
            t.join()

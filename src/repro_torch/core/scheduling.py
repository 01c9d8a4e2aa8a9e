"""Mode-agnostic scheduling core (copy of ``repro.core.scheduling``):
batch sources feeding the sampler pool.

The host runtime prepares mini-batches the same way no matter WHY a batch
exists: address it by pure RNG coordinates, submit it to the supervised
``SamplerPool`` (or run the in-process twin), and hand the payloads back in
submission order. What differs between execution modes is only WHERE the
batch addresses come from:

    EpochSource      the trainer's epoch permutation — the two-stage
                     schedule's iteration groups, each assignment addressed
                     as (partition, epoch, batch_index)
    (serving)        a request queue — coalesced micro-batches with
                     explicit target ids (the serving runtime, not ported
                     yet)

This module is the seam between the two: :class:`BatchTask` is the
mode-neutral unit of sampler work, :class:`BatchSource` yields them in
*units* (one unit = the payloads one consumer step needs together), and
:class:`SchedulingCore` streams a source through the pool with a bounded
submission window. Each task carries the feature cache's generation its
gather must see (the trainer's ``_task_gen``; 0 without a cache, whose
residency never changes).
"""
from __future__ import annotations

import time
from collections import deque
from typing import (Any, Callable, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np


class BatchTask:
    """One unit of sampler work, addressed by pure RNG coordinates.

    ``(partition, epoch, index)`` name a counter-based RNG stream — any
    process materializes the bit-identical batch from them. ``device`` is
    the target device whose residency decides which feature rows ship;
    ``generation`` the cache generation to gather against. ``targets``
    (serving) carries explicit target ids instead of the epoch
    permutation's slice; ``(epoch, index)`` remain the RNG coordinates so
    fault-recovery re-execution stays bitwise."""

    __slots__ = ("partition", "epoch", "index", "device", "generation",
                 "targets")

    def __init__(self, partition: int, epoch: int, index: int,
                 device: Optional[int] = None, generation: int = 0,
                 targets: Optional[np.ndarray] = None):
        self.partition = partition
        self.epoch = epoch
        self.index = index
        self.device = partition if device is None else device
        self.generation = generation
        self.targets = targets

    def pool_args(self) -> tuple:
        """The positional tuple ``SamplerPool.submit`` takes."""
        return (self.partition, self.epoch, self.index, self.device,
                self.generation, self.targets)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        t = "" if self.targets is None else f", targets[{len(self.targets)}]"
        return (f"BatchTask(p={self.partition}, e={self.epoch}, "
                f"i={self.index}, d={self.device}, g={self.generation}{t})")


class BatchSource:
    """Yields scheduling units ``(meta, [BatchTask, ...])``.

    ``meta`` is opaque to the core — the consumer gets it back verbatim
    alongside the unit's payloads (the trainer passes the iteration's
    assignment group; serving passes the micro-batch descriptor). Units
    must carry at least one task."""

    def units(self) -> Iterator[Tuple[Any, List[BatchTask]]]:
        raise NotImplementedError


class EpochSource(BatchSource):
    """The epoch-permutation batch source: one unit per scheduler
    iteration group, tasks addressed by the group's assignments.

    ``gen_for_group(gi)`` stamps the cache generation per group offset —
    the trainer derives it from the global iteration counter, so resuming
    mid-epoch keeps generations aligned with the cache refresh cadence."""

    def __init__(self, groups: Sequence[Sequence[Any]], epoch: int,
                 gen_for_group: Callable[[int], int] = lambda gi: 0):
        self.groups = list(groups)
        self.epoch = epoch
        self.gen_for_group = gen_for_group

    def units(self) -> Iterator[Tuple[Any, List[BatchTask]]]:
        for gi, g in enumerate(self.groups):
            gen = self.gen_for_group(gi)
            yield g, [BatchTask(a.partition, self.epoch, a.batch_index,
                                a.device, gen) for a in g]


class IterableSource(BatchSource):
    """Adapter: any iterable of ``(meta, [BatchTask, ...])`` units — the
    request path wraps its coalescer output in one of these."""

    def __init__(self, it: Iterable[Tuple[Any, List[BatchTask]]]):
        self._it = it

    def units(self) -> Iterator[Tuple[Any, List[BatchTask]]]:
        return iter(self._it)


class SchedulingCore:
    """Submit/fetch machinery shared by the epoch trainer and the serving
    frontend.

    ``pool`` is a :class:`~repro_torch.core.sampler_pool.SamplerPool` (None =
    run every task through ``local_fn``, the in-process twin the caller
    provides — the trainer samples through its cursor-stateful samplers,
    serving through a private one). ``window`` bounds
    staged-but-unconsumed pool tasks exactly like the prefetch executor's
    queue depth bounds prepared groups."""

    def __init__(self, pool: Optional[Any] = None,
                 local_fn: Optional[Callable[[BatchTask], dict]] = None,
                 window: Optional[int] = None,
                 fetch_timeout: float = 300.0):
        if pool is None and local_fn is None:
            raise ValueError("need a SamplerPool or a local_fn")
        self.pool = pool
        self.local_fn = local_fn
        self.window = window
        self.fetch_timeout = fetch_timeout
        self._pending: deque = deque()

    # -- streaming (epoch frontend) -----------------------------------------
    def payload_stream(self, source: BatchSource
                       ) -> Iterator[Tuple[Any, List[dict]]]:
        """Stream a source's units through the pool, yielding
        ``(meta, payloads)`` in unit order. With no pool, tasks run through
        ``local_fn`` lazily as the stream is consumed.

        The pool path keeps up to ``window`` tasks outstanding ahead of
        the consumer (``SamplerPool.map_tasks``), so sampler workers stay
        busy while the consumer assembles and dispatches earlier units —
        the same flow the trainer ran before this extraction, bit-for-bit:
        identical task order, window, and fetch semantics."""
        if self.pool is None:
            for meta, tasks in source.units():
                yield meta, [self.local_fn(t) for t in tasks]
            return
        queued: deque = deque()

        def task_tuples():
            for meta, tasks in source.units():
                if not tasks:
                    raise ValueError("a scheduling unit must carry >= 1 "
                                     "task")
                queued.append((meta, len(tasks)))
                for t in tasks:
                    yield t.pool_args()

        payloads = self.pool.map_tasks(task_tuples(), self.window,
                                       self.fetch_timeout)
        while True:
            if queued:
                meta, n = queued.popleft()
                yield meta, [next(payloads) for _ in range(n)]
                continue
            # the source is consumed only as map_tasks pulls tasks — ask
            # for the next payload to advance it; StopIteration here means
            # the source is exhausted and everything was delivered
            try:
                first = next(payloads)
            except StopIteration:
                return
            meta, n = queued.popleft()
            yield meta, [first] + [next(payloads) for _ in range(n - 1)]

    # -- incremental (request frontend) -------------------------------------
    def submit_unit(self, meta: Any, tasks: Sequence[BatchTask]) -> None:
        """Enqueue one unit's tasks (request path). With no pool the unit
        is only recorded — ``collect_unit`` runs it in-process."""
        if not tasks:
            raise ValueError("a scheduling unit must carry >= 1 task")
        if self.pool is not None:
            for t in tasks:
                self.pool.submit(*t.pool_args())
        self._pending.append((meta, list(tasks)))

    def collect_unit(self, timeout: Optional[float] = None
                     ) -> Tuple[Any, List[dict]]:
        """Payloads of the oldest submitted unit, in task order. One
        ABSOLUTE deadline governs the whole unit — the SLO primitive the
        serving frontend budgets against (``SamplerPool.fetch`` semantics:
        a straggling worker cannot stretch the wait past ``timeout``)."""
        if not self._pending:
            raise RuntimeError("collect_unit() with no submitted units")
        meta, tasks = self._pending.popleft()
        if self.pool is None:
            return meta, [self.local_fn(t) for t in tasks]
        timeout = self.fetch_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        out = []
        for _ in tasks:
            remaining = max(1e-3, deadline - time.monotonic())
            out.append(self.pool.fetch(timeout=remaining))
        return meta, out

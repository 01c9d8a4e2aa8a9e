"""Prefetching host pipeline (copy of ``repro.core.pipeline``): overlap
sampling and gathering with the device step.

HitGNN's epoch time model (paper Eq. 5-6) assumes the host's per-iteration
work — neighbor sampling over the full topology, the layout build and the
feature gather — runs CONCURRENTLY with the device step, so

    t_iteration ~= max(t_sample + t_gather, t_compute)      (pipelined)

instead of their sum (sequential). This module provides the executor that
realizes the overlap: a bounded queue fed by one background worker thread
that prepares iteration t+1 while the consumer executes iteration t.

Design notes:
  * ONE producer thread, consuming schedule groups in order — the sampler
    RNG sequence is identical to the sequential path, so a fixed seed yields
    bit-identical training whether prefetching is on or off.
  * Bounded depth — the producer can run at most ``depth`` iterations ahead,
    bounding host memory for staged mini-batches.
  * Clean epoch draining — the generator joins the worker at exhaustion and
    cancels it (stop event + drain) if the consumer abandons the epoch
    early, so no thread outlives its epoch.
  * Producer exceptions re-raise in the consumer at the point of ``next()``
    WITH the worker's original traceback attached (the frames inside
    ``prepare`` stay visible, and the formatted worker trace is appended to
    the exception so it survives even if a later handler re-wraps it).

Where the iteration items come from is ``core/scheduling.py``'s concern;
this executor overlaps whatever payload stream that seam yields with the
device step. In the port the producer also issues the batch's host-to-
device copies on the trainer's upload stream (``core/trainer.py``).
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional

_SENTINEL = object()


@dataclass
class PipelineStats:
    """Per-epoch timing split: host produce time vs consumer queue-wait.

    ``produce_s`` is the wall time the worker spent inside ``prepare`` (the
    sample+gather stages); ``wait_s`` is how long the consumer blocked on an
    empty queue (host-bound iterations); overlap quality is visible as
    wait_s << produce_s. ``gather_s`` isolates the stage-2 share of
    ``produce_s`` — the feature gather (in-process) or placement tail
    (worker-gathered rows) — and ``ring_bytes`` counts the payload bytes
    that crossed the sampling service's shared-memory ring, so the stage-2
    offload's effect on the training thread is measurable per epoch."""

    items: int = 0
    produce_s: float = 0.0
    wait_s: float = 0.0
    gather_s: float = 0.0
    ring_bytes: int = 0


class PrefetchExecutor:
    """Bounded-queue producer/consumer executor for one epoch.

    ``run(items)`` yields ``prepare(item)`` results in order while the
    worker thread stays up to ``depth`` items ahead.
    """

    def __init__(self, prepare: Callable[[Any], Any], depth: int = 2,
                 stats: Optional[PipelineStats] = None):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.prepare = prepare
        self.depth = depth
        self.stats = stats if stats is not None else PipelineStats()

    def run(self, items: Iterable[Any]) -> Iterator[Any]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        # (exception, formatted worker traceback) — the traceback OBJECT
        # rides on the exception itself; the string is belt-and-braces for
        # handlers that re-wrap and drop __traceback__
        error: list[tuple[BaseException, str]] = []

        def worker() -> None:
            try:
                for it in items:
                    t0 = time.perf_counter()
                    out = self.prepare(it)
                    self.stats.produce_s += time.perf_counter() - t0
                    while not stop.is_set():
                        try:
                            q.put(out, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced to the consumer
                error.append((e, traceback.format_exc()))
            finally:
                while not stop.is_set():
                    try:
                        q.put(_SENTINEL, timeout=0.05)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, name="hitgnn-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.stats.wait_s += time.perf_counter() - t0
                if item is _SENTINEL:
                    break
                self.stats.items += 1
                yield item
            if error:
                exc, worker_tb = error[0]
                if hasattr(exc, "add_note"):  # py311+: survives re-wrapping
                    exc.add_note("prefetch worker traceback:\n" + worker_tb)
                else:
                    exc.prefetch_worker_traceback = worker_tb
                # re-raising the caught object keeps the worker frames: its
                # __traceback__ is chained ahead of this raise site
                raise exc
        finally:
            stop.set()
            # drain so a blocked producer can observe the stop event
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


def prefetch(items: Iterable[Any], prepare: Callable[[Any], Any],
             depth: int = 2, stats: Optional[PipelineStats] = None
             ) -> Iterator[Any]:
    """Functional shorthand: ``PrefetchExecutor(prepare, depth).run(items)``."""
    return PrefetchExecutor(prepare, depth, stats).run(items)


class ReorderBuffer:
    """Sequence-numbered reorder buffer: out-of-order completions in,
    submission-order results out.

    The multi-process sampling service completes batches in whatever order
    its workers finish them; training consumes them in schedule order so a
    pipelined multi-worker epoch stays BIT-IDENTICAL to the single-process
    path. ``put(seq, item)`` accepts any completion and returns True;
    duplicate or already-consumed sequence numbers are DROPPED (False) —
    under speculative resubmission the same task legitimately completes
    twice (straggler + its speculative copy) and the first result wins;
    the payloads are bit-identical by the counter-based RNG argument, so
    dropping the loser changes nothing. ``pop()`` returns the next
    in-order item or None if it has not arrived yet."""

    def __init__(self, first_seq: int = 0):
        self._next = first_seq
        self._pending: dict[int, Any] = {}

    @property
    def next_seq(self) -> int:
        """Sequence number ``pop()`` is waiting on — the supervisor's
        head-of-line task for straggler detection."""
        return self._next

    def put(self, seq: int, item: Any) -> bool:
        if seq < self._next or seq in self._pending:
            return False
        self._pending[seq] = item
        return True

    def ready(self) -> bool:
        return self._next in self._pending

    def pop(self) -> Optional[Any]:
        """Next in-order item, or None if it has not arrived. Membership is
        checked explicitly so a legitimately-None ITEM still advances the
        sequence instead of wedging the buffer."""
        if self._next not in self._pending:
            return None
        item = self._pending.pop(self._next)
        self._next += 1
        return item

    def __len__(self) -> int:
        return len(self._pending)

"""Two-stage task scheduler (paper §5.1, Algorithm 3) + naive baseline
(copy of ``repro.core.scheduler``).

Stage 1: while every partition still has batches, device i executes
batches sampled from partition i. Stage 2: once some partitions are
exhausted, idle devices take extra batches from the remaining partitions
round-robin, so every synchronous iteration still runs p batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence


@dataclass
class Assignment:
    """One scheduled mini-batch: sampled from ``partition`` and executed on
    ``device`` during synchronous iteration ``iteration``."""

    iteration: int
    device: int
    partition: int
    batch_index: int  # index within the partition's epoch queue
    stage: int = 1


def two_stage_schedule(batches_per_partition: Sequence[int]
                       ) -> List[Assignment]:
    """Algorithm 3 for p partitions/devices (one device per partition)."""
    p = len(batches_per_partition)
    remaining = list(batches_per_partition)
    cursor = [0] * p
    out: List[Assignment] = []
    it = 0
    # Stage 1: every partition still non-empty -> device i <- partition i
    while all(r > 0 for r in remaining):
        for i in range(p):
            out.append(Assignment(it, i, i, cursor[i], stage=1))
            cursor[i] += 1
            remaining[i] -= 1
        it += 1
    # Stage 2: sample avail partitions round-robin; idle devices take extras
    cnt = 0
    while any(r > 0 for r in remaining):
        avail = [i for i in range(p) if remaining[i] > 0]
        idle = [i for i in range(p) if remaining[i] == 0]
        for i in avail:
            out.append(Assignment(it, i, i, cursor[i], stage=2))
            cursor[i] += 1
            remaining[i] -= 1
        for d in idle:
            src = avail[cnt % len(avail)]
            cnt += 1
            if remaining[src] <= 0:
                nonempty = [i for i in avail if remaining[i] > 0]
                if not nonempty:
                    break
                src = nonempty[cnt % len(nonempty)]
            out.append(Assignment(it, d, src, cursor[src], stage=2))
            cursor[src] += 1
            remaining[src] -= 1
        it += 1
    return out


def naive_schedule(batches_per_partition: Sequence[int]) -> List[Assignment]:
    """Baseline without workload balancing: device i only ever executes
    partition i's batches; iterations at the end run with idle devices."""
    p = len(batches_per_partition)
    out: List[Assignment] = []
    for it in range(max(batches_per_partition)):
        for i in range(p):
            if it < batches_per_partition[i]:
                out.append(Assignment(it, i, i, it, stage=0))
    return out


def iterations(schedule: List[Assignment]) -> Iterator[List[Assignment]]:
    """Group a schedule into synchronous iterations."""
    if not schedule:
        return
    n_it = max(a.iteration for a in schedule) + 1
    buckets: List[List[Assignment]] = [[] for _ in range(n_it)]
    for a in schedule:
        buckets[a.iteration].append(a)
    for b in buckets:
        yield b


class LoadBalancer:
    """Per-device work accounting under the ``round_robin`` policy: each
    batch runs on the schedule's static device, and the running per-device
    load (paper Eq. 5 estimate) feeds the ``load_imbalance`` metric. The
    reference's ``"load"`` policy waits for the sampler pool."""

    def __init__(self, num_devices: int):
        self.num_devices = num_devices
        self.load = [0.0] * num_devices

    def assign(self, assignments: Sequence[Assignment],
               loads: Sequence[float]) -> List[int]:
        """Device id per assignment for ONE synchronous iteration."""
        if len(assignments) > self.num_devices:
            raise ValueError("more batches than devices in one iteration")
        devices = [a.device for a in assignments]
        for j, d in enumerate(devices):
            self.load[d] += loads[j]
        return devices

    def imbalance(self) -> float:
        """max/mean running device load (1.0 = perfectly balanced)."""
        mean = sum(self.load) / max(1, len(self.load))
        return max(self.load) / mean if mean > 0 else 1.0


def schedule_stats(schedule: List[Assignment], p: int) -> dict:
    """Iteration count + device utilization; ``fill_slots`` counts the idle
    device slots, each of which runs a zero-weight fill batch."""
    n_it = max(a.iteration for a in schedule) + 1 if schedule else 0
    slots = n_it * p
    per_dev = [0] * p
    for a in schedule:
        per_dev[a.device] += 1
    return {"iterations": n_it, "batches": len(schedule),
            "utilization": len(schedule) / slots if slots else 1.0,
            "fill_slots": slots - len(schedule),
            "per_device_batches": per_dev}

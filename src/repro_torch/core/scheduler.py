"""Two-stage task scheduler (paper §5.1, Algorithm 3) + naive baseline
(copy of ``repro.core.scheduler``).

Stage 1: while every partition still has batches, device i executes
batches sampled from partition i. Stage 2: once some partitions are
exhausted, idle devices take extra batches from the remaining partitions
round-robin, so every synchronous iteration still runs p batches. The
``LoadBalancer`` then places each batch of an iteration on a device:
statically (``"round_robin"``) or by greedy LPT over the running loads
(``"load"``).
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


BALANCE_POLICIES = ("round_robin", "load")


class LoadBalancer:
    """Dynamic per-device work balancer (paper §4.2, Eq. 5).

    The two-stage scheduler fixes WHICH batches run together in a
    synchronous iteration; this balancer decides WHERE each lands once its
    sampled size is known. ``"round_robin"`` keeps the schedule's static
    device assignment. ``"load"`` runs greedy LPT over the epoch's running
    per-device load totals: the iteration's heaviest batch (by the
    :meth:`batch_load` estimate) goes to the least-loaded device,
    deterministic ties broken by index, so the assignment is a pure function
    of the batch stream and stays identical for any sampler-worker count or
    gather placement.
    """

    def __init__(self, num_devices: int, policy: str = "round_robin"):
        if policy not in BALANCE_POLICIES:
            raise ValueError(f"unknown balance_policy {policy!r}; "
                             f"expected one of {BALANCE_POLICIES}")
        self.num_devices = num_devices
        self.policy = policy
        self.load = [0.0] * num_devices

    @staticmethod
    def batch_load(work_estimate: float, miss_rows: int,
                   feat_dim: int) -> float:
        """Eq. 5 per-batch load including stage 2: the device step scales
        with the vertices updated + edges traversed
        (``MiniBatch.work_estimate``), and the batch additionally costs the
        gathered-feature elements that must cross the bus to its device —
        ``miss_rows * feat_dim`` (rows non-resident on the target device x
        the feature width). ``miss_rows`` comes from
        ``ResidencyCore.miss_count`` (or the worker's shipped-row count),
        so with a feature cache configured the term follows CACHE
        residency, not the static partition: load assignment tracks the
        real bus traffic as admissions move hot rows on-device. Without
        this term a batch landing on a device that caches none of its rows
        looks as cheap as one landing on the device that caches them
        all."""
        return float(work_estimate) + float(miss_rows) * float(feat_dim)

    def assign(self, assignments: Sequence[Assignment],
               loads: Sequence[float]) -> List[int]:
        """Device id per assignment for ONE synchronous iteration (at most
        one batch per device)."""
        if len(assignments) > self.num_devices:
            raise ValueError("more batches than devices in one iteration")
        if self.policy == "round_robin":
            devices = [a.device for a in assignments]
        else:
            by_weight = sorted(range(len(assignments)),
                               key=lambda j: (-loads[j], j))
            free = sorted(range(self.num_devices),
                          key=lambda d: (self.load[d], d))
            devices = [0] * len(assignments)
            for j, d in zip(by_weight, free):
                devices[j] = d
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

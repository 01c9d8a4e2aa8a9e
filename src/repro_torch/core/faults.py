"""Fault-injection harness for the supervised sampling service (copy of
``repro.core.faults``).

The supervisor in ``core/sampler_pool.py`` claims that worker crashes,
stragglers, ring-capacity overflows and payload corruption are all recovered
*bitwise invisibly* — resubmitted tasks re-execute the counter-based RNG
streams and produce identical payloads. That claim is only testable if the
faults can be produced on demand, deterministically, at named points in the
task stream. This module is that switchboard:

  * a :class:`FaultSpec` names WHICH faults fire and WHERE — parsed from a
    compact string (``GNNModelConfig.fault_spec`` or the
    ``HITGNN_FAULT_SPEC`` environment variable), so a fault scenario is one
    config knob away from any training run;
  * a :class:`FaultInjector` lives inside each sampler worker and decides,
    per task, whether a fault fires NOW. Firing is **one-shot across
    respawns**: each fault latches by creating a file (``O_CREAT|O_EXCL``,
    the atomic filesystem test-and-set) in a directory owned by the pool,
    so the respawned worker that re-executes the same task does NOT re-kill
    itself — exactly the transient-fault model the recovery path targets.
    Deterministic (every-attempt) faults are what the bounded-retry path
    surfaces as real errors instead.

Spec grammar (semicolon-separated faults)::

    spec  := fault (";" fault)*
    fault := kind [":" param] ["@" p "." e "." i] ["#" count]

    kill@0.0.3          kill -9 the worker about to run task (0, 0, 3)
    hang:1.5@0.0.2      sleep 1.5 s before running task (0, 0, 2)
    encode_overflow#8   ring-capacity overflow on the first 8 distinct tasks
    corrupt_slot@0.0.1  flip payload bytes after the CRC stamp on (0, 0, 1)

``@p.e.i`` targets one task id ``(partition, epoch, index)``; omitting it
makes the fault a wildcard that fires on the first ``count`` distinct tasks
any worker attempts (count defaults to 1). The task id is the supervisor's
in-flight key, NOT the sequence number — resubmissions of the same task
share the latch, which is what makes every fault one-shot.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

KINDS = ("kill", "hang", "encode_overflow", "corrupt_slot")

ENV_VAR = "HITGNN_FAULT_SPEC"


@dataclass(frozen=True)
class Fault:
    """One injected fault: ``kind`` from :data:`KINDS`, an optional target
    task id (None = wildcard), the hang duration for ``hang``, and how many
    distinct tasks a wildcard fault may hit."""

    kind: str
    task: Optional[Tuple[int, int, int]] = None
    hang_s: float = 0.0
    count: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {KINDS}")
        if self.kind == "hang" and self.hang_s <= 0:
            raise ValueError("hang fault needs a positive duration "
                             "(e.g. 'hang:1.5@0.0.2')")
        if self.count < 1:
            raise ValueError("fault count must be >= 1")


@dataclass(frozen=True)
class FaultSpec:
    """An ordered set of :class:`Fault` s, parseable from the spec string."""

    faults: Tuple[Fault, ...]

    @staticmethod
    def parse(text: str) -> "FaultSpec":
        faults = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            count = 1
            if "#" in part:
                part, c = part.rsplit("#", 1)
                count = int(c)
            task = None
            if "@" in part:
                part, t = part.split("@", 1)
                p, e, i = t.split(".")
                task = (int(p), int(e), int(i))
            hang_s = 0.0
            if ":" in part:
                part, param = part.split(":", 1)
                hang_s = float(param)
            faults.append(Fault(part, task, hang_s, count))
        if not faults:
            raise ValueError(f"empty fault spec {text!r}")
        return FaultSpec(tuple(faults))

    @staticmethod
    def from_env(env: str = ENV_VAR) -> Optional["FaultSpec"]:
        text = os.environ.get(env)
        return FaultSpec.parse(text) if text else None


def resolve_fault_spec(spec) -> Optional[FaultSpec]:
    """Config value -> FaultSpec: accepts None, a spec string, or an
    already-built FaultSpec; falls back to the ``HITGNN_FAULT_SPEC``
    environment variable when the config carries nothing."""
    if isinstance(spec, FaultSpec):
        return spec
    if isinstance(spec, str):
        return FaultSpec.parse(spec)
    if spec is None:
        return FaultSpec.from_env()
    raise TypeError(f"fault_spec must be None, str or FaultSpec, "
                    f"got {type(spec).__name__}")


class FaultInjector:
    """Worker-side firing engine over a shared latch directory.

    The pool creates one latch directory per run and every worker (original
    or respawned) builds an injector over it. ``fire(kind, task)`` returns
    the matching :class:`Fault` exactly once per (fault, task) across ALL
    workers and respawns — the latch is an ``O_CREAT|O_EXCL`` file create,
    atomic on every POSIX filesystem — or None when nothing fires."""

    def __init__(self, spec: FaultSpec, latch_dir: str):
        self.spec = spec
        self.latch_dir = latch_dir

    def _latch(self, name: str) -> bool:
        """Atomically claim latch ``name``; True exactly once."""
        try:
            fd = os.open(os.path.join(self.latch_dir, name),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.close(fd)
        return True

    def fire(self, kind: str, task: Tuple[int, int, int]) -> Optional[Fault]:
        for fi, f in enumerate(self.spec.faults):
            if f.kind != kind:
                continue
            if f.task is not None:
                if f.task != tuple(task):
                    continue
                if self._latch(f"{fi}"):
                    return f
                continue
            # wildcard: the task latches FIRST (so a resubmission of a task
            # that already consulted this fault never fires it again and
            # never burns budget), then claims one of `count` budget slots
            # first-come across all workers
            if not self._latch(f"{fi}-{task[0]}.{task[1]}.{task[2]}"):
                continue
            for n in range(f.count):
                if self._latch(f"{fi}-n{n}"):
                    return f
        return None

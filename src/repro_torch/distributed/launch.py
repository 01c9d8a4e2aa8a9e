"""One process per device: the launcher of the data-parallel trainer.

The reference runs its p device slots in one process, on a ``("data",)``
mesh of that process's devices. PyTorch's idiom is one process per device,
and ``spawn_data_parallel`` starts them: p spawned ranks, each joined to a
``torch.distributed`` group through a file rendezvous (no TCP port to race
for), each handed the data mesh and its device::

    def work(rank, mesh, device):
        with SyncGNNTrainer(graph, cfg, num_devices=2, mesh=mesh,
                            device=device) as tr:
            return tr.run_epoch()

    metrics = spawn_data_parallel(work, 2)      # one result a rank

A spawned rank imports ``fn`` by name, so ``fn`` lives at a module's top
level, and what it returns is pickled back to the caller: return numpy
arrays and Python values, not tensors.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.sharding import make_data_mesh


def _rank_main(rank: int, fn: Callable, nprocs: int, backend: str,
               devices: List[str], init_file: str, timeout_s: float,
               results) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=nprocs,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = make_data_mesh(nprocs, device.type)
        results.put((rank, fn(rank, mesh, device)))
    finally:
        dist.destroy_process_group()


def spawn_data_parallel(fn: Callable[[int, Any, torch.device], Any],
                        nprocs: int, *, backend: Optional[str] = None,
                        devices: Optional[Sequence[str]] = None,
                        init_file: Optional[str] = None,
                        timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, mesh, device)`` in ``nprocs`` spawned ranks of one
    process group and return their results in rank order.

    ``devices`` names each rank's device; by default rank r takes
    ``cuda:r``, which needs ``nprocs`` cards (name them explicitly to share
    one, e.g. ``["cuda:0", "cuda:0"]``, or ``["cpu"] * nprocs``). The
    backend defaults to ``"nccl"`` on CUDA devices and ``"gloo"`` on the
    CPU; gloo may be asked for on CUDA devices. ``init_file`` is the file
    rendezvous's path, which must not exist yet (default: one in a fresh
    temporary directory); ``timeout_s`` bounds every collective. A rank's
    exception ends the other ranks and is raised here."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if devices is None:
        have = torch.cuda.device_count()
        if nprocs > have:
            raise ValueError(
                f"{nprocs} ranks take cuda:0..cuda:{nprocs - 1} but "
                f"{have} CUDA device(s) are visible; pass devices= to "
                f"name each rank's device")
        devices = [f"cuda:{r}" for r in range(nprocs)]
    devices = [str(d) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"the ranks' devices must all be cuda or all cpu, "
                         f"got {devices}")
    if backend is None:
        backend = "nccl" if kinds == {"cuda"} else "gloo"
    if backend == "nccl" and kinds != {"cuda"}:
        raise ValueError("the nccl backend needs CUDA devices")
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="repro_torch_rdv_")
        init_file = os.path.join(tmp, "rendezvous")
    results = mp.get_context("spawn").SimpleQueue()
    got = {}

    def drain():
        while not results.empty():
            rank, value = results.get()
            got[rank] = value
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, backend, devices,
                              os.path.abspath(init_file), timeout_s,
                              results),
            nprocs=nprocs, join=False, start_method="spawn")
        # the ranks block on their pipe until their result is read, so it
        # is read while they run
        while not ctx.join(timeout=0.2):
            drain()
        drain()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    missing = sorted(set(range(nprocs)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [got[r] for r in range(nprocs)]

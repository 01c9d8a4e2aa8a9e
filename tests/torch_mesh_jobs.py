"""Training jobs that the mesh tests run twice: in the test process on one
device (``data_parallel=True``, the p slots in sequence) and in the
spawned ranks of ``repro_torch.distributed.launch.spawn_data_parallel``
(``mesh=``, one slot a rank). A spawned rank imports the function it runs
by name, so ``rank_jobs`` lives here, in a module without JAX.
``kill_and_resume`` (``checkpointed_twin`` then ``resume``), a
killed-and-resumed run beside its uninterrupted twin, serves these jobs,
the checkpoint tests and ``chip_smoke.py``.

A job is a dict: ``algo``, ``backend``, ``p``, ``kind`` (``"iterations"``:
the first ``n`` groups of the epoch schedule through ``run_iteration``;
``"epoch"``: ``epochs`` (default 1) ``run_epoch`` calls, with the cache's
counter, resident sets and generation when the trainer has a cache;
``"p3_exchange"``: the P3 layer-0 block of seeded batches by
``p3_all_to_all_feats`` and by ``assemble_p3_feats``; ``"checkpoint"``:
``kill_and_resume`` into a directory under ``dir``),
optional ``kw`` (trainer keywords), ``cfg`` (fields of the model
config over ``SMALL``) and ``params`` (numpy; default the port's seeded
init). Results hold numpy arrays and Python values only.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointing import Checkpointer

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition import get_partitioner
from repro_torch.core.trainer import ALGORITHMS, SyncGNNTrainer
from repro_torch.core.trainer import resident_payload
from repro_torch.data.graphs import synthetic_graph
from repro_torch.gnn.models import assemble_p3_feats, p3_all_to_all_feats
from repro_torch.nn.param import flatten

SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)
GRAPH = dict(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
# the epoch keys that hold no time: a mesh rank reports the one-process
# run's value of each
EPOCH_KEYS = ("loss", "acc", "lr", "grad_norm", "batches", "iterations",
              "utilization", "mesh_devices", "fill_slots",
              "vertices_traversed", "beta", "load_imbalance", "ring_bytes",
              "ring_bytes_per_iter", "cache_hit_rate", "miss_bytes",
              "miss_bytes_per_iter", "pool_respawns", "pool_degraded",
              "cache_enabled", "cache_admissions", "cache_evictions",
              "cache_refresh_bytes")

_GRAPH = {}


def graph():
    if not _GRAPH:
        _GRAPH["g"] = synthetic_graph(**GRAPH)
    return _GRAPH["g"]


def make_trainer(job, device, mesh=None) -> SyncGNNTrainer:
    cfg = GNNModelConfig("graphsage", aggregate_backend=job["backend"],
                         **{**SMALL, **job.get("cfg", {})})
    return SyncGNNTrainer(graph(), cfg, num_devices=job["p"],
                          algorithm=job["algo"], device=str(device),
                          params=job.get("params"), mesh=mesh,
                          data_parallel=mesh is None,
                          **job.get("kw", {}))


def _counted(calls, name, fn):
    def counted(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    return counted


def _params(tr):
    return [p.detach().cpu().numpy().copy() for p in flatten(tr.params)]


def _p3_exchange(job, device, mesh):
    """Each slot's block of ``n`` seeded batches: (by the exchange among
    the ranks, by ``assemble_p3_feats`` from the whole slice matrix), for
    this rank's slot (every slot's without a mesh: no exchange runs)."""
    g, p = graph(), job["p"]
    part_name, strategy = ALGORITHMS["p3"]
    store = FeatureStore(g, get_partitioner(part_name)(g, p, 0), strategy)
    shards = torch.from_numpy(store.build_shard_matrix()).to(device)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(job["n"]):
        for d in range(p):
            ids = rng.integers(0, g.num_vertices, 96).astype(np.int32)
            valid = rng.random(96) < 0.8
            ids[~valid] = 0
            if mesh is not None and d != mesh.get_local_rank("data"):
                continue
            batch = {k: torch.from_numpy(a).to(device) for k, a in
                     resident_payload(store.core, d, ids, valid).items()}
            batch["node_mask"] = [torch.from_numpy(valid).to(device)]
            f = g.features.shape[1]
            got = (p3_all_to_all_feats(shards[d], batch, f,
                                       mesh.get_group("data"))
                   if mesh is not None else None)
            want = assemble_p3_feats(shards, batch, f)
            out.append((None if got is None else got.cpu().numpy(),
                        want.cpu().numpy(),
                        store.gather_p3_full(ids, valid)))
    return out


def _cache_state(tr):
    return {"freq": tr.cache.freq.copy(), "generation": tr.cache.generation,
            "resident": [tr.store.core.resident_ids(d).copy()
                         for d in range(tr.num_devices)]}


def mid_epoch_step(directory, first_epoch_iterations: int) -> int:
    """The step rank 0 checkpointed at epoch 2's second iteration (the
    reference's fault-tolerance test resumes from the same one)."""
    for f in sorted(os.listdir(directory)):
        if not (f.startswith("ckpt_") and f.endswith(".json")) \
                or ".rank" in f:
            continue
        with open(os.path.join(directory, f)) as fh:
            meta = json.load(fh)
        if (meta["extra"]["iter_no"] > first_epoch_iterations
                and meta["extra"]["epoch_iter"] == 2):
            return int(meta["step"])
    raise AssertionError(f"{directory}: no checkpoint at epoch 2's second "
                         f"iteration")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def checkpointed_twin(make, directory, state, every: int = 1,
                      timed=None) -> dict:
    """The uninterrupted twin of a killed-and-resumed run: ``make(**kw)``
    builds a trainer that checkpoints into ``directory``, and it trains
    two epochs saving every ``every`` iterations. ``state(trainer)`` reads
    what a resumed run must share; ``timed(name, fn)`` (default ``fn()``)
    wraps the run as ``"twin"``. Returns the epoch metrics (``epochs``),
    the saves (``saves``), the state (``twin``) and the ``step`` of epoch
    2's second iteration."""
    timed = timed or (lambda name, fn: fn())
    with make(checkpoint_every=every) as tr:
        ms = timed("twin", lambda: tr.train(2))
        tr.checkpointer.wait()
        out = {"epochs": ms, "saves": list(tr.checkpointer.saves),
               "twin": state(tr)}
    out["step"] = mid_epoch_step(directory, ms[0]["iterations"])
    return out


def resume(make, step, state, timed=None) -> dict:
    """A fresh trainer from ``make()`` restores ``step`` (epoch 2's second
    iteration) and finishes the epoch (``run_epoch(resume=True)``, wrapped
    by ``timed`` as ``"resumed"``). Returns ``restore_s`` (the card
    synchronized around it), the epoch's metrics (``resumed_epoch``) and
    ``state`` of the trainer (``resumed``)."""
    timed = timed or (lambda name, fn: fn())
    with make() as tr:
        _sync(tr.device)
        t0 = time.perf_counter()
        got = tr.restore_checkpoint(step)
        _sync(tr.device)
        out = {"restore_s": time.perf_counter() - t0}
        if got != step or tr._epoch_iter != 2:
            raise AssertionError(f"restored step {got} at epoch iteration "
                                 f"{tr._epoch_iter}, asked {step} at 2")
        out["resumed_epoch"] = timed("resumed",
                                     lambda: tr.run_epoch(resume=True))
        out["resumed"] = state(tr)
    return out


def kill_and_resume(make, directory, state, every: int = 1,
                    timed=None) -> dict:
    """``checkpointed_twin``, then ``resume`` from its mid-epoch-2 step:
    both results in one dict."""
    out = checkpointed_twin(make, directory, state, every, timed)
    out.update(resume(make, out["step"], state, timed))
    return out


def _checkpoint(job, device, mesh):
    """``kill_and_resume`` with a checkpoint every iteration (the
    one-process run and the ranks each in a directory of their own under
    ``job["dir"]``): the step, both runs' parameters and cache state, and
    whether this rank's manifest differs from rank 0's at that step. Then,
    under a mesh, rank 1's newest manifest is torn (a kill during its
    write) and a fresh trainer restores the newest step without naming it
    and finishes the epoch: the step it restored and its parameters."""
    d = os.path.join(job["dir"], "one" if mesh is None else "mesh")
    kw = job.get("kw", {})

    def make(**extra):
        ck = Checkpointer(d, keep=1000)
        return make_trainer(dict(job, kw=dict(kw, checkpointer=ck, **extra)),
                            device, mesh)

    def state(tr):
        return (_params(tr),
                None if tr.cache is None else _cache_state(tr))

    r = kill_and_resume(make, d, state)
    out = {"step": r["step"]}
    for name in ("full", "resumed"):
        out[name], cache = r["twin" if name == "full" else name]
        if cache is not None:
            out[f"{name}_cache"] = cache
    metas = {}
    for f in os.listdir(d):
        if f.endswith(".json") and f.startswith("ckpt_"):
            with open(os.path.join(d, f)) as fh:
                metas[f] = json.load(fh)
    name0 = f"ckpt_{out['step']:08d}.json"
    rank = 0 if mesh is None else mesh.get_local_rank("data")
    mine = (name0 if rank == 0
            else f"ckpt_{out['step']:08d}.rank{rank}.json")
    out["own_manifest_differs"] = (
        metas[mine]["extra"] != metas[name0]["extra"])
    if mesh is None:
        return out
    with make() as tr:
        newest = max(m["step"] for m in metas.values())
        if rank == 1:
            with open(os.path.join(
                    d, f"ckpt_{newest:08d}.rank1.json"), "r+") as f:
                f.truncate(10)
        out["latest_step"] = tr.restore_checkpoint()
        out["newest_step"] = newest
        tr.run_epoch(resume=True)
        out["latest"] = _params(tr)
        if tr.cache is not None:
            out["latest_cache"] = _cache_state(tr)
    return out


def run_job(job, device="cpu", mesh=None) -> dict:
    if job["kind"] == "p3_exchange":
        return {"blocks": _p3_exchange(job, device, mesh)}
    if job["kind"] == "checkpoint":
        return _checkpoint(job, device, mesh)
    with make_trainer(job, device, mesh) as tr:
        if job["kind"] == "iterations":
            calls = {"sampled": 0, "slot_steps": 0}
            for name, attr in (("sampled", "_local_payload"),
                               ("slot_steps", "_slot_row")):
                setattr(tr, attr, _counted(calls, name, getattr(tr, attr)))
            groups = list(sched.iterations(tr.epoch_schedule()))[:job["n"]]
            steps = [tr.run_iteration(g) for g in groups]
            shard = tr._shard.cpu().numpy()
            return {"losses": [m["loss"] for m in steps],
                    "lrs": [m["lr"] for m in steps], "params": _params(tr),
                    "calls": calls, "groups": [len(g) for g in groups],
                    "shard_shape": shard.shape,
                    "shard_is_own_row": mesh is not None and np.array_equal(
                        shard, tr.store.build_shard_matrix()[
                            mesh.get_local_rank("data")])}
        ms = tr.train(job.get("epochs", 1))
        res = {"epoch": {k: ms[-1][k] for k in EPOCH_KEYS},
               "epochs": [{k: m[k] for k in EPOCH_KEYS} for m in ms],
               "stats": [(st.local_rows, st.host_rows, st.local_bytes,
                          st.host_bytes) for st in tr.store.stats],
               "params": _params(tr)}
        if tr.cache is not None:
            res["cache"] = _cache_state(tr)
        return res


def rank_jobs(rank, mesh, device, jobs):
    """A spawned rank's work: every job in turn, on the rank's device."""
    # the ranks share the host's cores with the other test processes
    torch.set_num_threads(1)
    return {key: run_job(job, device, mesh) for key, job in jobs.items()}

"""Training jobs that the mesh tests run twice: in the test process on one
device (``data_parallel=True``, the p slots in sequence) and in the
spawned ranks of ``repro_torch.distributed.launch.spawn_data_parallel``
(``mesh=``, one slot a rank). A spawned rank imports the function it runs
by name, so ``rank_jobs`` lives here, in a module without JAX.

A job is a dict: ``algo``, ``backend``, ``p``, ``kind`` (``"iterations"``:
the first ``n`` groups of the epoch schedule through ``run_iteration``;
``"epoch"``: ``epochs`` (default 1) ``run_epoch`` calls, with the cache's
counter, resident sets and generation when the trainer has a cache;
``"p3_exchange"``: the P3 layer-0 block of seeded batches by
``p3_all_to_all_feats`` and by ``assemble_p3_feats``),
optional ``kw`` (trainer keywords), ``cfg`` (fields of the model
config over ``SMALL``) and ``params`` (numpy; default the port's seeded
init). Results hold numpy arrays and Python values only.
"""
from __future__ import annotations

import numpy as np
import torch

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


def run_job(job, device="cpu", mesh=None) -> dict:
    if job["kind"] == "p3_exchange":
        return {"blocks": _p3_exchange(job, device, mesh)}
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
            res["cache"] = {
                "freq": tr.cache.freq.copy(),
                "generation": tr.cache.generation,
                "resident": [tr.store.core.resident_ids(d).copy()
                             for d in range(job["p"])]}
        return res


def rank_jobs(rank, mesh, device, jobs):
    """A spawned rank's work: every job in turn, on the rank's device."""
    # the ranks share the host's cores with the other test processes
    torch.set_num_threads(1)
    return {key: run_job(job, device, mesh) for key, job in jobs.items()}

"""The port's sampling service: the shared-memory graph and residency
(``repro_torch.data.graphs``, ``repro_torch.core.residency``), the
supervised worker pool (``repro_torch.core.sampler_pool``, a copy of the
reference's) and the trainer's pooled epochs.

* the shared graph and residency round-trip and unlink;
* the port pool's payloads (mini-batch arrays, layouts, shipped rows,
  ring bytes, loads) equal the reference ``SamplerPool``'s bit for bit
  from the same seed, and ``place_gathered`` equals the reference's;
* an epoch with 1 or 2 workers equals the in-process epoch bit for bit
  (epoch loss and acc, and every parameter), on every datapath, under the
  ``"load"`` and ``"round_robin"`` policies, with the gather in the
  workers and without, and on the resident path;
* a spawned worker maps no torch (nor jax);
* a killed worker, a corrupted slot, a straggler and the degraded mode
  are invisible to training;
* ``close()`` leaves no shared-memory segment behind.

Graphs are tiny (2^9 vertices, 8 targets a batch), so a pool starts in
well under a second."""
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.configs.gnn import PlatformConfig
from repro_torch.core.partition import get_partitioner
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.residency import ResidencyCore
from repro_torch.core.sampler import NeighborSampler
from repro_torch.core.sampler_pool import SamplerPool
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.data.graphs import Graph, synthetic_graph
from repro_torch.gnn.api import train
from repro_torch.kernels.layout import block_capacities
from repro_torch.nn.param import flatten

GRAPH = dict(scale=9, edge_factor=5, feat_dim=8, num_classes=4)
G = synthetic_graph(**GRAPH)
SMALL = dict(num_layers=2, hidden=8, fanouts=(3, 2), batch_targets=8)
BACKENDS = ("reference", "pallas", "pallas_edges", "pallas_fused")
FIELDS = ("nodes", "node_mask", "edge_src", "edge_dst", "edge_mask",
          "self_idx")


def _cfg(backend="pallas_edges"):
    return TCfg("graphsage", aggregate_backend=backend, **SMALL)


def _segment_names(pool):
    names = [a.name for a in pool._shared.spec.arrays.values()]
    names += [a.name for a in pool._ids_spec.values()]
    if pool._ring is not None:
        names.append(pool._ring.name)
    if pool._shared_res is not None:
        names += [pool._shared_res.spec.segment.name,
                  pool._shared_res.spec.meta.name]
    return names


def _assert_unlinked(names):
    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)


# -- shared memory -------------------------------------------------------------
def test_shared_graph_roundtrip_and_unlink():
    with G.to_shared() as sh:
        g2 = Graph.from_shared(sh.spec)
        for f in ("indptr", "indices", "features", "labels", "train_ids"):
            assert np.array_equal(getattr(g2, f), getattr(G, f)), f
        assert (g2.num_classes, g2.name) == (G.num_classes, G.name)
        assert sh.nbytes() >= G.features.nbytes
        assert np.array_equal(g2.in_degree(), np.diff(G.indptr))
        names = [a.name for a in sh.spec.arrays.values()]
        del g2
    _assert_unlinked(names)


def test_shared_residency_roundtrip_generations_and_unlink():
    core = ResidencyCore(100, 8, [np.array([1, 5, 9], np.int32),
                                  np.array([2, 3], np.int32)],
                         capacities=[4, 3])
    shared = core.to_shared()
    try:
        att = ResidencyCore.from_shared(shared.spec)
        assert [att.resident_ids(d).tolist() for d in range(2)] == \
            [[1, 5, 9], [2, 3]]
        assert att.generation == 0 and att.num_devices == 2
        ids = np.array([1, 2, 3, 5, 7], np.int32)
        assert att.miss_count(0, ids) == core.miss_count(0, ids) == 3
        core.set_resident(1, np.array([2, 3, 7], np.int32))
        core.publish_generation(1)
        att.wait_generation(1, timeout=5.0)
        assert att.resident_ids(1).tolist() == [2, 3, 7]
        with pytest.raises(ValueError, match="monotone"):
            core.publish_generation(0)
        with pytest.raises(ValueError, match="capacity"):
            core.set_resident(0, np.arange(5, dtype=np.int32))
        names = [shared.spec.segment.name, shared.spec.meta.name]
        del att
    finally:
        shared.close()
    _assert_unlinked(names)
    assert core._shared_mirror is None


# -- the pool against the reference's ------------------------------------------
def _port_pool(gather, workers=1, **kw):
    store = FeatureStore(G, get_partitioner("metis_like")(G, 2, 0),
                         "distdgl")
    cfg = _cfg()
    return SamplerPool(
        G, cfg, [G.train_ids[store.core.is_resident(d, G.train_ids)]
                 for d in range(2)], seed=3, num_workers=workers,
        agg_kind="mean", blk_caps=block_capacities(cfg),
        residency=store.core if gather else None, **kw), store


def _reference_pool(gather):
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.feature_store import FeatureStore as JStore
    from repro.core.partition import get_partitioner as j_partitioner
    from repro.core.sampler_pool import SamplerPool as JPool
    from repro.data.graphs import synthetic_graph as j_graph
    from repro.kernels.layout import block_capacities as j_caps
    g = j_graph(**GRAPH)
    store = JStore(g, j_partitioner("metis_like")(g, 2, 0), "distdgl")
    cfg = JCfg("graphsage", aggregate_backend="pallas_edges", **SMALL)
    return JPool(
        g, cfg, [g.train_ids[store.core.is_resident(d, g.train_ids)]
                 for d in range(2)], seed=3, num_workers=1, agg_kind="mean",
        blk_caps=j_caps(cfg), residency=store.core if gather else None)


TASKS = [(0, 1, 0), (1, 1, 1, 0), (0, 2, 2, 1), (1, 1, 0, 1)]


@pytest.mark.parametrize("gather", [False, True])
def test_pool_payloads_equal_the_reference_pool_bitwise(gather):
    port, _ = _port_pool(gather)
    ref = _reference_pool(gather)
    try:
        for t in TASKS:
            port.submit(*t)
            ref.submit(*t)
        for t in TASKS:
            a, b = port.fetch(timeout=60), ref.fetch(timeout=60)
            for f in FIELDS:
                for x, y in zip(getattr(a["minibatch"], f),
                                getattr(b["minibatch"], f)):
                    assert np.array_equal(x, y), (t, f)
            for f in ("targets", "labels"):
                assert np.array_equal(getattr(a["minibatch"], f),
                                      getattr(b["minibatch"], f)), f
            assert set(a["layout"]) == set(b["layout"])
            for k in a["layout"]:
                for x, y in zip(a["layout"][k], b["layout"][k]):
                    assert x.dtype == y.dtype
                    assert np.array_equal(x.view(np.uint8),
                                          y.view(np.uint8)), k
            assert (a["ring_bytes"], a["load"]) == (b["ring_bytes"],
                                                    b["load"])
            if gather:
                fa, fb = a["features"], b["features"]
                assert fa["device"] == fb["device"] == (t[3] if len(t) > 3
                                                        else t[0])
                assert np.array_equal(fa["pos"], fb["pos"])
                assert np.array_equal(fa["rows"].view(np.uint32),
                                      fb["rows"].view(np.uint32))
            else:
                assert a["features"] is None and b["features"] is None
    finally:
        port.close()
        ref.close()


def test_place_gathered_equals_the_reference():
    from repro.core.feature_store import FeatureStore as JStore
    from repro.core.partition import get_partitioner as j_partitioner
    from repro.data.graphs import synthetic_graph as j_graph
    g = j_graph(**GRAPH)
    jstore = JStore(g, j_partitioner("metis_like")(g, 3, 0), "distdgl")
    tstore = FeatureStore(G, get_partitioner("metis_like")(G, 3, 0),
                          "distdgl")
    gstore = FeatureStore(G, get_partitioner("metis_like")(G, 3, 0),
                          "distdgl")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, G.num_vertices, 64).astype(np.int32)
    valid = rng.random(64) < 0.8
    for ship_for in range(3):
        pos, rows = tstore.core.select_ship_rows(ship_for, G.features, ids,
                                                 valid)
        for dev in range(3):
            a = tstore.place_gathered(dev, ids, valid, pos, rows,
                                      shipped_for=ship_for)
            b = jstore.place_gathered(dev, ids, valid, pos, rows,
                                      shipped_for=ship_for)
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
            assert np.array_equal(a.view(np.uint32), gstore.gather(
                dev, ids, valid).view(np.uint32))
    for d in range(3):
        for st in (jstore.stats[d], gstore.stats[d]):
            assert (tstore.stats[d].host_rows, tstore.stats[d].local_rows,
                    tstore.stats[d].host_bytes) == (
                st.host_rows, st.local_rows, st.host_bytes)


# -- pooled epochs against the in-process epoch ------------------------------------
_TWINS = {}


def _run(backend, policy, data_parallel=False, epochs=1, **kw):
    t = TTrainer(G, _cfg(backend), num_devices=2, device="cpu", seed=7,
                 balance_policy=policy, data_parallel=data_parallel, **kw)
    try:
        ms = [t.run_epoch() for _ in range(epochs)]
        return ms, [q.clone() for q in flatten(t.params)], t._pool
    finally:
        t.close()


def _twin(backend, policy, data_parallel=False, epochs=1):
    key = (backend, policy, data_parallel, epochs)
    if key not in _TWINS:
        _TWINS[key] = _run(backend, policy, data_parallel, epochs,
                           pipeline=False)[:2]
    return _TWINS[key]


def _assert_same(got, twin):
    (ms, params), (tms, tparams) = got, twin
    for m, t in zip(ms, tms):
        assert (m["loss"], m["acc"]) == (t["loss"], t["acc"])
        assert m["vertices_traversed"] == t["vertices_traversed"]
        assert m["beta"] == t["beta"]
        assert m["load_imbalance"] == t["load_imbalance"]
    assert all(torch.equal(a, b) for a, b in zip(params, tparams))


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("policy", ["round_robin", "load"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_workers_equal_in_process_epoch(backend, policy, gather, workers):
    ms, params, _ = _run(backend, policy, num_sampler_workers=workers,
                         gather_in_workers=gather)
    _assert_same((ms, params), _twin(backend, policy))
    m = ms[0]
    assert (m["sampler_workers"], m["gather_in_workers"]) == (workers,
                                                              gather)
    assert m["ring_bytes_per_iter"] > 0 and not m["pool_degraded"]


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("policy", ["round_robin", "load"])
def test_resident_path_with_workers_equals_in_process(policy, gather):
    ms, params, _ = _run("pallas_fused", policy, data_parallel=True,
                         epochs=2, num_sampler_workers=2,
                         gather_in_workers=gather)
    _assert_same((ms, params), _twin("pallas_fused", policy, True, 2))
    assert ms[0]["mesh_devices"] == 2 and ms[0]["beta"] < 1.0


def test_spawned_worker_maps_no_torch():
    pool, _ = _port_pool(gather=True)
    try:
        pool.submit(0, 1, 0)
        pool.fetch(timeout=60)  # the worker has imported all it needs
        for p in pool._procs:
            with open(f"/proc/{p.pid}/maps") as f:
                maps = f.read()
            assert "numpy" in maps  # the scan sees the worker's libraries
            assert "/torch/" not in maps and "libtorch" not in maps
            assert "jaxlib" not in maps
    finally:
        pool.close()


def test_worker_arguments_fit_a_pipe_buffer():
    """A spawned worker's arguments cross a pipe that holds 64 KB; past it
    the parent waits for each child's start-up in turn. The train ids
    (26,214 of them at the paper's Reddit shape) travel through shared
    memory instead, so the arguments stay small for any train set."""
    import pickle
    store = FeatureStore(G, get_partitioner("metis_like")(G, 2, 0),
                         "distdgl")
    ids = (np.arange(30_000) * 7 % G.num_vertices).astype(np.int32)
    parts = [ids[:20_000], ids[20_000:]]
    pool = SamplerPool(G, _cfg(), parts, seed=3, num_workers=1,
                       residency=store.core)
    try:
        args = pool._worker_args(0)[:-3]  # the queues pickle at spawn only
        assert len(pickle.dumps(args)) < 16 << 10
        pool.submit(1, 1, 2)
        got = pool.fetch(timeout=60)["minibatch"]
        want = NeighborSampler(G, _cfg(), parts[1], 1, 3).batch_at(1, 2)
        for f in FIELDS:
            for x, y in zip(getattr(got, f), getattr(want, f)):
                assert np.array_equal(x, y), f
    finally:
        pool.close()


# -- faults --------------------------------------------------------------------
FAULTS = {
    "kill": dict(fault_spec="kill@0.1.1"),
    "corrupt_slot": dict(fault_spec="corrupt_slot@0.1.1"),
    "straggler": dict(fault_spec="hang:1.0@0.1.1", straggler_timeout_s=0.2),
    "degraded": dict(fault_spec="kill#8", max_respawns=1),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_injected_faults_are_invisible(fault):
    ms, params, pool = _run("pallas_edges", "round_robin", epochs=2,
                            num_sampler_workers=1, **FAULTS[fault])
    _assert_same((ms, params), _twin("pallas_edges", "round_robin",
                                     epochs=2))
    m = ms[0]
    if fault == "kill":
        assert m["pool_respawns"] == 1 and not m["pool_degraded"]
    elif fault == "corrupt_slot":
        assert m["pool_crc_failures"] == 1
    elif fault == "straggler":
        assert m["pool_speculative_launched"] >= 1
    else:
        assert ms[-1]["pool_degraded"]
        assert ms[-1]["pool_degraded_batches"] == ms[-1]["batches"]
    assert pool._closed  # the trainer's close() tore the service down


# -- lifecycle -------------------------------------------------------------------
def test_close_leaves_no_segment_behind():
    t = TTrainer(G, _cfg(), num_devices=2, device="cpu",
                 num_sampler_workers=2, gather_in_workers=True)
    t.run_epoch()
    names = _segment_names(t._pool)
    procs = list(t._pool._procs)
    assert len(names) == 5 + 2 + 1 + 2  # graph, train ids, ring, residency
    t.close()
    t.close()  # idempotent
    _assert_unlinked(names)
    assert not any(p.is_alive() for p in procs)


def test_train_result_closes_its_pool():
    with train(_cfg(), PlatformConfig(num_devices=2), graph=G, epochs=1,
               device="cpu", num_sampler_workers=1) as r:
        pool = r.trainer._pool
        names = _segment_names(pool)
        assert np.isfinite(r.final["loss"])
    assert r.trainer._pool is None
    _assert_unlinked(names)


def test_train_closes_the_trainer_on_error(monkeypatch):
    seen = {}
    close = TTrainer.close

    def spy(self):
        if self._pool is not None:
            seen["names"] = _segment_names(self._pool)
        close(self)
    monkeypatch.setattr(TTrainer, "close", spy)

    def boom(e, m):
        raise KeyboardInterrupt
    with pytest.raises(KeyboardInterrupt):
        train(_cfg(), PlatformConfig(num_devices=2), graph=G, epochs=2,
              device="cpu", num_sampler_workers=1, progress=boom)
    _assert_unlinked(seen["names"])

"""The port's feature cache (``repro_torch.core.feature_cache``) and its
trainer wiring against the reference's, on the CPU.

* The module, bitwise: the reference's ``FeatureCache`` and the port's,
  over stores of the same graph and partition and driven by the same
  ``observe`` / ``end_iteration`` / ``start_epoch`` calls, hold the same
  resident sets, counter, generation and accounting after every call.
* The trainer against the reference: 3 epochs, DistDGL and PaGraph at
  p = 2, capacity below the static share, refresh at epoch boundaries and
  every 2 iterations; losses within rtol 1e-5, every cache metric, the
  resident sets and the counter exactly equal after each epoch.
* Cached rows are copies: cache on is bitwise cache off (the host gather,
  and ``data_parallel`` at p = 2 and 4), the resident path bitwise the host
  gather with the same cache, and 2 sampler workers that gather bitwise 0
  workers, refreshes in the middle of an epoch included.
* P3 builds no cache; ``data_parallel`` refuses a mid-epoch refresh, and a
  negative cadence raises.

The reference is imported inside the tests that use it.
"""
import numpy as np
import pytest

from repro_torch.configs.gnn import CacheConfig
from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core.feature_cache import FeatureCache as TCache
from repro_torch.core.feature_store import FeatureStore as TStore
from repro_torch.core.partition import get_partitioner as t_partitioner
from repro_torch.core.sampler import NeighborSampler as TSampler
from repro_torch.core.trainer import ALGORITHMS
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.data import graphs as tgraphs
from repro_torch.nn.param import flatten

# the reference's test size (tests/test_feature_cache.py) for the module;
# the trainer runs a scale-9 graph with 8-target batches, so an epoch at
# p = 2 has 4 iterations and a cadence of 2 refreshes inside it
MODULE_GRAPH = dict(scale=8, edge_factor=5, feat_dim=8, num_classes=4)
GRAPH = dict(scale=9, edge_factor=5, feat_dim=8, num_classes=4)
SMALL = dict(num_layers=2, hidden=8, fanouts=(3, 2), batch_targets=8)
G = tgraphs.synthetic_graph(**GRAPH)
CAPACITY = 120      # about half of each device's static share at p = 2
RTOL = 1e-5
EPOCHS = 3
CACHE_KEYS = ("beta", "cache_enabled", "cache_hit_rate", "miss_bytes",
              "miss_bytes_per_iter", "cache_admissions", "cache_evictions",
              "cache_refresh_bytes")


def _cfg(**kw):
    return TCfg("graphsage", **{**SMALL, **kw})


def _same_bits(a, b) -> bool:
    return all(x.shape == y.shape and np.array_equal(
        x.view(np.uint32), y.view(np.uint32)) for x, y in zip(a, b))


def _params(tr):
    return [q.detach().numpy().copy() for q in flatten(tr.params)]


def _residency(store):
    return [store.core.resident_ids(d).copy() for d in range(store.p)]


def _assert_same_cache(a, b):
    """Two caches (either package) in the same state: resident sets,
    counter, generation and accounting."""
    assert a.generation == b.generation
    np.testing.assert_array_equal(a.freq, b.freq)
    for d in range(a.core.num_devices):
        np.testing.assert_array_equal(a.core.resident_ids(d),
                                      b.core.resident_ids(d))
        assert a.core.capacities[d] == b.core.capacities[d]
    for k in ("admissions_total", "evictions_total", "refresh_bytes_total",
              "refreshes", "admissions_epoch", "evictions_epoch",
              "refresh_bytes_epoch"):
        assert getattr(a, k) == getattr(b, k), k


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refresh_every", [0, 1, 2])
@pytest.mark.parametrize("algo", ["distdgl", "pagraph"])
def test_module_bitwise_the_reference(algo, refresh_every):
    from repro.core.feature_cache import FeatureCache as JCache
    from repro.core.feature_store import FeatureStore as JStore
    from repro.core.partition import get_partitioner as j_partitioner
    from repro.data import graphs as jgraphs
    part_name, strategy = ALGORITHMS[algo]
    jg = jgraphs.synthetic_graph(**MODULE_GRAPH)
    tg = tgraphs.synthetic_graph(**MODULE_GRAPH)
    js = JStore(jg, j_partitioner(part_name)(jg, 2, 0), strategy)
    ts = TStore(tg, t_partitioner(part_name)(tg, 2, 0), strategy)
    cap = min(ts.num_resident(d) for d in range(2)) // 2
    jc = JCache(js.core, jg.out_degree(), cap, refresh_every)
    tc = TCache(ts.core, tg.out_degree(), cap, refresh_every)
    _assert_same_cache(jc, tc)
    sampler = TSampler(tg, _cfg(batch_targets=4), tg.train_ids, 0, seed=0)
    it = 0
    try:
        for epoch in range(3):
            jc.start_epoch()
            tc.start_epoch()
            _assert_same_cache(jc, tc)
            for _ in range(3):
                for i in range(2):
                    mb = sampler.batch_at(epoch, 2 * (it % 3) + i)
                    jc.observe(mb.nodes[0], mb.node_mask[0])
                    tc.observe(mb.nodes[0], mb.node_mask[0])
                jc.end_iteration(it)
                tc.end_iteration(it)
                it += 1
                _assert_same_cache(jc, tc)
        assert tc.refreshes > 0 and tc.admissions_total > 0
    finally:
        jc.close()
        tc.close()


def test_module_validates_as_the_reference():
    ts = TStore(G, t_partitioner("metis_like")(G, 2, 0), "distdgl")
    deg = G.out_degree()
    with pytest.raises(ValueError, match="cache_capacity"):
        TCache(ts.core, deg, 0)
    with pytest.raises(ValueError, match="cache_refresh_every"):
        TCache(ts.core, deg, 8, refresh_every=-1)
    with pytest.raises(ValueError, match="one entry per vertex"):
        TCache(ts.core, deg[:-1], 8)
    shared = ts.core.to_shared()
    try:
        with pytest.raises(ValueError, match="before to_shared"):
            TCache(ts.core, deg, 8)
    finally:
        shared.close()


def test_close_joins_the_ranking_without_installing_it():
    ts = TStore(G, t_partitioner("metis_like")(G, 2, 0), "distdgl")
    cache = TCache(ts.core, G.out_degree(), 50, refresh_every=3)
    before = _residency(ts)
    cache.end_iteration(0)      # (0 + 2) % 3 != 0: nothing launched
    cache.end_iteration(1)      # launches generation 1's ranking
    assert cache._pending is not None
    cache.close()
    assert cache._pending is None and cache.generation == 0
    for a, b in zip(before, _residency(ts)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the trainer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refresh_every", [0, 2])
@pytest.mark.parametrize("algo", ["distdgl", "pagraph"])
def test_trainer_matches_the_reference(algo, refresh_every):
    import jax
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.trainer import SyncGNNTrainer as JTrainer
    from repro.data import graphs as jgraphs
    kw = dict(num_devices=2, algorithm=algo, pipeline=False,
              cache_capacity=CAPACITY, cache_refresh_every=refresh_every)
    jt = JTrainer(jgraphs.synthetic_graph(**GRAPH), JCfg("graphsage",
                                                         **SMALL), **kw)
    tt = TTrainer(G, _cfg(), device="cpu",
                  params=jax.tree.map(np.asarray, jt.params), **kw)
    try:
        _assert_same_cache(jt.cache, tt.cache)
        for _ in range(EPOCHS):
            jm, tm = jt.run_epoch(), tt.run_epoch()
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
            for k in CACHE_KEYS:
                assert tm[k] == jm[k], k
            assert tm["iterations"] == jm["iterations"]
            _assert_same_cache(jt.cache, tt.cache)
        assert tt.cache.refreshes == EPOCHS - 1 if refresh_every == 0 \
            else tt.cache.refreshes > EPOCHS
        assert tm["cache_admissions"] > 0
    finally:
        jt.close()
        tt.close()


def test_admission_reduces_miss_bytes_across_epochs():
    """The reference's property at the port: epoch 1 runs on the degree
    seed (capacity below the static share); after two epoch-boundary
    refreshes the frequency-admitted set cuts the miss bytes an iteration
    and raises the hit rate, and the refresh stream is admitted rows x f x
    4 bytes."""
    cap = min(TStore(G, t_partitioner("metis_like")(G, 2, 0),
                     "distdgl").num_resident(d) for d in range(2))
    with TTrainer(G, _cfg(), num_devices=2, device="cpu",
                  cache_capacity=cap) as tr:
        m1, m2, m3 = tr.train(EPOCHS)
    assert m2["cache_admissions"] > 0
    assert m3["miss_bytes_per_iter"] < m1["miss_bytes_per_iter"]
    assert m3["cache_hit_rate"] > m1["cache_hit_rate"]
    assert (m2["cache_refresh_bytes"]
            == m2["cache_admissions"] * G.features.shape[1] * 4)


# ---------------------------------------------------------------------------
# cached rows are copies: the math does not move
# ---------------------------------------------------------------------------

def _run(epochs=EPOCHS, **kw):
    """Epoch metrics, parameters, resident sets and counter of a run from
    the port's seeded parameters."""
    kw = {"num_devices": 2, "device": "cpu", **kw}
    cfg = kw.pop("cfg", _cfg())
    with TTrainer(G, cfg, **kw) as tr:
        ms = tr.train(epochs)
        return {"metrics": ms, "params": _params(tr),
                "residency": _residency(tr.store),
                "freq": None if tr.cache is None else tr.cache.freq.copy(),
                "generation": tr.store.core.generation,
                "stats": [(s.local_rows, s.host_rows, s.local_bytes,
                           s.host_bytes) for s in tr.store.stats],
                "shard_rows": (tr._shard.shape[-2] if tr._shard is not None
                               else None)}


@pytest.mark.parametrize("data_parallel,p", [(False, 2), (True, 2),
                                             (True, 4)])
@pytest.mark.parametrize("algo", ["distdgl", "pagraph"])
def test_cache_never_changes_training_math(algo, data_parallel, p):
    off = _run(algorithm=algo, num_devices=p, data_parallel=data_parallel)
    on = _run(algorithm=algo, num_devices=p, data_parallel=data_parallel,
              cache_capacity=CAPACITY // (p // 2))
    for a, b in zip(off["metrics"], on["metrics"]):
        assert (a["loss"], a["acc"]) == (b["loss"], b["acc"])
        assert not a["cache_enabled"] and b["cache_enabled"]
    assert _same_bits(off["params"], on["params"])
    assert on["generation"] == EPOCHS - 1
    if data_parallel:
        # the shard re-uploaded after each refresh holds the cache's rows
        assert on["shard_rows"] == CAPACITY // (p // 2)


@pytest.mark.parametrize("algo", ["distdgl", "pagraph"])
def test_resident_equals_the_host_gather(algo):
    """The resident path with a cache (refresh at epoch boundaries) is the
    host gather with the same cache: losses, parameters, every cache key,
    the accounting, the resident sets and the counter."""
    host = _run(algorithm=algo, cache_capacity=CAPACITY)
    res = _run(algorithm=algo, cache_capacity=CAPACITY, data_parallel=True)
    _assert_runs_equal(host, res, CACHE_KEYS + ("vertices_traversed",))


def _assert_runs_equal(a, b, keys):
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert (ma["loss"], ma["acc"]) == (mb["loss"], mb["acc"])
        for k in keys:
            assert ma[k] == mb[k], k
    assert _same_bits(a["params"], b["params"])
    assert a["stats"] == b["stats"]
    assert a["generation"] == b["generation"]
    np.testing.assert_array_equal(a["freq"], b["freq"])
    for x, y in zip(a["residency"], b["residency"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("data_parallel,refresh_every",
                         [(False, 2), (True, 0)])
def test_workers_that_gather_equal_none(data_parallel, refresh_every):
    """2 sampler workers that gather each batch's miss rows against the
    generation its task was stamped with train bitwise like 0 workers
    (the reference's ``test_midepoch_refresh_bit_identical_across_worker_
    counts``), with refreshes in the middle of the epoch on the host gather
    and at its boundaries under ``data_parallel``."""
    kw = dict(cache_capacity=CAPACITY, cache_refresh_every=refresh_every,
              data_parallel=data_parallel)
    seq = _run(pipeline=False, **kw)
    pooled = _run(num_sampler_workers=2, gather_in_workers=True, **kw)
    _assert_runs_equal(seq, pooled, CACHE_KEYS)
    assert pooled["metrics"][0]["gather_in_workers"]
    assert pooled["generation"] == seq["generation"] > (
        EPOCHS if refresh_every else EPOCHS - 2)


# ---------------------------------------------------------------------------
# refusals and bypasses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data_parallel", [False, True])
def test_p3_builds_no_cache(data_parallel):
    plain = _run(epochs=1, algorithm="p3", data_parallel=data_parallel)
    with TTrainer(G, _cfg(), num_devices=2, device="cpu", algorithm="p3",
                  data_parallel=data_parallel, cache_capacity=30) as tr:
        assert tr.cache is None
        m = tr.run_epoch()
        assert (m["loss"], m["acc"]) == (plain["metrics"][0]["loss"],
                                         plain["metrics"][0]["acc"])
        assert not m["cache_enabled"] and m["cache_admissions"] == 0
        assert _same_bits(_params(tr), plain["params"])


@pytest.mark.parametrize("spelling", ["field", "config"])
def test_data_parallel_refuses_a_midepoch_refresh(spelling):
    kw = (dict(cache_capacity=50, cache_refresh_every=2)
          if spelling == "field" else
          dict(cfg=_cfg(cache=CacheConfig(capacity=50, refresh_every=2))))
    cfg = kw.pop("cfg", _cfg())
    with pytest.raises(ValueError, match="mid-epoch cache refresh"):
        TTrainer(G, cfg, num_devices=2, device="cpu", data_parallel=True,
                 **kw)


def test_negative_refresh_cadence_raises():
    with pytest.raises(ValueError, match="cache_refresh_every"):
        TTrainer(G, _cfg(), num_devices=2, device="cpu",
                 cache_refresh_every=-1)
    with pytest.raises(ValueError, match="cache_refresh_every"):
        TTrainer(G, _cfg(cache=CacheConfig(capacity=10, refresh_every=-1)),
                 num_devices=2, device="cpu")


def test_trainer_fields_override_the_config():
    cfg = _cfg(cache=CacheConfig(capacity=10, refresh_every=3,
                                 ship_rows_cap=40))
    with TTrainer(G, cfg, num_devices=2, device="cpu", cache_capacity=20,
                  ship_rows_cap=50) as tr:
        assert tr.model_cfg.cache == CacheConfig(capacity=20,
                                                 refresh_every=3,
                                                 ship_rows_cap=50)
        assert tr.cache.capacity == 20 and tr.cache.refresh_every == 3
    # the initial parameters a run starts from do not depend on the cache
    assert _same_bits(_params(TTrainer(G, _cfg(), 2, device="cpu")),
                      _params(TTrainer(G, cfg, 2, device="cpu")))


@pytest.mark.parametrize("refresh_every", [0, 2])
def test_cache_replay_counts_what_the_trainer_reports(refresh_every):
    """``launch.cache_replay`` (the host-only replay without training)
    gives each epoch's hit rate and miss rows an iteration exactly as the
    trainer reports them."""
    from repro_torch.launch.cache_replay import replay
    rows = replay(G, _cfg(), 2, CAPACITY, refresh_every, EPOCHS)
    run = _run(cache_capacity=CAPACITY, cache_refresh_every=refresh_every)
    f = G.features.shape[1]
    for row, m in zip(rows, run["metrics"]):
        assert row["hit_rate"] == m["cache_hit_rate"]
        assert row["miss_rows_per_iter"] * f * 4 == m["miss_bytes_per_iter"]
        assert row["admissions"] == m["cache_admissions"]
    assert rows[-1]["generation"] == run["generation"]

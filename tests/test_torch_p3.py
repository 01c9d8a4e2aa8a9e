"""The port's P3 (``algorithm="p3"``) against the reference's.

P3 partitions the topology by hash and the features along their dimension:
every device holds its slice of every row (chunk ceil(f/p), the last one
short), so no row misses and beta is 1. Here, on the CPU:

* the copied host modules equal the reference's bit for bit: the hash and
  P3 partitions, the all-resident residency core and its shared spec
  (flags and slices only, no id buffer), every P3 feature-store call, and
  the (p, V, chunk) slice matrix;
* ``gnn.models.assemble_p3_feats`` (the one-card counterpart of the
  reference's ``p3_all_to_all_feats``) equals ``gather_p3_full`` bit for
  bit, +0.0 rows included, and the reference's all-to-all value for value;
* three iterations at p = 2 and 4 stay within rtol 1e-5 of the
  reference's (vmap) trainer, the tolerance of ``test_torch_trainer.py``;
* within the port, bit for bit: the resident path equals the host gather
  (losses, parameters, beta = 1, per-device accounting), and pipelined and
  pooled epochs equal their sequential twins, ``gather_in_workers`` with
  its full-row (``p3_full``) ring included.

The test marked ``gpu`` holds the block assembled on the card against
``gather_p3_full``. The card has no JAX, so the reference is imported only
by the tests that use it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core import scheduler as tsched
from repro_torch.core.feature_store import FeatureStore as TStore
from repro_torch.core.partition import get_partitioner as t_partitioner
from repro_torch.core.residency import ResidencyCore
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.core.trainer import resident_payload
from repro_torch.data import graphs as tgraphs
from repro_torch.gnn.models import assemble_p3_feats
from repro_torch.nn.param import flatten, params_to_numpy

SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)
# feat_dim 18 is no multiple of 4 (nor of 3 or 5): the last slice is short
GRAPH = dict(scale=10, edge_factor=6, feat_dim=18, num_classes=4)
G = tgraphs.synthetic_graph(**GRAPH)
RTOL = 1e-5
BACKENDS = ("reference", "pallas", "pallas_edges", "pallas_fused")


def _j_graph():
    from repro.data import graphs as jgraphs
    return jgraphs.synthetic_graph(**GRAPH)


def _stores(p, seed=0):
    """The reference's P3 FeatureStore and the port's, over the same graph
    and partition."""
    from repro.core.feature_store import FeatureStore as JStore
    from repro.core.partition import get_partitioner as j_partitioner
    jg = _j_graph()
    js = JStore(jg, j_partitioner("p3")(jg, p, seed), "p3")
    ts = TStore(G, t_partitioner("p3")(G, p, seed), "p3")
    return js, ts


def _batch_ids(seed, n=96, n_invalid=20):
    """Vertex ids as a layer-0 batch holds them: repeats allowed, the tail
    padding (invalid, id 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, G.num_vertices, n).astype(np.int32)
    mask = np.ones(n, bool)
    mask[n - n_invalid:] = False
    ids[~mask] = 0
    return ids, mask


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _stats(store):
    return [dataclasses.astuple(s) for s in store.stats]


# -- the host copies -------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("p", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("name", ["hash", "p3"])
def test_partition_bitwise(name, p, seed):
    from repro.core.partition import get_partitioner as j_partitioner
    jp = j_partitioner(name)(_j_graph(), p, seed)
    tp = t_partitioner(name)(G, p, seed)
    assert tp.assignment.dtype == jp.assignment.dtype == np.int32
    np.testing.assert_array_equal(tp.assignment, jp.assignment)
    assert (tp.num_parts, tp.strategy, tp.feature_dim_partitioned) == (
        jp.num_parts, jp.strategy, jp.feature_dim_partitioned)
    assert tp.feature_dim_partitioned == (name == "p3")


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
def test_residency_bitwise(p):
    js, ts = _stores(p)
    jc, tc = js.core, ts.core
    f = GRAPH["feat_dim"]
    chunk = -(-f // p)
    assert tc.num_devices == jc.num_devices == p
    ids, mask = _batch_ids(p)
    for d in range(p):
        assert tc.feature_slice(d) == jc.feature_slice(d) == slice(
            d * chunk, min(f, (d + 1) * chunk))
        assert tc.slice_width(d) == jc.slice_width(d)
        assert tc.num_resident(d) == jc.num_resident(d) == G.num_vertices
        assert tc.device_bytes(d) == jc.device_bytes(d)
        np.testing.assert_array_equal(tc.resident_ids(d),
                                      jc.resident_ids(d))
        assert tc.resident_ids(d).dtype == np.int32
        np.testing.assert_array_equal(tc.is_resident(d, ids),
                                      jc.is_resident(d, ids))
        for m in (mask, None):
            tpos, thit = tc.resident_positions(d, ids, m)
            jpos, jhit = jc.resident_positions(d, ids, m)
            assert tpos.dtype == jpos.dtype and thit.dtype == jhit.dtype
            np.testing.assert_array_equal(tpos, jpos)
            np.testing.assert_array_equal(thit, jhit)
        assert tc.miss_count(d, ids, mask) == jc.miss_count(d, ids, mask) == 0
        for full in (False, True):
            tmp, trows = tc.select_ship_rows(d, G.features, ids, mask, full)
            jmp, jrows = jc.select_ship_rows(d, G.features, ids, mask, full)
            assert tmp.dtype == jmp.dtype and trows.dtype == jrows.dtype
            np.testing.assert_array_equal(tmp, jmp)
            np.testing.assert_array_equal(_bits(trows), _bits(jrows))
        # the trainer's payload: every valid row is a hit at pos = id
        idx = resident_payload(tc, d, ids, mask)
        np.testing.assert_array_equal(idx["hit_idx"], np.flatnonzero(mask))
        np.testing.assert_array_equal(idx["hit_pos"], ids[mask])
        assert len(idx["miss_pos"]) == 0
    # the last slice is the short one, the others the chunk
    widths = [tc.slice_width(d) for d in range(p)]
    assert sum(widths) == f and widths[:-1] == [chunk] * (p - 1)


@pytest.mark.parametrize("p", [2, 4])
def test_shared_residency_p3_is_flags_only(p):
    js, ts = _stores(p)
    shared = ts.core.to_shared()
    jshared = js.core.to_shared()
    try:
        spec, jspec = shared.spec, jshared.spec
        assert spec.all_resident == jspec.all_resident == (True,) * p
        assert spec.slices == jspec.slices
        assert spec.offsets == jspec.offsets == (0,) * (p + 1)
        assert (spec.num_vertices, spec.feat_dim) == (jspec.num_vertices,
                                                      jspec.feat_dim)
        att = ResidencyCore.from_shared(spec)
        ids, mask = _batch_ids(0)
        for d in range(p):
            assert att.feature_slice(d) == ts.core.feature_slice(d)
            assert att.slice_width(d) == ts.core.slice_width(d)
            assert att.num_resident(d) == G.num_vertices
            np.testing.assert_array_equal(
                att.resident_positions(d, ids, mask)[0],
                ts.core.resident_positions(d, ids, mask)[0])
        del att
    finally:
        shared.close()
        jshared.close()


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_feature_store_bitwise(p):
    js, ts = _stores(p)
    f = GRAPH["feat_dim"]
    for seed in (0, 1):
        ids, mask = _batch_ids(seed)
        for d in range(p):
            # a device's own gather: its slice, zero-widened to f
            a, b = ts.gather(d, ids, mask), js.gather(d, ids, mask)
            assert a.shape == b.shape == (len(ids), f)
            np.testing.assert_array_equal(_bits(a), _bits(b))
            sl = ts.feature_slice[d]
            assert sl == js.feature_slice[d]
            np.testing.assert_array_equal(
                _bits(ts.gather_p3_slice(d, ids)),
                _bits(js.gather_p3_slice(d, ids)))
        a = ts.gather_p3_full(ids, mask)
        np.testing.assert_array_equal(_bits(a),
                                      _bits(js.gather_p3_full(ids, mask)))
        assert not np.signbit(a[~mask]).any()
        np.testing.assert_array_equal(_bits(ts.gather_p3_full(ids)),
                                      _bits(js.gather_p3_full(ids)))
        pos, rows = ts.core.select_ship_rows(0, G.features, ids, mask, True)
        for d in range(p):
            a = ts.place_gathered(d, ids, mask, pos, rows, p3_full=True,
                                  shipped_for=0)
            b = js.place_gathered(d, ids, mask, pos, rows, p3_full=True,
                                  shipped_for=0)
            np.testing.assert_array_equal(_bits(a), _bits(b))
            np.testing.assert_array_equal(
                _bits(a), _bits(ts.gather_p3_full(ids, mask)))
            js.gather_p3_full(ids, mask)  # keep the two stores' counts equal
        ts.account_p3_full(7)
        js.account_p3_full(7)
    assert _stats(ts) == _stats(js)
    assert ts.beta() == js.beta()
    for d in range(p):
        assert ts.beta(d) == js.beta(d)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_shard_matrix_bitwise(p):
    js, ts = _stores(p)
    chunk = -(-GRAPH["feat_dim"] // p)
    assert ts.shard_rows() == js.shard_rows() == G.num_vertices
    assert ts.shard_width() == js.shard_width() == chunk
    tm, jm = ts.build_shard_matrix(), js.build_shard_matrix()
    assert tm.shape == jm.shape == (p, G.num_vertices, chunk)
    np.testing.assert_array_equal(_bits(tm), _bits(jm))
    # row d holds slice d of every vertex; the last one's pad is +0.0
    full = np.concatenate(list(tm), axis=1)[:, :GRAPH["feat_dim"]]
    np.testing.assert_array_equal(_bits(full), _bits(G.features))
    assert not np.signbit(full[:, GRAPH["feat_dim"]:]).any()


# -- the block assembled from the slice matrix -----------------------------------
def _p3_batch(ts, ids, mask, device="cpu"):
    """The trainer's P3 index payload for one batch (any device: every row
    is a hit at pos = id) and the layer-0 mask."""
    idx = resident_payload(ts.core, 0, ids, mask)
    batch = {k: torch.from_numpy(idx[k]).to(device)
             for k in ("hit_idx", "hit_pos")}
    batch["node_mask"] = [torch.from_numpy(mask).to(device)]
    return batch


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_assembled_block_equals_gather_p3_full(p, seed):
    import jax
    import jax.numpy as jnp
    from repro.gnn import models as jm
    js, ts = _stores(p)
    shards = ts.build_shard_matrix()
    f = GRAPH["feat_dim"]
    ids, mask = _batch_ids(seed)
    got = assemble_p3_feats(torch.from_numpy(shards),
                            _p3_batch(ts, ids, mask), f).numpy()
    want = ts.gather_p3_full(ids, mask)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))  # signs too
    # the reference's all-to-all, each of the p devices serving its slice
    # of every batch, here device 0's batch
    ids_all = np.stack([ids] * p)
    valid_all = np.stack([mask.astype(np.float32)] * p)
    ref = jax.vmap(lambda vs: jm.p3_all_to_all_feats(
        vs, jnp.asarray(ids_all), jnp.asarray(valid_all), f, "data"),
        axis_name="data")(jnp.asarray(js.build_shard_matrix()))
    for d in range(p):
        np.testing.assert_array_equal(got, np.asarray(ref[d]))


def test_reference_block_carries_negative_zero():
    """Why the port writes +0.0 itself: the reference multiplies each
    gathered slice by the valid mask, which leaves -0.0 in an invalid row
    whose placeholder vertex has negative features."""
    import jax
    import jax.numpy as jnp
    from repro.gnn import models as jm
    js, ts = _stores(2)
    ids, mask = _batch_ids(0)
    f = GRAPH["feat_dim"]
    ref = jax.vmap(lambda vs: jm.p3_all_to_all_feats(
        vs, jnp.asarray(np.stack([ids] * 2)),
        jnp.asarray(np.stack([mask.astype(np.float32)] * 2)), f, "data"),
        axis_name="data")(jnp.asarray(js.build_shard_matrix()))
    got = assemble_p3_feats(torch.from_numpy(ts.build_shard_matrix()),
                            _p3_batch(ts, ids, mask), f).numpy()
    assert np.signbit(np.asarray(ref[0])[~mask]).any()
    assert not np.signbit(got[~mask]).any()


# -- training against the reference ----------------------------------------------
def _reference_trainer(p, backend):
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.trainer import SyncGNNTrainer as JTrainer
    return JTrainer(_j_graph(), JCfg("graphsage", aggregate_backend=backend,
                                     **SMALL),
                    num_devices=p, algorithm="p3", pipeline=False)


@pytest.mark.parametrize("data_parallel", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_three_iterations_match_reference(p, data_parallel):
    """Losses within rtol 1e-5 of the reference's trainer (its vmap path:
    its mesh needs p real devices), parameters as ``test_torch_trainer``
    holds them (Adam can step an entry whose gradient is round-off on both
    sides the full learning rate either way), beta and every device's
    accounting equal."""
    import jax
    from repro.core import scheduler as jsched
    jt = _reference_trainer(p, "pallas_edges")
    tt = TTrainer(G, TCfg("graphsage", aggregate_backend="pallas_edges",
                          **SMALL), num_devices=p, algorithm="p3",
                  device="cpu", data_parallel=data_parallel,
                  params=jax.tree.map(np.asarray, jt.params))
    np.testing.assert_array_equal(tt.partition.assignment,
                                  jt.partition.assignment)
    jgroups = list(jsched.iterations(jt.epoch_schedule()))[:3]
    tgroups = list(tsched.iterations(tt.epoch_schedule()))[:3]
    assert ([[dataclasses.astuple(a) for a in g] for g in jgroups]
            == [[dataclasses.astuple(a) for a in g] for g in tgroups])
    lrs = []
    for jg, tg in zip(jgroups, tgroups):
        j, t = jt.run_iteration(jg), tt.run_iteration(tg)
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=RTOL)
        assert t["vertices_traversed"] == j["vertices_traversed"]
        lrs.append(j["lr"])
    assert tt.store.beta() == jt.store.beta() == 1.0
    assert _stats(tt.store) == _stats(jt.store)
    bound = 2 * sum(lrs)
    for a, b in zip(flatten(params_to_numpy(tt.params)),
                    jax.tree.leaves(jt.params)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=bound)
        close = np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, close.mean()


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_ring_rows_cap_counts_every_valid_row(p, gather):
    """With the gather in the workers, P3's ring slot is sized from every
    valid layer-0 row (its workers ship full rows), as in the reference."""
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.trainer import SyncGNNTrainer as JTrainer
    jt = JTrainer(_j_graph(), JCfg("graphsage", **SMALL), num_devices=p,
                  algorithm="p3", pipeline=False, num_sampler_workers=1,
                  gather_in_workers=gather)
    tt = TTrainer(G, TCfg("graphsage", **SMALL), num_devices=p,
                  algorithm="p3", device="cpu", num_sampler_workers=1,
                  gather_in_workers=gather)
    assert tt._ring_rows_cap() == jt._ring_rows_cap()
    assert (tt._ring_rows_cap() is None) == (not gather)


# -- within the port, bit for bit ------------------------------------------------
def _pair(backend, p, **kw):
    """A P3 host-gather trainer and a resident one, from the same init."""
    cfg = TCfg("graphsage", aggregate_backend=backend, **SMALL)
    host = TTrainer(G, cfg, num_devices=p, algorithm="p3", device="cpu",
                    **kw)
    res = TTrainer(G, cfg, num_devices=p, algorithm="p3", device="cpu",
                   data_parallel=True, params=params_to_numpy(host.params),
                   **kw)
    return host, res


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("p", [2, 4])
def test_resident_equals_host_gather_bitwise(p, backend):
    host, res = _pair(backend, p)
    groups = list(tsched.iterations(host.epoch_schedule()))[:2]
    for it, g in enumerate(groups):
        mh, mr = host.run_iteration(g), res.run_iteration(g)
        assert mr["loss"] == mh["loss"] and mr["acc"] == mh["acc"]
        assert mr["miss_rows"] == 0
        assert (mr["shard_upload_s"] > 0) == (it == 0)
    for a, b in zip(flatten(host.params), flatten(res.params)):
        assert torch.equal(a, b)
    assert res.store.beta() == host.store.beta() == 1.0
    assert _stats(res.store) == _stats(host.store)
    assert res._shard.shape == (p, G.num_vertices,
                                -(-GRAPH["feat_dim"] // p))


def test_resident_path_gathers_no_block_on_the_host(monkeypatch):
    """No fallback: the resident P3 path calls neither host gather."""
    _, res = _pair("pallas_edges", 4)

    def no_gather(*a, **k):
        raise AssertionError("the resident path gathered on the host")
    for name in ("gather", "gather_p3_full", "place_gathered"):
        monkeypatch.setattr(res.store, name, no_gather)
    for g in list(tsched.iterations(res.epoch_schedule()))[:2]:
        assert np.isfinite(res.run_iteration(g)["loss"])


@pytest.mark.parametrize("policy", ["round_robin", "load"])
@pytest.mark.parametrize("p", [2, 3])
def test_epoch_accounting_equals_host_gather(p, policy):
    host, res = _pair("reference", p, balance_policy=policy)
    mh, mr = host.run_epoch(), res.run_epoch()
    for k in ("beta", "miss_bytes", "miss_bytes_per_iter", "cache_hit_rate",
              "vertices_traversed", "iterations", "fill_slots", "loss",
              "load_imbalance"):
        assert mr[k] == mh[k], k
    assert mr["beta"] == 1.0 and mr["miss_bytes"] == 0
    assert mr["cache_hit_rate"] == 1.0
    assert _stats(res.store) == _stats(host.store)


def _run(data_parallel, epochs=2, **kw):
    t = TTrainer(G, TCfg("graphsage", aggregate_backend="pallas_fused",
                         **SMALL), num_devices=2, algorithm="p3",
                 device="cpu", seed=5, data_parallel=data_parallel, **kw)
    try:
        ms = [t.run_epoch() for _ in range(epochs)]
        return ms, [q.clone() for q in flatten(t.params)], _stats(t.store)
    finally:
        t.close()


_TWINS = {}


def _twin(data_parallel):
    if data_parallel not in _TWINS:
        _TWINS[data_parallel] = _run(data_parallel, pipeline=False)
    return _TWINS[data_parallel]


def _assert_same(got, twin):
    (ms, params, stats), (tms, tparams, tstats) = got, twin
    for m, t in zip(ms, tms):
        assert (m["loss"], m["acc"]) == (t["loss"], t["acc"])
        assert m["vertices_traversed"] == t["vertices_traversed"]
        assert m["beta"] == t["beta"] == 1.0
    assert all(torch.equal(a, b) for a, b in zip(params, tparams))
    assert stats == tstats


@pytest.mark.parametrize("data_parallel", [False, True])
def test_pipelined_epochs_equal_sequential_bitwise(data_parallel):
    _assert_same(_run(data_parallel, pipeline=True), _twin(data_parallel))


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("data_parallel", [False, True])
def test_pooled_epochs_equal_sequential_bitwise(data_parallel, gather):
    got = _run(data_parallel, num_sampler_workers=2, gather_in_workers=gather)
    _assert_same(got, _twin(data_parallel))
    m = got[0][0]
    assert (m["sampler_workers"], m["gather_in_workers"]) == (2, gather)
    assert m["ring_bytes_per_iter"] > 0 and not m["pool_degraded"]


def test_pooled_gather_ships_full_rows():
    """Under P3 a worker that gathers ships every valid row (its full-row
    reconstruction): the ring carries more than the sampling alone."""
    plain = _run(False, epochs=1, num_sampler_workers=1)[0][0]
    full = _run(False, epochs=1, num_sampler_workers=1,
                gather_in_workers=True)[0][0]
    assert full["ring_bytes_per_iter"] > plain["ring_bytes_per_iter"]
    assert (full["loss"], full["acc"]) == (plain["loss"], plain["acc"])


# -- on the card ------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("p", [1, 4])
def test_assembled_block_on_card_equals_gather_p3_full(p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ts = TStore(G, t_partitioner("p3")(G, p, 0), "p3")
    shards = torch.from_numpy(ts.build_shard_matrix()).cuda()
    for seed in (0, 1):
        ids, mask = _batch_ids(seed)
        got = assemble_p3_feats(shards, _p3_batch(ts, ids, mask, "cuda"),
                                GRAPH["feat_dim"]).cpu().numpy()
        np.testing.assert_array_equal(_bits(got),
                                      _bits(ts.gather_p3_full(ids, mask)))

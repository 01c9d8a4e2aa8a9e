"""The port's host modules are bitwise copies of the reference's: from the
same seed they build the same graph, partition, batches, layouts, schedule
and gathered feature blocks (so parity of the two trainers comes down to
the device step)."""
import dataclasses

import numpy as np
import pytest

from repro.configs.gnn import GNNModelConfig as JCfg
from repro.core import scheduler as jsched
from repro.core.feature_store import FeatureStore as JStore
from repro.core.partition import get_partitioner as j_partitioner
from repro.core.sampler import NeighborSampler as JSampler
from repro.data import graphs as jgraphs
from repro.kernels import layout as jlayout

from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core import scheduler as tsched
from repro_torch.core.feature_store import FeatureStore as TStore
from repro_torch.core.partition import get_partitioner as t_partitioner
from repro_torch.core.sampler import NeighborSampler as TSampler
from repro_torch.data import graphs as tgraphs
from repro_torch.kernels import layout as tlayout

SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)


def _graphs(seed=0, scale=10):
    kw = dict(scale=scale, edge_factor=6, feat_dim=16, num_classes=4,
              seed=seed)
    return jgraphs.synthetic_graph(**kw), tgraphs.synthetic_graph(**kw)


def _assert_graph_equal(a, b):
    for f in ("indptr", "indices", "features", "labels", "train_ids"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.num_classes == b.num_classes and a.name == b.name


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_graph_bitwise(seed):
    _assert_graph_equal(*_graphs(seed))


def test_scaled_dataset_bitwise():
    _assert_graph_equal(jgraphs.scaled_dataset("reddit", scale=8, seed=1),
                        tgraphs.scaled_dataset("reddit", scale=8, seed=1))


@pytest.mark.parametrize("fanout", [1, 3, 10])
def test_sample_in_neighbors_bitwise(fanout):
    jg, _ = _graphs()
    frontier = np.random.default_rng(5).choice(jg.num_vertices, 100,
                                               replace=False)
    a = jgraphs.sample_in_neighbors(jg.indptr, jg.indices, frontier, fanout,
                                    np.random.default_rng(9))
    b = tgraphs.sample_in_neighbors(jg.indptr, jg.indices, frontier, fanout,
                                    np.random.default_rng(9))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["metis_like", "pagraph"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_partition_bitwise(name, p):
    jg, tg = _graphs()
    a = j_partitioner(name)(jg, p, 0)
    b = t_partitioner(name)(tg, p, 0)
    assert a.assignment.dtype == b.assignment.dtype
    np.testing.assert_array_equal(a.assignment, b.assignment)
    assert (a.num_parts, a.strategy) == (b.num_parts, b.strategy)


def _assert_batch_equal(a, b):
    for f in ("nodes", "node_mask", "edge_src", "edge_dst", "edge_mask",
              "self_idx"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.targets, b.targets)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert (a.partition_id, a.seq_no) == (b.partition_id, b.seq_no)


def _samplers(fanouts=(4, 3), batch=32):
    jg, tg = _graphs()
    kw = dict(SMALL, fanouts=fanouts, batch_targets=batch)
    ids = jg.train_ids[::2]
    return (JSampler(jg, JCfg("graphsage", **kw), ids, 1, 7),
            TSampler(tg, TCfg("graphsage", **kw), ids, 1, 7))


def test_sampler_batch_at_and_cursor_bitwise():
    js, ts = _samplers()
    for epoch, index in [(0, 0), (0, 1), (2, 0), (1, 1)]:
        _assert_batch_equal(js.batch_at(epoch, index),
                            ts.batch_at(epoch, index))
    # the cursor walks past an epoch boundary (a ragged tail batch included)
    for _ in range(2 * js.epoch_batches() + 1):
        assert js.batches_remaining() == ts.batches_remaining()
        _assert_batch_equal(js.next_batch(), ts.next_batch())
    assert (js.epoch, js._cursor) == (ts.epoch, ts._cursor)


def test_sampler_state_and_restore_bitwise():
    """``state`` / ``restore_state`` (the checkpoint's sampler cursors):
    the same state mid-epoch, and a fresh sampler of each package restored
    from the other's state continues with the same batches."""
    js, ts = _samplers()
    for _ in range(js.epoch_batches() + 2):
        js.next_batch()
        ts.next_batch()
    assert js.state() == ts.state()
    jr, tr = _samplers()
    jr.restore_state(ts.state())
    tr.restore_state(js.state())
    assert jr.state() == tr.state() == js.state()
    np.testing.assert_array_equal(jr._epoch_order, tr._epoch_order)
    for _ in range(js.epoch_batches()):
        want = js.next_batch()
        _assert_batch_equal(want, jr.next_batch())
        _assert_batch_equal(want, tr.next_batch())
        ts.next_batch()
    assert jr.state() == tr.state() == js.state() == ts.state()


@pytest.mark.parametrize("fanouts,batch", [((4, 3), 32), ((25, 10), 64)])
def test_block_capacities_and_layouts_bitwise(fanouts, batch):
    js, ts = _samplers(fanouts, batch)
    caps = jlayout.block_capacities(js.cfg)
    assert caps == tlayout.block_capacities(ts.cfg)
    mb = js.batch_at(0, 0)
    for kind in ("mean", "sum"):
        a = jlayout.build_layer_layouts(mb.edge_src, mb.edge_dst,
                                        mb.edge_mask, caps, kind,
                                        edge_stream=True)
        b = tlayout.build_layer_layouts(mb.edge_src, mb.edge_dst,
                                        mb.edge_mask, caps, kind,
                                        edge_stream=True)
        assert set(a) == set(b)
        for k in a:
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("fanouts,batch", [((4, 3), 32), ((25, 10), 64)])
def test_compact_layouts_bitwise(fanouts, batch):
    """The ``"pallas"`` layout (``edge_stream=False``): the compact
    triples of ``LAYOUT_KEYS``."""
    js, ts = _samplers(fanouts, batch)
    caps = jlayout.block_capacities(js.cfg)
    mb = js.batch_at(1, 0)
    assert tlayout.LAYOUT_KEYS == jlayout.LAYOUT_KEYS
    for kind in ("mean", "sum"):
        a = jlayout.build_layer_layouts(mb.edge_src, mb.edge_dst,
                                        mb.edge_mask, caps, kind)
        b = tlayout.build_layer_layouts(mb.edge_src, mb.edge_dst,
                                        mb.edge_mask, caps, kind)
        assert set(a) == set(b) == {f"agg_{k}" for k in tlayout.LAYOUT_KEYS}
        for k in a:
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype, k
                np.testing.assert_array_equal(x, y, err_msg=k)


def _edges(seed, n_src, n_dst, E, mask_p):
    rng = np.random.default_rng(seed)
    es = rng.integers(0, n_src, E).astype(np.int32)
    ed = rng.integers(0, n_dst, E).astype(np.int32)
    em = rng.random(E) < mask_p
    vals = rng.standard_normal(E).astype(np.float32)
    return es, ed, em, vals


@pytest.mark.parametrize("seed,mask_p,max_blk", [(0, 0.8, None),
                                                 (1, 0.0, None),
                                                 (2, 1.0, 4)])
def test_block_csr_and_densify_bitwise(seed, mask_p, max_blk):
    """``build_block_csr`` (dense tiles on the host) and
    ``densify_tiles_np`` (the compact triples densified), with repeated
    (src, dst) pairs, so that several edges share a cell."""
    es, ed, em, vals = _edges(seed, 300, 200, 900, mask_p)
    for v in (None, vals):
        a = jlayout.build_block_csr(es, ed, em, 300, 200, v, max_blk)
        b = tlayout.build_block_csr(es, ed, em, 300, 200, v, max_blk)
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)
    coo = jlayout.build_block_coo_pair(es, ed, em, 300, 200, vals)
    for s in ("", "_t"):
        args = (coo[f"tile_id{s}"], coo[f"tile_off{s}"], coo["val"],
                *coo[f"cols{s}"].shape)
        np.testing.assert_array_equal(tlayout.densify_tiles_np(*args),
                                      jlayout.densify_tiles_np(*args))


@pytest.mark.parametrize("fanouts,batch", [((4, 3), 32), ((25, 10), 1024)])
def test_layout_byte_helpers_match(fanouts, batch):
    cfg = JCfg("graphsage", **dict(SMALL, fanouts=fanouts,
                                   batch_targets=batch))
    caps = jlayout.block_capacities(cfg)
    assert tlayout.densified_tile_bytes(caps) == \
        jlayout.densified_tile_bytes(caps)
    for n_src, n_dst, max_blk, max_blk_t, e_cap in caps:
        args = (e_cap, -(-n_dst // 128), max_blk, -(-n_src // 128),
                max_blk_t)
        for fn in ("compact_layout_bytes", "edge_stream_layout_bytes",
                   "dense_layout_bytes"):
            assert getattr(tlayout, fn)(*args) == \
                getattr(jlayout, fn)(*args), fn


@pytest.mark.parametrize("seed,mask_p", [(0, 0.8), (1, 0.0), (2, 1.0)])
def test_block_coo_pair_bitwise(seed, mask_p):
    rng = np.random.default_rng(seed)
    n_src, n_dst, E = 300, 200, 900
    es = rng.integers(0, n_src, E).astype(np.int32)
    ed = rng.integers(0, n_dst, E).astype(np.int32)
    em = rng.random(E) < mask_p
    vals = rng.standard_normal(E).astype(np.float32)
    a = jlayout.build_block_coo_pair(es, ed, em, n_src, n_dst, vals,
                                     edge_stream=True)
    b = tlayout.build_block_coo_pair(es, ed, em, n_src, n_dst, vals,
                                     edge_stream=True)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _as_tuples(schedule):
    return [dataclasses.astuple(a) for a in schedule]


@pytest.mark.parametrize("counts", [[3], [4, 2, 5], [1, 0, 3, 2], [6, 6]])
def test_schedules_bitwise(counts):
    assert (_as_tuples(jsched.two_stage_schedule(counts))
            == _as_tuples(tsched.two_stage_schedule(counts)))
    assert (_as_tuples(jsched.naive_schedule(counts))
            == _as_tuples(tsched.naive_schedule(counts)))
    sched = jsched.two_stage_schedule(counts)
    a = [_as_tuples(g) for g in jsched.iterations(sched)]
    b = [_as_tuples(g) for g in tsched.iterations(
        tsched.two_stage_schedule(counts))]
    assert a == b
    assert (jsched.schedule_stats(sched, len(counts))
            == tsched.schedule_stats(tsched.two_stage_schedule(counts),
                                     len(counts)))


def test_load_balancer_round_robin_matches():
    rng = np.random.default_rng(0)
    ja = jsched.LoadBalancer(3, "round_robin")
    ta = tsched.LoadBalancer(3)
    for group in jsched.iterations(jsched.two_stage_schedule([4, 2, 5])):
        loads = rng.random(len(group)).tolist()
        tgroup = [tsched.Assignment(*dataclasses.astuple(a)) for a in group]
        assert ja.assign(group, loads) == ta.assign(tgroup, loads)
    assert ja.load == ta.load and ja.imbalance() == ta.imbalance()


@pytest.mark.parametrize("algo", ["distdgl", "pagraph"])
@pytest.mark.parametrize("p", [1, 2])
def test_feature_store_gather_bitwise(algo, p):
    jg, tg = _graphs()
    part = {"distdgl": "metis_like", "pagraph": "pagraph"}[algo]
    js = JStore(jg, j_partitioner(part)(jg, p, 0), algo)
    ts = TStore(tg, t_partitioner(part)(tg, p, 0), algo)
    js_, ts_ = _samplers()
    for epoch, i in [(0, 0), (0, 1), (1, 0)]:
        mb = js_.batch_at(epoch, i)
        for d in range(p):
            a = js.gather(d, mb.nodes[0], mb.node_mask[0])
            b = ts.gather(d, mb.nodes[0], mb.node_mask[0])
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for d in range(p):
        assert dataclasses.astuple(js.stats[d]) == \
            dataclasses.astuple(ts.stats[d])
        np.testing.assert_array_equal(js.core.resident_ids(d),
                                      ts.core.resident_ids(d))
    assert js.beta() == ts.beta()


@pytest.mark.parametrize("refresh_every", [0, 2])
@pytest.mark.parametrize("algo", ["distdgl", "pagraph"])
def test_feature_cache_and_cached_gather_bitwise(algo, refresh_every):
    """The copied feature cache: seeded, fed the same batches and
    refreshed on the same schedule, it leaves the reference's residency,
    counter and accounting, and the store gathers the same blocks with the
    same beta accounting through it."""
    from repro.core.feature_cache import FeatureCache as JCache
    from repro_torch.core.feature_cache import FeatureCache as TCache
    jg, tg = _graphs()
    part = {"distdgl": "metis_like", "pagraph": "pagraph"}[algo]
    js = JStore(jg, j_partitioner(part)(jg, 2, 0), algo)
    ts = TStore(tg, t_partitioner(part)(tg, 2, 0), algo)
    cap = min(ts.num_resident(d) for d in range(2)) // 3
    jc = JCache(js.core, jg.out_degree(), cap, refresh_every)
    tc = TCache(ts.core, tg.out_degree(), cap, refresh_every)
    js_, _ = _samplers(batch=8)
    try:
        for epoch in range(3):
            jc.start_epoch()
            tc.start_epoch()
            for it in range(2):
                for i in range(2):
                    mb = js_.batch_at(epoch, 2 * it + i)
                    for d in range(2):
                        a = js.gather(d, mb.nodes[0], mb.node_mask[0])
                        b = ts.gather(d, mb.nodes[0], mb.node_mask[0])
                        np.testing.assert_array_equal(a, b)
                    jc.observe(mb.nodes[0], mb.node_mask[0])
                    tc.observe(mb.nodes[0], mb.node_mask[0])
                jc.end_iteration(2 * epoch + it)
                tc.end_iteration(2 * epoch + it)
            np.testing.assert_array_equal(jc.freq, tc.freq)
            assert ((jc.generation, jc.refreshes, jc.admissions_epoch,
                     jc.evictions_epoch, jc.refresh_bytes_epoch)
                    == (tc.generation, tc.refreshes, tc.admissions_epoch,
                        tc.evictions_epoch, tc.refresh_bytes_epoch))
            for d in range(2):
                np.testing.assert_array_equal(js.core.resident_ids(d),
                                              ts.core.resident_ids(d))
                assert dataclasses.astuple(js.stats[d]) == \
                    dataclasses.astuple(ts.stats[d])
        assert tc.refreshes >= 2 and tc.admissions_total > 0
    finally:
        jc.close()
        tc.close()

"""The port's ``data_parallel`` feature path against the reference's.

Under ``SyncGNNTrainer(data_parallel=True)`` every simulated device's
resident feature rows stay in device memory, each batch ships its shard
positions and its miss rows, and the layer-0 block is assembled where the
shard lives (``gnn.models.assemble_device_feats``). Here, on the CPU:

* the copied residency and shard functions equal the reference's bitwise
  (DistDGL at p = 1 and 4, PaGraph at p = 3);
* the assembled block equals ``FeatureStore.gather`` bit for bit (+0.0 in
  every row that is neither a hit nor a miss) and the reference's
  ``assemble_device_feats`` value for value;
* at p = 1 the resident path gives the host-gather path's loss and
  parameter bits on every backend, and stays within rtol 1e-5 of the
  reference's ``data_parallel=True`` run; at p = 2 and 4 it stays within
  rtol 1e-5 of the reference's vmap path;
* beta and the miss accounting of ``run_epoch`` equal the host-gather
  path's exactly.

The test marked ``gpu`` holds the block assembled on the card against
``FeatureStore.gather``. The card has no JAX, so the reference is
imported only by the tests that use it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from jax_reference_shims import jax_shims  # noqa: F401  (a fixture)
from repro_torch.configs.gnn import CacheConfig
from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core import scheduler as tsched
from repro_torch.core.feature_store import FeatureStore as TStore
from repro_torch.core.partition import get_partitioner as t_partitioner
from repro_torch.core.trainer import ALGORITHMS
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.core.trainer import resident_payload
from repro_torch.data import graphs as tgraphs
from repro_torch.gnn.models import assemble_device_feats
from repro_torch.nn.param import flatten, params_to_numpy

SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)
GRAPH = dict(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
G = tgraphs.synthetic_graph(**GRAPH)
RTOL = 1e-5
BACKENDS = ("reference", "pallas", "pallas_edges", "pallas_fused")
# (algorithm, p): DistDGL with everything resident and with misses, PaGraph
# with its replicated hot set
STORES = [("distdgl", 1), ("distdgl", 4), ("pagraph", 3)]


def _stores(algo, p):
    """The reference's FeatureStore and the port's, over the same graph and
    partition."""
    from repro.core.feature_store import FeatureStore as JStore
    from repro.core.partition import get_partitioner as j_partitioner
    from repro.data import graphs as jgraphs
    part_name, strategy = ALGORITHMS[algo]
    jg = jgraphs.synthetic_graph(**GRAPH)
    js = JStore(jg, j_partitioner(part_name)(jg, p, 0), strategy)
    ts = TStore(G, t_partitioner(part_name)(G, p, 0), strategy)
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


@pytest.mark.parametrize("algo,p", STORES)
def test_shard_functions_bitwise(algo, p):
    js, ts = _stores(algo, p)
    assert ts.shard_rows() == js.shard_rows()
    assert ts.shard_width() == js.shard_width()
    jm, tm = js.build_shard_matrix(), ts.build_shard_matrix()
    assert tm.dtype == jm.dtype == np.float32
    assert tm.shape == jm.shape == (p, ts.shard_rows(), G.features.shape[1])
    np.testing.assert_array_equal(tm.view(np.uint32), jm.view(np.uint32))
    assert ts.core.capacities == js.core.capacities
    for d in range(p):
        assert ts.num_resident(d) == js.num_resident(d)
        assert ts.device_bytes(d) == js.device_bytes(d)
        np.testing.assert_array_equal(ts.resident_ids(d), js.resident_ids(d))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("algo,p", STORES)
def test_positions_and_ship_rows_bitwise(algo, p, seed):
    js, ts = _stores(algo, p)
    ids, mask = _batch_ids(seed)
    for d in range(p):
        jpos, jhit = js.core.resident_positions(d, ids, mask)
        tpos, thit = ts.core.resident_positions(d, ids, mask)
        assert tpos.dtype == jpos.dtype and thit.dtype == jhit.dtype
        np.testing.assert_array_equal(tpos, jpos)
        np.testing.assert_array_equal(thit, jhit)
        # the mask is optional in both
        np.testing.assert_array_equal(ts.core.resident_positions(d, ids)[0],
                                      js.core.resident_positions(d, ids)[0])
        jmp, jrows = js.core.select_ship_rows(d, G.features, ids, mask)
        tmp, trows = ts.core.select_ship_rows(d, G.features, ids, mask)
        assert tmp.dtype == jmp.dtype and trows.dtype == jrows.dtype
        np.testing.assert_array_equal(tmp, jmp)
        np.testing.assert_array_equal(trows.view(np.uint32),
                                      jrows.view(np.uint32))
        # the trainer's payload: hit rows and their shard rows from the
        # positions, the misses from the hit mask
        idx = resident_payload(ts.core, d, ids, mask)
        assert all(a.dtype == np.int64 for a in idx.values())
        np.testing.assert_array_equal(idx["miss_pos"], tmp)
        np.testing.assert_array_equal(idx["hit_idx"], np.flatnonzero(thit))
        np.testing.assert_array_equal(idx["hit_pos"], tpos[thit])
        np.testing.assert_array_equal(ts.resident_ids(d)[idx["hit_pos"]],
                                      ids[thit])


def _port_batch(ts, d, ids, mask, device="cpu"):
    """The port's assembly inputs for one batch on device d: the
    trainer's index payload, the shipped rows and the layer-0 mask."""
    idx = resident_payload(ts.core, d, ids, mask)
    batch = {k: torch.from_numpy(a).to(device) for k, a in idx.items()}
    batch["miss_rows"] = torch.from_numpy(
        G.features[ids[idx["miss_pos"]]]).to(device)
    batch["node_mask"] = [torch.from_numpy(mask).to(device)]
    return batch


def _assemble_both(js, ts, d, ids, mask):
    """(port's block, reference's block, hit mask, miss positions) for one
    batch on device d, from each package's own shard and payload."""
    import jax.numpy as jnp
    from repro.gnn import models as jm
    pos, hit = js.core.resident_positions(d, ids, mask)
    mpos, mrows = js.core.select_ship_rows(d, G.features, ids, mask)
    got = assemble_device_feats(
        torch.from_numpy(ts.build_shard_matrix()[d]),
        _port_batch(ts, d, ids, mask)).numpy()
    # the reference pads its miss segment to a static cap; pad entries land
    # in a discard row one past the batch
    cap = len(ids)
    mp = np.full(cap, len(ids), np.int32)
    mp[:len(mpos)] = mpos
    mr = np.zeros((cap, G.features.shape[1]), np.float32)
    mr[:len(mrows)] = mrows
    jbatch = {"shard_pos": pos, "shard_hit": hit.astype(np.float32),
              "miss_pos": mp, "miss_rows": mr}
    want = np.asarray(jm.assemble_device_feats(
        jnp.asarray(js.build_shard_matrix()[d]), jbatch))
    return got, want, hit, mpos


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("algo,p", STORES)
def test_assembled_block_equals_gather(algo, p, seed):
    js, ts = _stores(algo, p)
    ids, mask = _batch_ids(seed)
    for d in range(p):
        got, want, hit, mpos = _assemble_both(js, ts, d, ids, mask)
        gathered = ts.gather(d, ids, mask)
        assert got.shape == gathered.shape and got.dtype == np.float32
        # bit for bit, zero signs included
        np.testing.assert_array_equal(got.view(np.uint32),
                                      gathered.view(np.uint32))
        np.testing.assert_array_equal(got, want)
        other = ~hit
        other[mpos] = False
        assert other.any() and not np.signbit(got[other]).any()
        if p == 1:
            assert len(mpos) == 0


def test_assembled_block_of_misses_only():
    """A batch none of whose rows is resident on the device: every valid
    row is shipped, the shard is never read for a kept row."""
    js, ts = _stores("distdgl", 4)
    for d in range(4):
        away = np.flatnonzero(~ts.core.is_resident(
            d, np.arange(G.num_vertices)))[:40].astype(np.int32)
        ids = np.concatenate([away, np.zeros(8, np.int32)])
        mask = np.arange(len(ids)) < len(away)
        got, want, hit, mpos = _assemble_both(js, ts, d, ids, mask)
        assert not hit.any() and len(mpos) == len(away)
        np.testing.assert_array_equal(
            got.view(np.uint32), ts.gather(d, ids, mask).view(np.uint32))
        np.testing.assert_array_equal(got, want)
        assert not np.signbit(got[~mask]).any()


def test_reference_block_carries_negative_zero():
    """Why the port writes +0.0 itself: the reference multiplies the
    placeholder row by the hit mask, which leaves -0.0 where that row is
    negative. The two blocks are equal as values, not as bits."""
    js, ts = _stores("distdgl", 1)
    ids, mask = _batch_ids(0)
    got, want, hit, _ = _assemble_both(js, ts, 0, ids, mask)
    assert np.signbit(want[~hit]).any()
    assert not np.signbit(got[~hit]).any()


def _pair(backend, p, algo="distdgl", name="graphsage", **kw):
    """A host-gather trainer and a resident one, from the same init."""
    cfg = TCfg(name, aggregate_backend=backend, **SMALL)
    host = TTrainer(G, cfg, num_devices=p, algorithm=algo, device="cpu", **kw)
    res = TTrainer(G, cfg, num_devices=p, algorithm=algo, device="cpu",
                   data_parallel=True, params=params_to_numpy(host.params),
                   **kw)
    return host, res


@pytest.mark.parametrize("backend", BACKENDS)
def test_p1_resident_equals_host_gather_bitwise(backend):
    host, res = _pair(backend, 1)
    groups = list(tsched.iterations(host.epoch_schedule()))[:3]
    for it, g in enumerate(groups):
        mh, mr = host.run_iteration(g), res.run_iteration(g)
        assert mr["loss"] == mh["loss"] and mr["acc"] == mh["acc"]
        assert mr["miss_rows"] == 0
        assert (mr["shard_upload_s"] > 0) == (it == 0)
    for a, b in zip(flatten(host.params), flatten(res.params)):
        assert torch.equal(a, b)
    assert res.store.beta() == host.store.beta() == 1.0


def test_resident_path_gathers_no_block_on_the_host(monkeypatch):
    """No fallback: the resident path never calls the host gather, and the
    shard is built once."""
    _, res = _pair("pallas_edges", 2)

    def no_gather(*a, **k):
        raise AssertionError("the resident path gathered on the host")
    monkeypatch.setattr(res.store, "gather", no_gather)
    builds = []
    build = res.store.build_shard_matrix
    monkeypatch.setattr(res.store, "build_shard_matrix",
                        lambda: builds.append(1) or build())
    for g in list(tsched.iterations(res.epoch_schedule()))[:2]:
        assert np.isfinite(res.run_iteration(g)["loss"])
    assert builds == [1]
    assert res._shard.shape == (2, res.store.shard_rows(),
                                G.features.shape[1])


def _reference_trainer(backend, p, data_parallel, algo="distdgl"):
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.trainer import SyncGNNTrainer as JTrainer
    from repro.data.graphs import synthetic_graph
    return JTrainer(synthetic_graph(**GRAPH),
                    JCfg("graphsage", aggregate_backend=backend, **SMALL),
                    num_devices=p, algorithm=algo, pipeline=False,
                    data_parallel=data_parallel)


def _check_against_reference(jt, p, backend, algo="distdgl"):
    """Three iterations of the port's resident path against the reference
    trainer ``jt``, from its initial parameters: losses within rtol 1e-5,
    parameters as ``test_torch_trainer`` holds them (Adam can step an
    entry whose gradient is round-off on both sides the full learning rate
    either way)."""
    import jax
    from repro.core import scheduler as jsched
    params0 = jax.tree.map(np.asarray, jt.params)
    tt = TTrainer(G, TCfg("graphsage", aggregate_backend=backend, **SMALL),
                  num_devices=p, algorithm=algo, device="cpu",
                  data_parallel=True, params=params0)
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
    assert tt.store.beta() == jt.store.beta()
    bound = 2 * sum(lrs)
    for a, b in zip(flatten(params_to_numpy(tt.params)),
                    jax.tree.leaves(jt.params)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=bound)
        close = np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, close.mean()
    return tt


@pytest.mark.parametrize("backend", ["reference", "pallas_edges",
                                     "pallas_fused"])
def test_p1_matches_reference_data_parallel(backend, request):
    if backend == "pallas_fused":
        request.getfixturevalue("jax_shims")  # ROADMAP C.3
    jt = _reference_trainer(backend, 1, data_parallel=True)
    assert jt.mesh is not None
    _check_against_reference(jt, 1, backend)


@pytest.mark.parametrize("algo,p", [("distdgl", 2), ("distdgl", 4),
                                    ("pagraph", 4)])
def test_multi_device_matches_reference_vmap(algo, p):
    """The reference runs p > 1 devices only on a mesh of p real devices,
    so the port's resident path is held against its vmap path over the
    same batches."""
    jt = _reference_trainer("pallas_edges", p, data_parallel=False, algo=algo)
    tt = _check_against_reference(jt, p, "pallas_edges", algo)
    assert tt.store.beta() < 1.0


@pytest.mark.parametrize("algo,p", [("distdgl", 1), ("distdgl", 3),
                                    ("pagraph", 4)])
def test_epoch_accounting_equals_host_gather(algo, p):
    host, res = _pair("reference", p, algo)
    mh, mr = host.run_epoch(), res.run_epoch()
    for k in ("beta", "miss_bytes", "miss_bytes_per_iter", "cache_hit_rate",
              "vertices_traversed", "iterations", "fill_slots", "loss"):
        assert mr[k] == mh[k], k
    assert (mr["mesh_devices"], mh["mesh_devices"]) == (p, 0)
    assert (mr["beta"] < 1.0) == (p > 1)


def test_miss_cap_defaults_to_the_layer0_capacity():
    _, res = _pair("reference", 2)
    assert res._miss_cap == 32 * 4 * 5
    assert res._miss_stage.shape == (res._miss_cap, G.features.shape[1])
    cfg = TCfg("graphsage", cache=CacheConfig(ship_rows_cap=500), **SMALL)
    tr = TTrainer(G, cfg, num_devices=2, device="cpu", data_parallel=True)
    assert tr._miss_cap == 500


def test_batch_over_the_miss_cap_raises():
    cfg = TCfg("graphsage", cache=CacheConfig(ship_rows_cap=1), **SMALL)
    tr = TTrainer(G, cfg, num_devices=4, device="cpu", data_parallel=True)
    with pytest.raises(ValueError, match="miss rows to device"):
        tr.run_iteration(next(tsched.iterations(tr.epoch_schedule())))


@pytest.mark.parametrize("cap", [0, -3])
def test_ship_rows_cap_below_one_raises(cap):
    cfg = TCfg("graphsage", cache=CacheConfig(ship_rows_cap=cap), **SMALL)
    with pytest.raises(ValueError, match="ship_rows_cap must be >= 1"):
        TTrainer(G, cfg, num_devices=1, device="cpu", data_parallel=True)


@pytest.mark.gpu
@pytest.mark.parametrize("algo,p", [("distdgl", 1), ("distdgl", 4)])
def test_assembled_block_on_card_equals_gather(algo, p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    part_name, strategy = ALGORITHMS[algo]
    ts = TStore(G, t_partitioner(part_name)(G, p, 0), strategy)
    shard = torch.from_numpy(ts.build_shard_matrix()).cuda()
    ids, mask = _batch_ids(2)
    for d in range(p):
        got = assemble_device_feats(
            shard[d], _port_batch(ts, d, ids, mask, "cuda")).cpu().numpy()
        np.testing.assert_array_equal(
            got.view(np.uint32), ts.gather(d, ids, mask).view(np.uint32))

"""The port's serving runtime (``repro_torch.core.serving`` and the
``repro_torch.gnn.serve`` facade) against the reference's contracts and
against the reference itself.

On the CPU, at the sizes of ``tests/test_serving.py``:

* the reference's contracts, ported: the bucket ladder, request batches
  as pure functions of their coordinates, the pad/slice round trip, the
  coalescer's policy, no new build after warm-up, ``predict`` bitwise the
  eager forward over the request's batch, the pool path bitwise the
  in-process one (and, under an injected worker kill or straggler, the
  fault-free run), ``submit`` coalescing, a closed-loop load point, the
  facade and the lifecycle;
* against the reference on the same numpy inputs: ``bucket_ladder`` and the
  ``MicroBatcher``'s decisions equal, and the logits of ``predict`` request
  by request, warm-up included, within rtol 1e-5 / atol 1e-6 (fp32 sums
  and products taken in another order), for the four models on
  ``"reference"`` and ``"pallas_fused"`` (serving builds no kernel layout
  in either package, so both take the plain aggregation);
* ``evaluate`` against the reference's.

The tests marked ``gpu`` capture one CUDA graph a bucket and hold each
replay against the eager forward bit for bit; a capture that fails
raises. The reference is imported only inside the tests that use it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from jax_reference_shims import jax_shims  # noqa: F401
from torch_serving_truth import ground_truth
from repro_torch.configs.gnn import FaultConfig, GNNModelConfig
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition import get_partitioner
from repro_torch.core.sampler import (NeighborSampler, layer_capacities,
                                      layer_capacities_for, pad_minibatch,
                                      slice_minibatch)
from repro_torch.core.serving import (SERVE_EPOCH, MicroBatcher, ServeConfig,
                                      ServingRuntime, bucket_ladder,
                                      closed_loop_load)
from repro_torch.data.graphs import synthetic_graph
from repro_torch.gnn import models as gnn_models
from repro_torch.nn.param import (flatten, init_params, params_from_numpy,
                                  params_to_numpy)

RTOL, ATOL = 1e-5, 1e-6
GRAPH = dict(scale=8, edge_factor=5, feat_dim=8, num_classes=4)
G = synthetic_graph(**GRAPH)
CFG = GNNModelConfig("graphsage", num_layers=2, hidden=8, fanouts=(3, 2),
                     batch_targets=16)
CPU = "cpu"


def _params(cfg=CFG, seed=0):
    spec = gnn_models.param_spec(cfg, G.features.shape[1], G.num_classes)
    return init_params(spec, seed, CPU)


def _ids(lo, m):
    """``m`` train ids from the ``lo``-th on, wrapping around."""
    return G.train_ids[(lo + np.arange(m)) % len(G.train_ids)].astype(
        np.int32)


def _runtime(cfg=CFG, params=None, device=CPU, **serve_kw):
    return ServingRuntime(G, cfg, _params(cfg) if params is None else params,
                          serve_cfg=ServeConfig(**serve_kw), device=device)


# ---------------------------------------------------------------------------
# bucket ladder
# ---------------------------------------------------------------------------

def test_bucket_ladder_default_geometric_and_capped():
    assert bucket_ladder(16) == (8, 16)
    assert bucket_ladder(1024) == (8, 32, 128, 512, 1024)
    assert bucket_ladder(8) == (8,)
    assert bucket_ladder(4) == (4,)


def test_bucket_ladder_explicit_validated():
    assert bucket_ladder(64, [16, 4, 16]) == (4, 16)
    with pytest.raises(ValueError):
        bucket_ladder(64, [])
    with pytest.raises(ValueError):
        bucket_ladder(64, [128])  # above batch_targets
    with pytest.raises(ValueError):
        bucket_ladder(64, [0])


@pytest.mark.parametrize("batch_targets,buckets", [
    (1, None), (4, None), (8, None), (9, None), (16, None), (31, None),
    (32, None), (100, None), (1024, None), (4096, None),
    (64, [16, 4, 16]), (64, [1]), (64, [3, 3, 3]), (64, (64, 32)),
    (64, []), (64, [128]), (64, [0]), (64, [-1, 4])])
def test_bucket_ladder_matches_reference(batch_targets, buckets):
    from repro.core.serving import bucket_ladder as j_ladder

    def run(fn):
        try:
            return fn(batch_targets, buckets)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(bucket_ladder) == run(j_ladder)


# ---------------------------------------------------------------------------
# request batches: determinism + pad/slice round trip
# ---------------------------------------------------------------------------

def test_request_batch_pure_function_of_coordinates():
    s1 = NeighborSampler(G, CFG, G.train_ids, 0, seed=3)
    s2 = NeighborSampler(G, CFG, G.train_ids, 0, seed=3)
    tgt = np.asarray(G.train_ids[:5], np.int32)
    a = s1.request_batch(SERVE_EPOCH, 7, tgt)
    b = s2.request_batch(SERVE_EPOCH, 7, tgt)
    assert (a.targets == b.targets).all()
    for l in range(len(a.nodes)):
        assert (a.nodes[l] == b.nodes[l]).all()
    for l in range(len(a.edge_src)):
        assert (a.edge_src[l] == b.edge_src[l]).all()
        assert (a.edge_dst[l] == b.edge_dst[l]).all()
    # a different index is a different stream
    c = s1.request_batch(SERVE_EPOCH, 8, tgt)
    assert not all(a.nodes[l].shape == c.nodes[l].shape
                   and (a.nodes[l] == c.nodes[l]).all()
                   for l in range(len(a.nodes)))


def test_request_batch_validates_target_count():
    s = NeighborSampler(G, CFG, G.train_ids, 0, seed=3)
    with pytest.raises(ValueError):
        s.request_batch(0, 0, np.asarray([], np.int32))
    with pytest.raises(ValueError):
        s.request_batch(0, 0, np.asarray(G.train_ids[:17], np.int32))


def test_pad_slice_round_trip_bitwise():
    s = NeighborSampler(G, CFG, G.train_ids, 0, seed=3)
    tgt = np.asarray(G.train_ids[:8], np.int32)
    mb = s.request_batch(5, 2, tgt)
    n_caps, e_caps = layer_capacities(CFG)
    padded = pad_minibatch(mb, n_caps, e_caps)
    assert len(padded.targets) == CFG.batch_targets
    assert not padded.node_mask[0][len(mb.nodes[0]):].any()
    back = slice_minibatch(padded, *layer_capacities_for(8, CFG.fanouts))
    assert (back.targets == mb.targets).all()
    assert (back.labels == mb.labels).all()
    for l in range(len(mb.nodes)):
        assert (back.nodes[l] == mb.nodes[l]).all()
        assert (back.node_mask[l] == mb.node_mask[l]).all()
    for l in range(len(mb.edge_src)):
        assert (back.edge_src[l] == mb.edge_src[l]).all()
        assert (back.edge_dst[l] == mb.edge_dst[l]).all()
        assert (back.edge_mask[l] == mb.edge_mask[l]).all()
        assert (back.self_idx[l] == mb.self_idx[l]).all()


@pytest.mark.parametrize("algorithm,p", [("distdgl", 1), ("pagraph", 2),
                                         ("p3", 3)])
def test_gather_into_out_equals_fresh_gather(algorithm, p):
    """``FeatureStore.gather(out=)`` (the serving path's pinned staging
    buffer) writes the block ``gather`` returns, over stale contents, with
    the same accounting."""
    from repro_torch.core.trainer import ALGORITHMS
    part, store_name = ALGORITHMS[algorithm]
    partition = get_partitioner(part)(G, p, 0)
    a = FeatureStore(G, partition, store_name)
    b = FeatureStore(G, partition, store_name)
    mb = NeighborSampler(G, CFG, G.train_ids, 0, 0).request_batch(
        SERVE_EPOCH, 0, np.asarray(G.train_ids[:16], np.int32))
    for dev in range(p):
        want = a.gather(dev, mb.nodes[0], mb.node_mask[0])
        out = np.full_like(want, np.nan)
        got = b.gather(dev, mb.nodes[0], mb.node_mask[0], out=out)
        assert got is out
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert [dataclasses.astuple(s) for s in a.stats] == \
        [dataclasses.astuple(s) for s in b.stats]


# ---------------------------------------------------------------------------
# MicroBatcher policy
# ---------------------------------------------------------------------------

def test_microbatcher_bucket_for():
    mb = MicroBatcher([8, 32, 128], slo_s=0.05)
    assert mb.bucket_for(1) == 8
    assert mb.bucket_for(8) == 8
    assert mb.bucket_for(9) == 32
    assert mb.bucket_for(500) == 128  # oversized -> largest (caller chunks)


def test_microbatcher_flushes_when_largest_bucket_full():
    mb = MicroBatcher([4, 8], slo_s=10.0)
    mb.add("a", 4, deadline=1e9)
    assert not mb.due(now=0.0)  # huge SLO, not full: hold
    mb.add("b", 4, deadline=1e9)
    assert mb.due(now=0.0)
    assert mb.take() == ["a", "b"]
    assert mb.pending == 0


def test_microbatcher_flushes_on_slo_pressure():
    mb = MicroBatcher([8], slo_s=0.1, safety_frac=0.1)
    mb.observe(8, 0.02)
    mb.add("a", 1, deadline=100.0)
    # flush_at = deadline - est(0.02) - safety(0.01) = 99.97
    assert mb.flush_at() == pytest.approx(99.97)
    assert not mb.due(now=99.9)
    assert mb.due(now=99.98)


def test_microbatcher_take_leaves_overflow_pending():
    mb = MicroBatcher([4], slo_s=0.1)
    mb.add("a", 3, deadline=1.0)
    mb.add("b", 3, deadline=2.0)
    assert mb.take() == ["a"]  # b would overflow the 4-bucket
    assert mb.pending == 1
    assert mb.take() == ["b"]


def test_microbatcher_ewma_tracks_service_time():
    mb = MicroBatcher([8], slo_s=0.1)
    mb.observe(8, 0.10)
    mb.observe(8, 0.20)
    assert mb.estimate(8) == pytest.approx(0.7 * 0.10 + 0.3 * 0.20)


@pytest.mark.parametrize("seed", range(4))
def test_microbatcher_decisions_match_reference(seed):
    """The same seeded script of arrivals, service times, clock ticks and
    flushes through both batchers: every decision and estimate equal."""
    from repro.core.serving import MicroBatcher as JBatcher
    rng = np.random.default_rng(seed)
    buckets = sorted(set(int(b) for b in
                         rng.integers(1, 64, size=rng.integers(1, 5))))
    slo, safety = float(rng.uniform(0.01, 0.2)), float(rng.uniform(0, 0.3))
    a, b = MicroBatcher(buckets, slo, safety), JBatcher(buckets, slo, safety)
    now = 0.0
    for step in range(300):
        op = int(rng.integers(4))
        if op == 0:
            n = int(rng.integers(1, 2 * buckets[-1]))
            deadline = now + slo * float(rng.uniform(0.5, 1.5))
            a.add(step, n, deadline)
            b.add(step, n, deadline)
        elif op == 1:
            bk = buckets[int(rng.integers(len(buckets)))]
            s = float(rng.uniform(0, slo))
            a.observe(bk, s)
            b.observe(bk, s)
        elif op == 2:
            now += float(rng.uniform(0, slo / 4))
            assert a.due(now) == b.due(now)
            assert a.flush_at() == b.flush_at()
        else:
            assert a.take() == b.take()
        assert (a.pending, a.pending_targets) == (b.pending, b.pending_targets)
        assert [a.estimate(k) for k in buckets] == \
            [b.estimate(k) for k in buckets]
    for n in range(1, 2 * buckets[-1]):
        assert a.bucket_for(n) == b.bucket_for(n)


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

def test_runtime_predict_zero_steady_state_recompiles():
    with _runtime(num_workers=0) as rt:
        n = rt.warmup()
        assert n == len(rt.buckets)
        for m in (1, 3, 8, 11, 16):  # every bucket, odd sizes included
            out = rt.predict(np.asarray(G.train_ids[:m], np.int32))
            assert out.shape == (m, G.num_classes)
        big = np.asarray(G.train_ids[:23], np.int32)  # > largest bucket
        assert rt.predict(big).shape == (23, G.num_classes)
        assert rt.forward_compiles == n, "steady-state serving rebuilt"


def test_runtime_predict_matches_ground_truth_forward():
    """predict() equals running the forward over the request batch
    directly — the frontend adds padding and plumbing, no math."""
    with _runtime(num_workers=0) as rt:
        ids = np.asarray(G.train_ids[:6], np.int32)
        got = rt.predict(ids)
        want = ground_truth(rt, ids, rt._next_rid - 1)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_bucket_stats_are_medians_over_requests_since_reset():
    """Each bucket's stages are medians over the requests it served since
    the last reset; the request that built its forward is left out."""
    with _runtime(num_workers=0) as rt:
        rt.warmup()
        st = rt.bucket_stats()
        assert sorted(st) == list(rt.buckets)
        assert all(s["requests"] == 0 and s["service_ms"] is None
                   and s["build_ms"] > 0 for s in st.values())
        for _ in range(3):
            rt.predict(_ids(0, 5))
        st = rt.bucket_stats()
        assert st[8]["requests"] == 3 and st[16]["requests"] == 0
        s8 = rt._fwd[8].samples
        for k in ("sample_ms", "gather_ms", "forward_ms", "service_ms"):
            assert len(s8[k]) == 3
            assert st[8][k] == float(np.median(s8[k])) >= 0
        assert st[8]["upload_ms"] == 0.0  # the CPU uploads nothing
        assert st[8]["service_ms"] >= st[8]["sample_ms"]
        rt.reset_stats()
        assert rt.bucket_stats()[8]["requests"] == 0
        assert rt.forward_compiles == len(rt.buckets)


def test_runtime_pool_path_bitwise_equals_in_process():
    params = _params()
    ids_a = np.asarray(G.train_ids[:5], np.int32)
    ids_b = np.asarray(G.train_ids[5:17], np.int32)
    with _runtime(params=params, num_workers=0) as r0:
        want = [r0.predict(ids_a), r0.predict(ids_b)]
    with _runtime(params=params, num_workers=2) as r2:
        got = [r2.predict(ids_a), r2.predict(ids_b)]
    for w, g in zip(want, got):
        assert (w == g).all()


def test_runtime_submit_futures_coalesce_and_match_predict_values():
    with _runtime(num_workers=0, slo_ms=30.0) as rt:
        rt.warmup()
        futs = [rt.submit([int(v)]) for v in G.train_ids[:6]]
        outs = [f.result(timeout=60.0) for f in futs]
        assert all(o.shape == (1, G.num_classes) for o in outs)
        stats = rt.stats()
        assert stats["completed"] == 6  # warmup batches are not requests
        assert rt.forward_compiles == len(rt.buckets)
        assert all(np.isfinite(o).all() for o in outs)


def test_closed_loop_load_reports_point():
    with _runtime(num_workers=0) as rt:
        rt.warmup()
        pt = closed_loop_load(rt, G.train_ids, clients=2,
                              requests_per_client=3, ids_per_request=2)
        assert pt["requests"] == 6
        assert pt["offered_rps"] > 0
        assert pt["p99_ms"] >= pt["p50_ms"] >= 0
        assert 0.0 <= pt["slo_miss_rate"] <= 1.0
        assert rt.forward_compiles == len(rt.buckets)


def test_predict_after_close_raises():
    rt = _runtime(num_workers=0)
    rt.close()
    with pytest.raises(RuntimeError):
        rt.predict(np.asarray([0], np.int32))
    rt.close()  # idempotent


def test_runtime_serves_its_own_copy_of_the_parameters():
    """A tensor tree is copied onto the runtime's device, so a trainer
    stepping on (or a caller writing into its tensors) after serve()
    changes nothing served; a numpy tree serves the same bits."""
    params = _params()
    ids = np.asarray(G.train_ids[:4], np.int32)
    with _runtime(params=params) as a, \
            _runtime(params=params_to_numpy(params)) as b:
        for t in flatten(params):
            t.add_(1.0)
        assert np.array_equal(a.predict(ids), b.predict(ids))
        assert all(x.data_ptr() != y.data_ptr()
                   for x, y in zip(flatten(a.params), flatten(params)))


def test_runtime_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingRuntime(G, CFG, _params())
    from repro_torch.gnn import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(CFG, graph=G)


def test_stats_keys_match_reference():
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.serving import ServeConfig as JServeConfig
    from repro.core.serving import ServingRuntime as JRuntime
    from repro.data.graphs import synthetic_graph as j_graph
    jg = j_graph(**GRAPH)
    jcfg = JCfg("graphsage", num_layers=2, hidden=8, fanouts=(3, 2),
                batch_targets=16)
    params = _params()
    for workers in (0, 1):
        with JRuntime(jg, jcfg, params_to_numpy(params),
                      serve_cfg=JServeConfig(num_workers=workers)) as j, \
                _runtime(params=params, num_workers=workers) as t:
            assert set(t.stats()) == set(j.stats())


# ---------------------------------------------------------------------------
# logits against the reference, request by request
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "pallas_fused"])
@pytest.mark.parametrize("model", ["graphsage", "gcn", "gin", "gat"])
def test_predict_matches_reference_request_by_request(model, backend,
                                                      request):
    """The reference's ``ServingRuntime`` and the port's on the CPU, from
    the reference's parameters carried across as numpy: the warm-up
    batches (one a bucket, request ids 0 and 1) and then every request
    agree within rtol 1e-5 / atol 1e-6."""
    import jax

    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.serving import ServeConfig as JServeConfig
    from repro.core.serving import ServingRuntime as JRuntime
    from repro.data.graphs import synthetic_graph as j_graph
    from repro.gnn import models as j_models
    from repro.nn.param import materialize
    if model == "gin":  # the reference's GIN needs the shim (ROADMAP C.2)
        request.getfixturevalue("jax_shims")
    shape = dict(num_layers=2, hidden=8, fanouts=(3, 2), batch_targets=16,
                 aggregate_backend=backend)
    jcfg, tcfg = JCfg(model, **shape), GNNModelConfig(model, **shape)
    jg = j_graph(**GRAPH)
    spec = j_models.param_spec(jcfg, jg.features.shape[1], jg.num_classes)
    np_params = jax.tree.map(np.asarray, materialize(spec,
                                                     jax.random.PRNGKey(0)))
    anchor = int(G.train_ids[0])
    reqs = [_ids(lo, m) for lo, m in ((0, 1), (3, 5), (10, 8), (20, 11),
                                      (7, 16), (12, 23))]
    with JRuntime(jg, jcfg, np_params,
                  serve_cfg=JServeConfig(num_workers=0)) as j, \
            _runtime(tcfg, params_from_numpy(np_params, CPU)) as t:
        for b in t.buckets:  # what warmup() runs, kept to compare
            full = np.full(b, anchor, np.int32)
            np.testing.assert_allclose(t._serve_targets(full),
                                       j._serve_targets(full),
                                       rtol=RTOL, atol=ATOL)
        assert t._next_rid == j._next_rid == len(t.buckets)
        for ids in reqs:
            np.testing.assert_allclose(t.predict(ids), j.predict(ids),
                                       rtol=RTOL, atol=ATOL)
        assert t.forward_compiles == len(t.buckets)


# ---------------------------------------------------------------------------
# the facades
# ---------------------------------------------------------------------------

def test_serve_facade_materializes_params_and_warms_up():
    from repro_torch.gnn import serve
    with serve(CFG, graph=G, params=None, num_workers=0, buckets=(4, 16),
               device=CPU) as server:
        assert server.buckets == (4, 16)
        assert server.forward_compiles == 2  # warmed up
        out = server.predict(np.asarray(G.train_ids[:2], np.int32))
        assert out.shape == (2, G.num_classes)
        want = init_params(gnn_models.param_spec(
            CFG, G.features.shape[1], G.num_classes), 0, CPU)
        assert all(torch.equal(a, b) for a, b in
                   zip(flatten(server.params), flatten(want)))


def test_serve_facade_rejects_unknown_algorithm():
    from repro_torch.gnn import serve
    with pytest.raises(ValueError, match="unknown algorithm 'nope'"):
        serve(CFG, graph=G, algorithm="nope", device=CPU)


def test_serve_facade_closes_the_runtime_when_warmup_raises(monkeypatch):
    from repro_torch.gnn import serve
    closed = []

    def boom(self):
        raise RuntimeError("warm-up failed")
    monkeypatch.setattr(ServingRuntime, "warmup", boom)
    monkeypatch.setattr(ServingRuntime, "close",
                        lambda self: closed.append(self))
    with pytest.raises(RuntimeError, match="warm-up failed"):
        serve(CFG, graph=G, device=CPU)
    assert len(closed) == 1


def test_package_exports_the_facades_lazily():
    import repro_torch.gnn as tgnn
    from repro_torch.gnn import api, serving
    assert tgnn.GNNServer is ServingRuntime is serving.ServingRuntime
    assert tgnn.serve is serving.serve
    assert (tgnn.train, tgnn.TrainResult, tgnn.evaluate) == \
        (api.train, api.TrainResult, api.evaluate)
    with pytest.raises(AttributeError):
        tgnn.nope


def test_evaluate_matches_reference():
    """``evaluate`` keeps the reference's keys of the last epoch's
    metrics, in its order and with its values."""
    from repro.gnn.api import TrainResult as JResult
    from repro.gnn.api import evaluate as j_evaluate
    from repro_torch.configs.gnn import PlatformConfig
    from repro_torch.gnn import evaluate, train
    with train(CFG, PlatformConfig(num_devices=2), graph=G, epochs=2,
               device=CPU) as result:
        got = evaluate(result)
        want = j_evaluate(JResult(trainer=None, epochs=result.epochs))
    assert list(got) == list(want) == ["loss", "acc", "nvtps", "beta",
                                       "utilization", "epoch_time_s"]
    assert got == want == {k: result.epochs[-1][k] for k in got}
    assert evaluate(type(result)(trainer=result.trainer)) == {}


def test_serve_after_train_answers_from_the_trained_parameters():
    from repro_torch.configs.gnn import PlatformConfig
    from repro_torch.gnn import serve, train
    ids = np.asarray(G.train_ids[:5], np.int32)
    with train(CFG, PlatformConfig(), graph=G, epochs=1,
               device=CPU) as result:
        with serve(CFG, graph=G, params=result.params,
                   device=CPU) as server:
            got = server.predict(ids)
            want = ground_truth(server, ids, server._next_rid - 1)
            assert all(torch.equal(a, b) for a, b in zip(
                flatten(server.params), flatten(result.params)))
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# chaos: the request path under fault injection
# ---------------------------------------------------------------------------

def _chaos_run(fault_cfg):
    """Same request sequence against a fault-free and a faulted runtime;
    returns (clean_logits, faulted_logits, faulted_stats)."""
    params = _params()
    reqs = [np.asarray(G.train_ids[i:i + 3], np.int32) for i in range(4)]
    with _runtime(params=params, num_workers=1) as clean:
        want = [clean.predict(r) for r in reqs]
    with _runtime(fault_cfg, params=params, num_workers=1) as rt:
        got = [rt.predict(r) for r in reqs]
        stats = rt.stats()
    return want, got, stats


def test_serving_survives_worker_kill_bitwise():
    """A killed sampler worker mid-request: the pool respawns and
    resubmits, the request completes (late, not lost), and every response
    is bitwise equal to the fault-free run."""
    cfg = dataclasses.replace(CFG, fault=FaultConfig(fault_spec="kill#1"))
    want, got, stats = _chaos_run(cfg)
    for w, g in zip(want, got):
        assert (w == g).all()
    assert stats["pool"]["respawns"] == 1
    assert stats["completed"] == len(want)  # every request completed
    assert not stats["pool_degraded"]


def test_serving_survives_straggler_with_speculation_bitwise():
    """A hung worker mid-request: speculation re-executes on the healthy
    path; responses stay bitwise equal and no request errors."""
    cfg = dataclasses.replace(CFG, fault=FaultConfig(
        fault_spec="hang:0.8#1", straggler_timeout_s=0.2))
    want, got, stats = _chaos_run(cfg)
    for w, g in zip(want, got):
        assert (w == g).all()
    assert stats["pool"]["speculative"] >= 1
    assert not stats["pool_degraded"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_card_captures_one_graph_a_bucket_and_no_more():
    _need_card()
    with _runtime(device="cuda") as rt:
        assert rt.warmup() == len(rt.buckets) == 2
        for m in (1, 3, 8, 11, 16, 23):
            out = rt.predict(np.asarray(G.train_ids[:m], np.int32))
            assert out.shape == (m, G.num_classes)
            assert np.isfinite(out).all()
        assert rt.forward_compiles == 2
        assert all(f.graph is not None for f in rt._fwd.values())


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["graphsage", "gcn", "gin", "gat"])
def test_card_replay_bitwise_eager_and_close_to_cpu(model):
    _need_card()
    cfg = dataclasses.replace(CFG, name=model)
    params = _params(cfg)
    with _runtime(cfg, params, device="cuda") as rt, \
            _runtime(cfg, params) as cpu:
        rt.warmup()
        cpu.warmup()
        for m in (5, 16):
            ids = _ids(10, m)
            got = rt.predict(ids)
            want = ground_truth(rt, ids, rt._next_rid - 1)
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
            np.testing.assert_allclose(got, cpu.predict(ids), rtol=RTOL,
                                       atol=ATOL * max(1.0, np.abs(got).max()))


@pytest.mark.gpu
def test_card_closed_runtimes_leave_no_device_memory():
    """Every runtime captures on the card's one capture stream, so
    building and closing runtimes does not grow the device's allocated
    memory (a stream a runtime kept a cuBLAS workspace each)."""
    _need_card()
    import gc

    def build_and_close():
        with _runtime(device="cuda") as rt:
            rt.warmup()
            rt.predict(_ids(0, 11))
        del rt
        gc.collect()
        torch.cuda.synchronize()

    build_and_close()  # the first makes the stream's workspace
    base = torch.cuda.memory_allocated()
    for _ in range(3):
        build_and_close()
        assert torch.cuda.memory_allocated() == base


@pytest.mark.gpu
def test_card_failed_capture_raises_and_never_runs_eager(monkeypatch):
    """A forward that waits for the host cannot be captured: the request
    raises, no graph is counted, and the next request raises again rather
    than falling back to the eager forward."""
    _need_card()
    forward = gnn_models.forward

    def syncing_forward(cfg, params, batch):
        out = forward(cfg, params, batch)
        out.sum().item()  # a copy to the host: illegal under capture
        return out
    monkeypatch.setattr(gnn_models, "forward", syncing_forward)
    with _runtime(device="cuda") as rt:
        ids = np.asarray(G.train_ids[:3], np.int32)
        for _ in range(2):
            with pytest.raises(RuntimeError):
                rt.predict(ids)
        assert rt.forward_compiles == 0
        assert rt._fwd[8].graph is None
    torch.cuda.synchronize()

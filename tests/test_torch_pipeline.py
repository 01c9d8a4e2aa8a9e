"""The port's prefetch pipeline (``repro_torch.core.pipeline``, a copy of
``repro.core.pipeline``) and the trainer's pipelined epoch.

* ``PrefetchExecutor``: results in order, a producer exception re-raised
  in the consumer with the worker's traceback attached, and an abandoned
  epoch that stops and joins its thread; ``ReorderBuffer``'s in-order
  release and duplicate drops.
* ``SyncGNNTrainer.run_epoch`` with ``pipeline=True`` equals the
  sequential epoch bit for bit (epoch loss and acc, and every parameter)
  on all four datapaths, with the host gather and under ``data_parallel``,
  at p = 1 and p = 2, two epochs each.
* One pipelined port epoch against the reference's pipelined epoch
  (``pipeline=True``), from the reference's initial parameters, at
  ``tests/test_torch_trainer.py``'s tolerance.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core.pipeline import (PipelineStats, PrefetchExecutor,
                                       ReorderBuffer, prefetch)
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.data.graphs import synthetic_graph
from repro_torch.nn.param import flatten, params_to_numpy

SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)
G = synthetic_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
RTOL = 1e-5
BACKENDS = ("reference", "pallas", "pallas_edges", "pallas_fused")


# -- PrefetchExecutor ------------------------------------------------------------
def test_prefetch_yields_in_order_and_counts():
    stats = PipelineStats()
    out = list(PrefetchExecutor(lambda x: x * x, depth=2,
                                stats=stats).run(range(20)))
    assert out == [x * x for x in range(20)]
    assert stats.items == 20 and stats.produce_s >= 0.0
    assert list(prefetch(iter("abc"), str.upper, depth=1)) == ["A", "B",
                                                                "C"]


def test_prefetch_runs_ahead_by_at_most_depth():
    produced, seen = [], []

    def prepare(x):
        produced.append(x)
        return x
    for x in PrefetchExecutor(prepare, depth=2).run(range(8)):
        time.sleep(0.02)  # the producer fills the queue meanwhile
        # consumed x, the queue holds at most 2, one more may be in prepare
        assert len(produced) <= x + 1 + 2 + 1
        seen.append(x)
    assert seen == list(range(8))


def test_prefetch_depth_below_one_raises():
    with pytest.raises(ValueError, match="depth"):
        PrefetchExecutor(lambda x: x, depth=0)


def _failing_prepare(x):
    if x == 3:
        raise KeyError(f"bad item {x}")
    return x


def test_prefetch_reraises_the_worker_exception_in_order():
    got = []
    with pytest.raises(KeyError, match="bad item 3") as info:
        for x in PrefetchExecutor(_failing_prepare, depth=2).run(range(6)):
            got.append(x)
    assert got == [0, 1, 2]
    # the worker's frames ride on the exception and in its note
    names = [f.name for f in __import__("traceback").extract_tb(
        info.value.__traceback__)]
    assert "_failing_prepare" in names
    notes = "".join(getattr(info.value, "__notes__", []))
    assert "prefetch worker traceback" in notes
    assert "_failing_prepare" in notes


def test_prefetch_abandoned_epoch_stops_its_thread():
    pulled = []

    def items():
        for i in range(1000):
            pulled.append(i)
            yield i
    gen = PrefetchExecutor(lambda x: x, depth=2).run(items())
    assert [next(gen), next(gen)] == [0, 1]
    gen.close()  # the consumer abandons the epoch
    assert not any(t.name == "hitgnn-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert len(pulled) < 1000


# -- ReorderBuffer ---------------------------------------------------------------
def test_reorder_buffer_releases_in_order_and_drops_duplicates():
    rob = ReorderBuffer()
    assert rob.pop() is None and not rob.ready()
    assert rob.put(2, "c") and rob.put(1, "b")
    assert rob.pop() is None and rob.next_seq == 0
    assert rob.put(0, None)          # a None item still advances
    assert not rob.put(1, "b'")      # duplicate of a pending one
    assert rob.ready() and rob.pop() is None and rob.next_seq == 1
    assert [rob.pop(), rob.pop()] == ["b", "c"]
    assert not rob.put(0, "late")    # already consumed
    assert len(rob) == 0 and rob.next_seq == 3
    assert ReorderBuffer(first_seq=5).next_seq == 5


# -- the trainer's pipelined epoch -------------------------------------------------
def _epochs(backend, p, data_parallel, pipeline, params=None, epochs=2):
    t = TTrainer(G, TCfg("graphsage", aggregate_backend=backend, **SMALL),
                 num_devices=p, device="cpu", data_parallel=data_parallel,
                 pipeline=pipeline, params=params)
    ms = [t.run_epoch() for _ in range(epochs)]
    return ms, [q.clone() for q in flatten(t.params)]


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("data_parallel", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_pipelined_epochs_equal_sequential_bitwise(backend, data_parallel, p):
    seq, p_seq = _epochs(backend, p, data_parallel, pipeline=False)
    pip, p_pip = _epochs(backend, p, data_parallel, pipeline=True)
    for s, q in zip(seq, pip):
        assert (q["loss"], q["acc"]) == (s["loss"], s["acc"])
        assert q["vertices_traversed"] == s["vertices_traversed"]
        assert q["beta"] == s["beta"]
        assert (q["pipeline"], s["pipeline"]) == (True, False)
        assert q["host_produce_s"] > 0.0 and s["host_produce_s"] == 0.0
    assert all(torch.equal(a, b) for a, b in zip(p_seq, p_pip))


def test_pipelined_epoch_matches_reference_pipelined_epoch():
    import jax
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.trainer import SyncGNNTrainer as JTrainer
    from repro.data.graphs import synthetic_graph as j_graph
    jg = j_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
    jt = JTrainer(jg, JCfg("graphsage", aggregate_backend="pallas_edges",
                           **SMALL), num_devices=2, pipeline=True)
    params0 = jax.tree.map(np.asarray, jt.params)
    tt = TTrainer(G, TCfg("graphsage", aggregate_backend="pallas_edges",
                          **SMALL), num_devices=2, device="cpu",
                  pipeline=True, params=params0)
    jm, tm = jt.run_epoch(), tt.run_epoch()
    for k in ("batches", "iterations", "vertices_traversed", "fill_slots",
              "beta", "pipeline", "sampler_workers", "balance_policy"):
        assert tm[k] == jm[k], k
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=RTOL)
    np.testing.assert_allclose(tm["lr"], jm["lr"], rtol=1e-6)
    # Adam can step an entry whose gradient is round-off on both sides the
    # full learning rate either way (tests/test_torch_trainer.py)
    bound = 2 * sum(float(tt.optimizer.schedule(k))
                    for k in range(1, tm["iterations"] + 1))
    for a, b in zip(flatten(params_to_numpy(tt.params)),
                    jax.tree.leaves(jt.params)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=bound)
        assert np.isclose(a, b, rtol=1e-4, atol=1e-5).mean() > 0.99


def test_prefetch_depth_bounds_the_staging_ring():
    for depth in (1, 3):
        t = TTrainer(G, TCfg("graphsage", **SMALL), num_devices=2,
                     device="cpu", prefetch_depth=depth)
        assert len(t._ring) == (depth + 2) * 2
        assert np.isfinite(t.run_epoch()["loss"])
    with pytest.raises(ValueError, match="prefetch_depth"):
        TTrainer(G, TCfg("graphsage", **SMALL), num_devices=1,
                 device="cpu", prefetch_depth=0)


def test_a_failing_epoch_surfaces_the_error_and_closes(monkeypatch):
    t = TTrainer(G, TCfg("graphsage", **SMALL), num_devices=1,
                 device="cpu")

    def boom(*a, **k):
        raise RuntimeError("gather failed")
    monkeypatch.setattr(t.store, "gather", boom)
    with pytest.raises(RuntimeError, match="gather failed") as info:
        t.run_epoch()
    assert "prefetch worker traceback" in "".join(
        getattr(info.value, "__notes__", []))
    assert t._pool is None


def test_ring_staging_keeps_every_array_bitwise():
    """The batch the step reads (views of one packed buffer) equals the
    plain per-array upload of the same batch."""
    from repro_torch.core.trainer import batch_to_arrays
    t = TTrainer(G, TCfg("graphsage", aggregate_backend="pallas_fused",
                         **SMALL), num_devices=1, device="cpu")
    a = t.epoch_schedule()[0]
    payload = t._sample_payload(a)
    got = t._assemble_group([a], [payload])["batches"][0]
    mb = payload["minibatch"]
    want = batch_to_arrays(mb, t.store.gather(0, mb.nodes[0],
                                              mb.node_mask[0]),
                           "cpu", payload["layout"])
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, list):
            assert all(torch.equal(x, y) for x, y in zip(got[k], v)), k
        elif isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
            assert got[k].dtype == v.dtype

"""The port's ``SyncGNNTrainer`` against ``repro.core.trainer.SyncGNNTrainer``
(``pipeline=False``), both started from the reference's initial
parameters: three iterations of GraphSAGE on ``"pallas_edges"`` under
DistDGL and PaGraph with 1 and 2 devices, and of GraphSAGE, GCN and GIN on
``"pallas_fused"`` and on ``"pallas"`` (the reference's fused datapath and
GIN under the test-local ``jax_shims``), plus the ``train()`` facade, the
device rule, the layout and aggregate bytes of each datapath, the knobs
the port does not run yet, and the host runtime's knobs, which run."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import GNNModelConfig as JCfg
from repro.core import scheduler as jsched
from repro.core.trainer import SyncGNNTrainer as JTrainer
from repro.data.graphs import synthetic_graph
from repro.gnn import models as jm

from jax_reference_shims import jax_shims  # noqa: F401  (a fixture)
from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.configs.gnn import (CacheConfig, FaultConfig, HostConfig,
                                     PlatformConfig)
from repro_torch.core import scheduler as tsched
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.gnn.api import train
from repro_torch.kernels import aggregate as agg
from repro_torch.nn.param import flatten, params_to_numpy

SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)
G = synthetic_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
RTOL, ATOL = 1e-5, 1e-6


def _trainers(algo, p, name="graphsage", backend="pallas_edges"):
    jt = JTrainer(G, JCfg(name, aggregate_backend=backend, **SMALL),
                  num_devices=p, algorithm=algo, pipeline=False)
    params0 = jax.tree.map(np.asarray, jt.params)
    tt = TTrainer(G, TCfg(name, aggregate_backend=backend, **SMALL),
                  num_devices=p, algorithm=algo, device="cpu",
                  params=params0)
    return jt, tt


def _reference_grads(jt, stacked):
    """The reference step's combined gradient: per-device grads weighted by
    the batches' loss weights (``core/trainer.py`` step)."""
    w = np.asarray(stacked["weight"], np.float32)
    per_dev = []
    for d in range(len(w)):
        b = jax.tree.map(lambda x: jnp.asarray(x[d]), stacked)
        per_dev.append(jax.grad(
            lambda q: jm.loss_fn(jt.model_cfg, q, b)[0])(jt.params))
    w_sum = max(float(w.sum()), 1.0)
    return [sum(float(w[d]) * np.asarray(jax.tree.leaves(per_dev[d])[i])
                for d in range(len(w))) / w_sum
            for i in range(len(jax.tree.leaves(per_dev[0])))]


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("algo", ["distdgl", "pagraph"])
def test_three_iterations_match_reference(algo, p):
    _check_three_iterations(*_trainers(algo, p))


@pytest.mark.parametrize("name", ["graphsage", "gcn", "gin"])
def test_fused_three_iterations_match_reference(name, jax_shims):
    _check_three_iterations(*_trainers("distdgl", 2, name, "pallas_fused"))


@pytest.mark.parametrize("name", ["graphsage", "gcn", "gin"])
def test_blockcsr_three_iterations_match_reference(name, request):
    if name == "gin":
        request.getfixturevalue("jax_shims")  # the reference's GIN needs it
    _check_three_iterations(*_trainers("distdgl", 2, name, "pallas"))


def _check_three_iterations(jt, tt):
    jgroups = list(jsched.iterations(jt.epoch_schedule()))
    tgroups = list(tsched.iterations(tt.epoch_schedule()))
    assert len(jgroups) >= 3
    assert ([[dataclasses.astuple(a) for a in g] for g in jgroups]
            == [[dataclasses.astuple(a) for a in g] for g in tgroups])

    # iteration 1 through the step's parts: the combined gradient first
    jprep = jt._prepare_group(jgroups[0])
    tprep = tt._prepare_group(tgroups[0])
    j_grads = _reference_grads(jt, jprep["stacked"])
    _, _, t_grads = tt._grads(tprep["batches"])
    for a, b in zip(t_grads, j_grads):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
    jms = [jt._execute(jprep)]
    tms = [tt._execute(tprep)]
    for jg, tg in zip(jgroups[1:3], tgroups[1:3]):
        jms.append(jt.run_iteration(jg))
        tms.append(tt.run_iteration(tg))

    for j, t in zip(jms, tms):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=RTOL)
        np.testing.assert_allclose(t["lr"], j["lr"], rtol=1e-6)
        assert t["vertices_traversed"] == j["vertices_traversed"]
    # Adam divides each gradient entry by its own running RMS, so an entry
    # whose gradient is round-off on both sides can step the full learning
    # rate either way: after three steps two runs may part by up to
    # 2 * (lr_1 + lr_2 + lr_3) in such an entry. Every other entry follows
    # its gradient, which agrees to 1e-5.
    bound = 2 * sum(m["lr"] for m in jms)
    for a, b in zip(flatten(params_to_numpy(tt.params)),
                    jax.tree.leaves(jt.params)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=bound)
        close = np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, close.mean()


def test_cpu_run_launches_no_kernel():
    before = dict(agg.launch_counts)
    t = TTrainer(G, TCfg("gcn", aggregate_backend="pallas_edges", **SMALL),
                 num_devices=1, device="cpu")
    t.run_iteration(next(tsched.iterations(t.epoch_schedule())))
    assert agg.launch_counts == before


@pytest.mark.parametrize("name", ["graphsage", "gin"])
def test_cpu_fused_run_launches_no_kernel(name):
    before = dict(agg.launch_counts)
    t = TTrainer(G, TCfg(name, aggregate_backend="pallas_fused", **SMALL),
                 num_devices=1, device="cpu")
    m = t.run_iteration(next(tsched.iterations(t.epoch_schedule())))
    assert np.isfinite(m["loss"])
    assert agg.launch_counts == before


def test_cpu_blockcsr_run_launches_no_kernel():
    before = dict(agg.launch_counts)
    t = TTrainer(G, TCfg("gin", aggregate_backend="pallas", **SMALL),
                 num_devices=1, device="cpu")
    m = t.run_iteration(next(tsched.iterations(t.epoch_schedule())))
    assert np.isfinite(m["loss"])
    assert agg.launch_counts == before


@pytest.mark.parametrize("backend", ["reference", "pallas", "pallas_edges",
                                     "pallas_fused"])
@pytest.mark.parametrize("name", ["graphsage", "gin"])
def test_layout_and_aggregate_bytes_match_reference(name, backend):
    kw = dict(num_layers=2, hidden=16, fanouts=(5, 4), batch_targets=200)
    jt = JTrainer(G, JCfg(name, aggregate_backend=backend, **kw),
                  num_devices=1, pipeline=False)
    tt = TTrainer(G, TCfg(name, aggregate_backend=backend, **kw),
                  num_devices=1, device="cpu")
    assert tt._blk_caps == jt._blk_caps
    assert tt.densified_hbm_bytes() == jt.densified_hbm_bytes()
    assert (tt.aggregate_intermediate_bytes()
            == jt.aggregate_intermediate_bytes())
    for layout in ("compact", "edges", "dense"):
        assert (tt.aggregate_h2d_bytes(layout)
                == jt.aggregate_h2d_bytes(layout)), layout
    if backend == "pallas":
        assert tt.densified_hbm_bytes() > 0


def test_aggregate_intermediate_bytes_per_datapath():
    """At the paper's GraphSAGE shape the unfused kernel path keeps each
    layer's (n_dstb*128, f_in) f32 aggregate in device memory; the fused
    path keeps none."""
    g = synthetic_graph(scale=9, edge_factor=4, feat_dim=602,
                        num_classes=41)
    paper = dict(num_layers=2, hidden=128, fanouts=(25, 10),
                 batch_targets=1024)
    got = {be: TTrainer(g, TCfg("graphsage", aggregate_backend=be, **paper),
                        num_devices=1, device="cpu"
                        ).aggregate_intermediate_bytes()
           for be in ("reference", "pallas", "pallas_edges",
                      "pallas_fused")}
    unfused = 26_624 * 602 * 4 + 1_024 * 128 * 4
    assert got == {"reference": 0, "pallas": unfused,
                   "pallas_edges": unfused, "pallas_fused": 0}


def test_train_facade_runs_one_epoch():
    cfg = TCfg("graphsage", aggregate_backend="pallas_edges", **SMALL)
    seen = []
    r = train(cfg, PlatformConfig(num_devices=2), "pagraph", graph=G,
              epochs=1, device="cpu", progress=lambda e, m: seen.append(e))
    m = r.final
    assert seen == [0] and len(r.epochs) == 1
    assert m["batches"] == sum(s.epoch_batches() for s in r.trainer.samplers)
    assert np.isfinite(m["loss"]) and 0.0 <= m["acc"] <= 1.0
    assert m["nvtps"] > 0 and 0.0 < m["beta"] <= 1.0
    assert m["iterations"] * 2 == m["batches"] + m["fill_slots"]
    for leaf in flatten(r.params):
        assert torch.isfinite(leaf).all()


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TCfg("graphsage", **SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTrainer(G, cfg, num_devices=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTrainer(G, cfg, num_devices=1, device="cuda")


UNPORTED = {
    "cache": dict(cache_capacity=100),
    "cache_cfg": dict(cfg=dict(cache=CacheConfig(capacity=100))),
    "cache_refresh_cfg": dict(cfg=dict(cache=CacheConfig(refresh_every=2))),
    "mesh": dict(mesh=object()),
    "data_parallel_p3": dict(data_parallel=True, algorithm="p3"),
    "data_parallel_cache": dict(data_parallel=True, cache_capacity=100),
    "data_parallel_cache_cfg": dict(data_parallel=True, cfg=dict(
        cache=CacheConfig(capacity=100, ship_rows_cap=64))),
    "grad_compression": dict(grad_compression=True),
    "checkpointer": dict(checkpointer=object()),
    "sgdm": dict(optimizer_name="sgdm"),
    "p3": dict(algorithm="p3"),
    "gat": dict(cfg=dict(name="gat")),
}


@pytest.mark.parametrize("knob", sorted(UNPORTED))
def test_unported_knobs_raise(knob):
    kw = dict(UNPORTED[knob])
    cfg = TCfg(**{"name": "graphsage", **SMALL, **kw.pop("cfg", {})})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TTrainer(G, cfg, num_devices=1, device="cpu", **kw)


# the host runtime's knobs (ROADMAP A.4 and A.5), which raised until the
# prefetch pipeline and the sampler pool were ported: each now runs
HOST_KNOBS = {
    "sampler_pool": dict(num_sampler_workers=2),
    "sampler_pool_cfg": dict(cfg=dict(host=HostConfig(num_sampler_workers=1))),
    "gather_in_workers_cfg": dict(cfg=dict(
        host=HostConfig(gather_in_workers=True))),
    "load_policy": dict(balance_policy="load"),
    "load_policy_cfg": dict(cfg=dict(host=HostConfig(balance_policy="load"))),
    "fault_cfg": dict(cfg=dict(fault=FaultConfig(max_respawns=5))),
    "pipeline": dict(pipeline=True),
}


@pytest.mark.parametrize("knob", sorted(HOST_KNOBS))
def test_ported_host_knobs_run(knob):
    """Each knob set runs one epoch on the CPU and reports itself in the
    epoch's metrics; the trainer-level fields override the config's."""
    kw = dict(HOST_KNOBS[knob])
    cfg = TCfg(**{"name": "graphsage", **SMALL, **kw.pop("cfg", {})})
    with TTrainer(G, cfg, num_devices=2, device="cpu", **kw) as t:
        m = t.run_epoch()
        host = t.model_cfg.host
        assert np.isfinite(m["loss"]) and 0.0 <= m["acc"] <= 1.0
        assert m["batches"] == sum(s.epoch_batches() for s in t.samplers)
        assert m["sampler_workers"] == host.num_sampler_workers
        assert m["balance_policy"] == host.balance_policy
        assert m["pipeline"] is True
        # gathering in the workers needs workers
        assert m["gather_in_workers"] is False
        assert t.model_cfg.fault.max_respawns == (5 if knob == "fault_cfg"
                                                  else 2)
        # the pool's payloads cross its shared-memory ring
        assert (m["ring_bytes_per_iter"] > 0) == bool(
            host.num_sampler_workers)
        assert (t._pool is not None) == bool(host.num_sampler_workers)
        assert not m["pool_degraded"]
    assert t._pool is None


def test_unknown_host_knob_values_raise():
    cfg = TCfg("graphsage", **SMALL)
    with pytest.raises(ValueError, match="balance_policy"):
        TTrainer(G, cfg, num_devices=1, device="cpu", balance_policy="lpt")
    with pytest.raises(ValueError, match="num_sampler_workers"):
        TTrainer(G, cfg, num_devices=1, device="cpu", num_sampler_workers=-1)


@pytest.mark.parametrize("data_parallel", [False, True])
@pytest.mark.parametrize("cache", [CacheConfig(ship_rows_cap=64),
                                   CacheConfig(auto_ship_rows_cap=False)])
def test_ship_rows_cap_alone_is_no_cache(cache, data_parallel):
    """A CacheConfig that only sizes the shipped rows runs: it sets the
    data_parallel path's miss cap and turns no feature cache on."""
    cfg = TCfg("graphsage", cache=cache, **SMALL)
    t = TTrainer(G, cfg, num_devices=1, device="cpu",
                 data_parallel=data_parallel)
    m = t.run_iteration(next(tsched.iterations(t.epoch_schedule())))
    assert np.isfinite(m["loss"])


"""The port's GAT against ``repro.gnn.models``' and within itself.

GAT's attention weights are computed on the device (a leaky-relu(0.2)
score per edge, a per-destination softmax), so no kernel backend applies:
the reference builds no layout for it and takes its plain path whatever
``aggregate_backend`` says, and so does the port. Here, on the CPU:

* logits, loss and every parameter gradient against the reference at
  rtol 1e-5 / atol 1e-6 (fp32 products and sums taken in another order),
  from the same parameters and sampled batch;
* ``segment_softmax`` and its gradient against the reference's on
  all-masked, empty and tied segments, at the same tolerance;
* three trainer iterations at p = 1 and 2 against the reference trainer,
  at ``test_torch_trainer.py``'s tolerance;
* a kernel backend builds no layout, launches nothing and gives the
  ``"reference"`` bits; pipelined and pooled epochs equal the sequential
  one bit for bit.

The tests marked ``gpu`` run GAT on the card twice from the same inputs
(the same bits; every sum a sorted segment reduction) and hold it against
the CPU. The card has no JAX, so the reference is imported only by the
tests that use it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core import scheduler as tsched
from repro_torch.core.sampler import NeighborSampler
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.core.trainer import batch_to_arrays
from repro_torch.data.graphs import synthetic_graph
from repro_torch.gnn import models as tm
from repro_torch.kernels import aggregate as agg
from repro_torch.nn.param import (flatten, init_params, params_from_numpy,
                                  params_to_numpy, tree_paths, unflatten)

RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)
GRAPH = dict(scale=10, edge_factor=6, feat_dim=16, num_classes=4)
G = synthetic_graph(**GRAPH)


def _j_graph():
    from repro.data.graphs import synthetic_graph as j_graph
    return j_graph(**GRAPH)


def _port_batch(seed, device="cpu", cfg=None):
    """A sampled batch (layer-0 features gathered) as the port's step
    reads it, and the mini-batch it came from."""
    cfg = cfg or TCfg("gat", **SMALL)
    mb = NeighborSampler(G, cfg, G.train_ids, 0, seed).batch_at(0, 0)
    feats = G.features[mb.nodes[0]] * mb.node_mask[0][:, None]
    return batch_to_arrays(mb, feats, device), mb, feats


def _loss_and_grads(cfg, params, batch):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in flatten(params)]
    loss, met = tm.loss_fn(cfg, unflatten(params, leaves), batch)
    return loss.detach(), met, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_loss_and_grads_match_reference(seed, num_layers):
    import jax
    import jax.numpy as jnp
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.trainer import batch_to_arrays as j_batch_to_arrays
    from repro.gnn import models as jm
    from repro.nn.param import materialize
    kw = dict(SMALL, num_layers=num_layers,
              fanouts=(4, 3, 2)[:num_layers])
    jcfg, tcfg = JCfg("gat", **kw), TCfg("gat", **kw)
    tbatch, mb, feats = _port_batch(seed, cfg=tcfg)
    jbatch = jax.tree.map(jnp.asarray, j_batch_to_arrays(mb, feats))
    spec = jm.param_spec(jcfg, G.features.shape[1], G.num_classes)
    jparams = materialize(spec, jax.random.PRNGKey(seed))
    # b away from 0, so that the bias is exercised
    jparams["layers"] = [dict(p, b=p["b"] + 0.1 * (l + 1))
                         for l, p in enumerate(jparams["layers"])]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    logits_j, ((loss_j, met_j), grads_j) = jax.jit(lambda p: (
        jm.forward(jcfg, p, jbatch), jax.value_and_grad(
            lambda q: jm.loss_fn(jcfg, q, jbatch), has_aux=True)(p)))(
        jparams)
    logits_t = tm.forward(tcfg, tparams, tbatch)
    loss_t, met_t, grads_t = _loss_and_grads(tcfg, tparams, tbatch)

    assert logits_t.shape == np.asarray(logits_j).shape
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
    assert float(met_t["acc"]) == float(met_j["acc"])
    for (l, k), g_t, g_j in zip(tree_paths(tparams), grads_t,
                                jax.tree.leaves(grads_j)):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL,
                                   atol=ATOL, err_msg=f"layer {l} {k}")


def test_param_spec_matches_reference():
    """The same leaves in the same order, shapes and init laws: ``w``,
    ``a_src`` and ``a_dst`` normal (the 1-D attention vectors too), ``b``
    zeros."""
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.gnn import models as jm
    from repro.nn.param import PSpec as JSpec
    import jax
    jspec = jm.param_spec(JCfg("gat", **SMALL), 16, 4)
    tspec = tm.param_spec(TCfg("gat", **SMALL), 16, 4)
    jleaves = jax.tree.leaves(jspec, is_leaf=lambda x: isinstance(x, JSpec))
    tleaves = flatten(tspec)
    assert [sorted(l) for l in tspec["layers"]] == [
        sorted(l) for l in jspec["layers"]] == [
        ["a_dst", "a_src", "b", "w"]] * 2
    assert [(s.shape, s.init, s.scale) for s in tleaves] == [
        (s.shape, s.init, s.scale) for s in jleaves]
    params = init_params(tspec, 0, "cpu")
    for layer in params["layers"]:
        assert layer["a_src"].abs().sum() > 0 and layer["b"].abs().sum() == 0


def _softmax_cases():
    """(scores, seg, mask, n_seg) for each edge case: random scores with
    some masked; an all-masked segment; empty segments (ids with no edge);
    ties at the segment max; a segment of one edge."""
    rng = np.random.default_rng(0)
    cases = {}
    n, s = 200, 30
    cases["random"] = (rng.standard_normal(n).astype(np.float32),
                       rng.integers(0, s, n).astype(np.int32),
                       rng.random(n) < 0.8, s)
    seg = rng.integers(0, 10, 60).astype(np.int32)
    mask = rng.random(60) < 0.7
    mask[seg == 3] = False
    cases["all_masked"] = (rng.standard_normal(60).astype(np.float32), seg,
                           mask, 10)
    seg = rng.integers(0, 12, 80).astype(np.int32) * 2  # odd ids empty
    cases["empty"] = (rng.standard_normal(80).astype(np.float32), seg,
                      rng.random(80) < 0.9, 30)
    seg = np.repeat(np.arange(8, dtype=np.int32), 5)
    scores = rng.integers(0, 3, 40).astype(np.float32)  # ties, at max too
    cases["tied"] = (scores, seg, np.ones(40, bool), 8)
    cases["single"] = (np.float32([0.5, -2.0, 3.0]), np.int32([2, 0, 1]),
                       np.ones(3, bool), 4)
    return cases


@pytest.mark.parametrize("case", sorted(_softmax_cases()))
def test_segment_softmax_matches_reference(case):
    import jax
    import jax.numpy as jnp
    from repro.gnn import models as jm
    scores, seg, mask, n_seg = _softmax_cases()[case]
    g = np.random.default_rng(1).standard_normal(len(scores)).astype(
        np.float32)
    out_j, vjp = jax.vjp(lambda x: jm.segment_softmax(
        x, jnp.asarray(seg), jnp.asarray(mask), n_seg), jnp.asarray(scores))
    (ds_j,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(scores).requires_grad_(True)
    out_t = tm.segment_softmax(x, torch.from_numpy(seg),
                               torch.from_numpy(mask), n_seg)
    (ds_t,) = torch.autograd.grad(out_t, x, torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ds_t.numpy(), np.asarray(ds_j), rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(out_t.detach().numpy()).all()
    # masked edges weigh 0; each segment with a valid edge sums to 1
    out = out_t.detach().numpy()
    assert (out[~mask] == 0).all()
    sums = np.bincount(seg, weights=out, minlength=n_seg)
    live = np.bincount(seg[mask], minlength=n_seg) > 0
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-6)


def _trainers(p, backend="reference"):
    import jax
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.trainer import SyncGNNTrainer as JTrainer
    jt = JTrainer(_j_graph(), JCfg("gat", aggregate_backend=backend,
                                   **SMALL),
                  num_devices=p, pipeline=False)
    tt = TTrainer(G, TCfg("gat", aggregate_backend=backend, **SMALL),
                  num_devices=p, device="cpu",
                  params=jax.tree.map(np.asarray, jt.params))
    return jt, tt


@pytest.mark.parametrize("backend", ["reference", "pallas_fused"])
@pytest.mark.parametrize("p", [1, 2])
def test_three_iterations_match_reference(p, backend):
    """The reference's trainer takes GAT's plain path on any backend, as
    the port does: three iterations within rtol 1e-5 in the loss, the
    parameters as ``test_torch_trainer`` holds them."""
    import jax
    from repro.core import scheduler as jsched
    jt, tt = _trainers(p, backend)
    assert jt._blk_caps == tt._blk_caps == []
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
    bound = 2 * sum(lrs)
    for a, b in zip(flatten(params_to_numpy(tt.params)),
                    jax.tree.leaves(jt.params)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=bound)
        close = np.isclose(a, b, rtol=1e-4, atol=1e-5)
        assert close.mean() > 0.99, close.mean()


def _iterations(backend, n=2, data_parallel=False, p=2):
    t = TTrainer(G, TCfg("gat", aggregate_backend=backend, **SMALL),
                 num_devices=p, device="cpu", data_parallel=data_parallel)
    ms = [t.run_iteration(g)
          for g in list(tsched.iterations(t.epoch_schedule()))[:n]]
    return t, ms


@pytest.mark.parametrize("backend", ["pallas", "pallas_edges",
                                     "pallas_fused"])
def test_kernel_backend_builds_no_layout(backend, monkeypatch):
    """A kernel backend configured for GAT builds no layout, ships no
    ``agg_*`` array, launches no kernel and gives the ``"reference"``
    bits (the trainer's layout test and the model's, as the reference's
    ``_use_kernel_layout`` and ``AGG_KIND``)."""
    ref, ms_ref = _iterations("reference")
    before = dict(agg.launch_counts)
    seen = []
    loss_fn = tm.loss_fn
    monkeypatch.setattr(tm, "loss_fn", lambda c, p, b: seen.append(
        sorted(k for k in b if k.startswith("agg_"))) or loss_fn(c, p, b))
    t, ms = _iterations(backend)  # the same seeded init
    assert t._blk_caps == [] and seen and all(s == [] for s in seen)
    assert t.aggregate_h2d_bytes() == t.densified_hbm_bytes() == 0
    assert agg.launch_counts == before
    for a, b in zip(ms, ms_ref):
        assert (a["loss"], a["acc"]) == (b["loss"], b["acc"])
    for a, b in zip(flatten(t.params), flatten(ref.params)):
        assert torch.equal(a, b)


def test_model_ignores_a_layout_in_the_batch():
    """Even a batch that carries a layout takes GAT's plain path."""
    from repro_torch.kernels.layout import (block_capacities,
                                            build_layer_layouts)
    cfg = TCfg("gat", aggregate_backend="pallas_fused", **SMALL)
    batch, mb, feats = _port_batch(0, cfg=cfg)
    layout = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                                 block_capacities(cfg), "mean",
                                 edge_stream=True)
    with_layout = batch_to_arrays(mb, feats, "cpu", layout)
    params = init_params(tm.param_spec(cfg, 16, 4), 0, "cpu")
    before = dict(agg.launch_counts)
    a = _loss_and_grads(cfg, params, batch)
    b = _loss_and_grads(cfg, params, with_layout)
    assert agg.launch_counts == before
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.parametrize("p", [1, 2])
def test_resident_equals_host_gather_bitwise(p):
    host, ms_h = _iterations("reference", p=p)
    res, ms_r = _iterations("reference", p=p, data_parallel=True)
    for a, b in zip(ms_h, ms_r):
        assert (a["loss"], a["acc"]) == (b["loss"], b["acc"])
    for a, b in zip(flatten(host.params), flatten(res.params)):
        assert torch.equal(a, b)
    assert res.store.beta() == host.store.beta()


def _epochs(**kw):
    t = TTrainer(G, TCfg("gat", aggregate_backend="pallas_fused", **SMALL),
                 num_devices=2, device="cpu", seed=3, **kw)
    try:
        ms = [t.run_epoch() for _ in range(2)]
        return ms, [q.clone() for q in flatten(t.params)]
    finally:
        t.close()


_TWINS = {}


@pytest.mark.parametrize("kw", [
    dict(pipeline=True),
    dict(num_sampler_workers=2),
    dict(num_sampler_workers=4, data_parallel=True),
    dict(num_sampler_workers=2, gather_in_workers=True, data_parallel=True),
], ids=["pipelined", "pooled", "pooled_resident", "pooled_gather_resident"])
def test_runtime_epochs_equal_sequential_bitwise(kw):
    dp = kw.get("data_parallel", False)
    if dp not in _TWINS:
        _TWINS[dp] = _epochs(pipeline=False, data_parallel=dp)
    (ms, params), (tms, tparams) = _epochs(**kw), _TWINS[dp]
    for m, t in zip(ms, tms):
        assert (m["loss"], m["acc"]) == (t["loss"], t["acc"])
        assert m["vertices_traversed"] == t["vertices_traversed"]
        assert m["beta"] == t["beta"]
    assert all(torch.equal(a, b) for a, b in zip(params, tparams))


# -- on the card ------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["reference", "pallas_fused"])
def test_two_runs_on_card_bitwise_and_close_to_cpu(backend):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TCfg("gat", aggregate_backend=backend, **SMALL)
    params = init_params(tm.param_spec(cfg, 16, 4), 0, "cpu")
    cpu = _loss_and_grads(cfg, params, _port_batch(0)[0])
    gparams = params_from_numpy(params_to_numpy(params), "cuda")
    batch = _port_batch(0, "cuda")[0]
    before = dict(agg.launch_counts)
    runs = [_loss_and_grads(cfg, gparams, batch) for _ in range(2)]
    assert agg.launch_counts == before
    (l0, _, g0), (l1, _, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    np.testing.assert_allclose(float(l0), float(cpu[0]), rtol=1e-5)
    for a, b in zip(g0, cpu[2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL)

"""The port's GraphSAGE, GCN and GIN against ``repro.gnn.models``: logits,
loss and every parameter gradient, on the ``reference``, ``pallas``,
``pallas_edges`` and ``pallas_fused`` datapaths, from the same parameters and the same
sampled batch, at rtol 1e-5 / atol 1e-6 (fp32 matrix products and sums
taken in another order). The reference's fused datapath and GIN run under
the test-local ``jax_shims`` (``tests/jax_reference_shims.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import GNNModelConfig as JCfg
from repro.core.sampler import NeighborSampler
from repro.core.trainer import batch_to_arrays as j_batch_to_arrays
from repro.data.graphs import synthetic_graph
from repro.gnn import models as jm
from repro.kernels.layout import block_capacities, build_layer_layouts
from repro.nn.param import materialize

from jax_reference_shims import jax_shims  # noqa: F401  (a fixture)
from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core.trainer import batch_to_arrays
from repro_torch.gnn import models as tm
from repro_torch.kernels import aggregate as agg
from repro_torch.kernels.layout import EDGE_STREAM_BACKENDS
from repro_torch.nn.param import (flatten, init_params, params_from_numpy,
                                  tree_paths, unflatten)

RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)
G = synthetic_graph(scale=10, edge_factor=6, feat_dim=16, num_classes=4)


def _setup(name, backend, seed=0):
    jcfg = JCfg(name, aggregate_backend=backend, **SMALL)
    tcfg = TCfg(name, aggregate_backend=backend, **SMALL)
    mb = NeighborSampler(G, jcfg, G.train_ids, 0, seed).batch_at(0, 0)
    feats = G.features[mb.nodes[0]] * mb.node_mask[0][:, None]
    layout = None
    if backend in jm.KERNEL_BACKENDS:
        layout = build_layer_layouts(
            mb.edge_src, mb.edge_dst, mb.edge_mask, block_capacities(jcfg),
            jm.AGG_KIND[name], edge_stream=backend in EDGE_STREAM_BACKENDS)
    jbatch = j_batch_to_arrays(mb, feats)
    jbatch.update(layout or {})
    jbatch = jax.tree.map(jnp.asarray, jbatch)
    tbatch = batch_to_arrays(mb, feats, "cpu", layout)
    spec = jm.param_spec(jcfg, G.features.shape[1], G.num_classes)
    jparams = materialize(spec, jax.random.PRNGKey(seed))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jbatch, tbatch, jparams, tparams


@pytest.mark.parametrize("backend", ["reference", "pallas_edges",
                                     "pallas_fused", "pallas"])
@pytest.mark.parametrize("name", ["graphsage", "gcn", "gin"])
def test_forward_loss_and_grads_match_reference(name, backend, request):
    if name == "gin" or backend == "pallas_fused":
        request.getfixturevalue("jax_shims")  # the reference needs them
    jcfg, tcfg, jbatch, tbatch, jparams, tparams = _setup(name, backend)
    if name == "gin":  # eps away from 0, so that (1 + eps) is exercised
        jparams["layers"] = [dict(p, eps=jnp.float32(0.25 * (l + 1)))
                             for l, p in enumerate(jparams["layers"])]
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    "cpu")

    # one compiled program: the reference's interpret-mode kernels run
    # faster traced once than op by op
    logits_j, ((loss_j, met_j), grads_j) = jax.jit(lambda p: (
        jm.forward(jcfg, p, jbatch), jax.value_and_grad(
            lambda q: jm.loss_fn(jcfg, q, jbatch), has_aux=True)(p)))(
        jparams)
    logits_j = np.asarray(logits_j)

    before = dict(agg.launch_counts)
    leaves = [p.clone().requires_grad_(True) for p in flatten(tparams)]
    params = unflatten(tparams, leaves)
    logits_t = tm.forward(tcfg, params, tbatch)
    loss_t, met_t = tm.loss_fn(tcfg, params, tbatch)
    grads_t = torch.autograd.grad(loss_t, leaves)
    assert agg.launch_counts == before  # CPU: plain path

    assert logits_t.shape == logits_j.shape
    np.testing.assert_allclose(logits_t.detach().numpy(), logits_j,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=RTOL)
    assert float(met_t["acc"]) == float(met_j["acc"])
    for (l, k), g_t, g_j in zip(tree_paths(tparams), grads_t,
                                jax.tree.leaves(grads_j)):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL,
                                   atol=ATOL, err_msg=f"layer {l} {k}")


@pytest.mark.parametrize("backend", ["pallas_edges", "pallas_fused",
                                     "pallas"])
@pytest.mark.parametrize("name", ["graphsage", "gcn", "gin"])
def test_kernel_datapath_matches_reference_datapath(name, backend):
    """Within the port: each kernel datapath and the plain segment sum give
    the same loss and gradients."""
    out = []
    for be in ("reference", backend):
        _, tcfg, _, tbatch, _, tparams = _setup(name, be, seed=1)
        leaves = [p.clone().requires_grad_(True) for p in flatten(tparams)]
        loss, _ = tm.loss_fn(tcfg, unflatten(tparams, leaves), tbatch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l0, l1, rtol=RTOL, atol=ATOL)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_reference_aggregate_matches_segment_sum():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((50, 7)).astype(np.float32)
    src = rng.integers(0, 50, 200).astype(np.int32)
    dst = rng.integers(0, 30, 200).astype(np.int32)
    mask = rng.random(200) < 0.7
    for kind in ("mean", "sum"):
        ref = np.asarray(jm.aggregate(jnp.asarray(h), jnp.asarray(src),
                                      jnp.asarray(dst), jnp.asarray(mask),
                                      30, kind))
        out = tm.aggregate(torch.from_numpy(h), torch.from_numpy(src),
                           torch.from_numpy(dst), torch.from_numpy(mask),
                           30, kind)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_gather_rows_backward_matches_reference():
    """``gather_rows``' backward adds the cotangents of repeated indices
    by a sorted segment sum (one order on every run) to what JAX's
    gather gives."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((40, 6)).astype(np.float32)
    idx = rng.integers(0, 25, 300).astype(np.int32)  # repeats; rows 25+ none
    g = rng.standard_normal((300, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: x[jnp.asarray(idx)], jnp.asarray(h))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    ht = torch.from_numpy(h).requires_grad_(True)
    out = tm.gather_rows(ht, torch.from_numpy(idx))
    assert torch.equal(out.detach(), torch.from_numpy(h[idx]))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ht.grad.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert not ht.grad[25:].any()


@pytest.mark.parametrize("name", ["graphsage", "gcn", "gin"])
def test_standalone_init_follows_the_spec(name):
    cfg = TCfg(name, **SMALL)
    spec = tm.param_spec(cfg, 602, 41)
    a = init_params(spec, 0, "cpu")
    b = init_params(spec, 0, "cpu")
    for (l, k), x, y in zip(tree_paths(spec), flatten(a), flatten(b)):
        assert tuple(x.shape) == spec["layers"][l][k].shape
        assert torch.equal(x, y)  # one seed, one set of weights
        if k in ("b", "b1", "b2", "eps"):
            assert not x.any()
        else:  # fan-in scaled normal: std 1/sqrt(fan_in)
            assert abs(float(x.std()) * np.sqrt(x.shape[0]) - 1.0) < 0.1

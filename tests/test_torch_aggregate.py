"""``aggregate_edges`` of the port against the reference's Pallas kernel.

On the CPU the port's wrapper runs ``aggregate_edges_plain``; it is held
against ``repro.kernels.aggregate.aggregate_edges`` in interpret mode, and
its backward against ``jax.vjp`` of ``aggregate_edges_vjp``, at rtol 1e-5 /
atol 1e-6 (fp32 sums taken in another order). The tests marked ``gpu``
hold the CUDA kernel against the plain version on the card (atol 1e-6
times the plain result's largest magnitude where the cases of
``test_torch_edges_plan.py`` run, and two launches must give the same
bits); they need no JAX, so the reference is imported only by the tests
that use it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core.sampler import NeighborSampler
from repro_torch.data.graphs import synthetic_graph
from repro_torch.kernels import aggregate as agg
from repro_torch.kernels.layout import (block_capacities,
                                        build_block_coo_pair,
                                        build_layer_layouts)
import test_torch_edges_plan as plan

RTOL, ATOL = 1e-5, 1e-6
FWD = ("tile_off", "val", "tile_seg", "cols")
BWD = ("tile_off_t", "val_t", "tile_seg_t", "cols_t")


def _layout(seed, n_src, n_dst, n_edges, mask_p=0.9):
    """Distinct (src, dst) pairs with random weights — the sampler's
    per-layer contract — in the edge-segment layout."""
    rng = np.random.default_rng(seed)
    n_edges = min(n_edges, n_src * n_dst)
    pairs = rng.choice(n_src * n_dst, n_edges, replace=False)
    es = (pairs % n_src).astype(np.int32)
    ed = (pairs // n_src).astype(np.int32)
    em = rng.random(n_edges) < mask_p
    vals = rng.standard_normal(n_edges).astype(np.float32)
    return build_block_coo_pair(es, ed, em, n_src, n_dst, vals,
                                edge_stream=True)


def _h(seed, rows, F):
    return np.random.default_rng(seed + 100).standard_normal(
        (rows, F)).astype(np.float32)


def _port(coo, keys, h):
    return agg.aggregate_edges(*(torch.from_numpy(coo[k]) for k in keys),
                               torch.from_numpy(h)).numpy()


def _ref(coo, keys, h):
    import jax.numpy as jnp
    from repro.kernels.aggregate import aggregate_edges as j_aggregate_edges
    return np.asarray(j_aggregate_edges(
        *(jnp.asarray(coo[k]) for k in keys), jnp.asarray(h),
        interpret=True))


CASES = {
    "multi_block": dict(seed=0, n_src=300, n_dst=260, n_edges=2000, F=16),
    "ragged_F": dict(seed=1, n_src=200, n_dst=130, n_edges=900, F=101),
    "fully_masked": dict(seed=2, n_src=150, n_dst=140, n_edges=500, F=8,
                         mask_p=0.0),
    "zero_edges": dict(seed=3, n_src=150, n_dst=140, n_edges=0, F=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_forward(case):
    kw = dict(CASES[case])
    F = kw.pop("F")
    coo = _layout(**kw)
    h = _h(kw["seed"], coo["n_src_pad"], F)
    out = _port(coo, FWD, h)
    ref = _ref(coo, FWD, h)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    if case in ("fully_masked", "zero_edges"):
        assert not out.any()


@pytest.mark.parametrize("case", ["multi_block", "ragged_F"])
def test_plain_matches_reference_backward(case):
    import jax
    import jax.numpy as jnp
    from repro.kernels.aggregate import aggregate_edges_vjp as j_aggregate_vjp
    kw = dict(CASES[case])
    F = kw.pop("F")
    coo = _layout(**kw)
    h = _h(kw["seed"], coo["n_src_pad"], F)
    n_dst_pad = coo["cols"].shape[0] * 128
    g = _h(kw["seed"] + 1, n_dst_pad, F)

    layout = [jnp.asarray(coo[k]) for k in FWD + BWD]
    out_j, vjp = jax.vjp(lambda x: j_aggregate_vjp(*layout, x),
                         jnp.asarray(h))
    dh_j = np.asarray(vjp(jnp.asarray(g))[0])

    ht = torch.from_numpy(h).requires_grad_(True)
    out_t = agg.AggregateEdges.apply(
        *(torch.from_numpy(coo[k]) for k in FWD + BWD), ht)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), dh_j, rtol=RTOL, atol=ATOL)


def _batch_layouts():
    g = synthetic_graph(scale=10, edge_factor=6, feat_dim=16, num_classes=4)
    cfg = GNNModelConfig("graphsage", hidden=16, fanouts=(4, 3),
                         batch_targets=32, aggregate_backend="pallas_edges")
    mb = NeighborSampler(g, cfg, g.train_ids).batch_at(0, 0)
    caps = block_capacities(cfg)
    lay = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask, caps,
                              "mean", edge_stream=True)
    return [{k[4:]: v[l] for k, v in lay.items()}
            | {"n_src_pad": caps[l][0] + (-caps[l][0]) % 128}
            for l in range(len(caps))]


@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_reference_on_a_sampled_batch(layer):
    coo = _batch_layouts()[layer]
    h = _h(layer, coo["n_src_pad"], 16)
    np.testing.assert_allclose(_port(coo, FWD, h), _ref(coo, FWD, h),
                               rtol=RTOL, atol=ATOL)
    g = _h(layer + 7, coo["cols"].shape[0] * 128, 16)
    np.testing.assert_allclose(_port(coo, BWD, g), _ref(coo, BWD, g),
                               rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_takes_the_plain_path():
    coo = _layout(0, 300, 260, 2000)
    args = [torch.from_numpy(coo[k]) for k in FWD]
    h = torch.from_numpy(_h(0, coo["n_src_pad"], 16))
    before = dict(agg.launch_counts)
    out = agg.aggregate_edges(*args, h)
    assert torch.equal(out, agg.aggregate_edges_plain(*args, h))
    assert agg.launch_counts == before  # no kernel launched on the CPU


@pytest.mark.parametrize("bad", ["dtype", "seg_shape", "rows", "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    coo = _layout(0, 300, 260, 2000)
    args = [torch.from_numpy(coo[k]) for k in FWD]
    h = torch.from_numpy(_h(0, coo["n_src_pad"], 16))
    if bad == "dtype":
        args[0] = args[0].long()
    elif bad == "seg_shape":
        args[2] = args[2][:-1]
    elif bad == "rows":
        h = h[:-1]
    else:
        h = torch.from_numpy(_h(0, coo["n_src_pad"], 32))[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        agg.aggregate_edges(*args, h)


@pytest.mark.gpu
@pytest.mark.parametrize("layer", [0, 1])
def test_kernel_matches_plain_on_card(layer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    coo = _batch_layouts()[layer]
    cases = [(FWD, coo["n_src_pad"], 16), (BWD, coo["cols"].shape[0] * 128,
                                           16)]
    cases += [(FWD, coo["n_src_pad"], 101)]  # ragged F
    for keys, rows, F in cases:
        args = [torch.from_numpy(coo[k]).cuda() for k in keys]
        h = torch.from_numpy(_h(layer, rows, F)).cuda()
        before = agg.launch_counts["aggregate_edges"]
        out = agg.aggregate_edges(*args, h)
        torch.cuda.synchronize()
        assert agg.launch_counts["aggregate_edges"] == before + 1
        torch.testing.assert_close(out, agg.aggregate_edges_plain(*args, h),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 41, 128, 130, 602])
@pytest.mark.parametrize("case", list(plan.CASES) + ["all_masked"])
def test_kernel_matches_plain_on_card_bitwise_repeatable(case, F):
    """The redesigned kernel over the plan's cases (skewed rows, a row
    past a resolve chunk, empty blocks and layers, max_blk 1,280), from h,
    from a view of it one row in and from one two floats in (an 8-byte
    aligned base where h's is 16): within tolerance of the plain version,
    and the same bits from two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if case == "all_masked":  # edges, none of them valid
        coo = plan._layout([5] * 128 + [3] * 128, 400, mask_p=0.0)
    else:
        coo = plan._layout(*plan.CASES[case])
    args = [torch.from_numpy(coo[k]).cuda() for k in FWD]
    rows = coo["n_src_pad"]
    flat = torch.from_numpy(np.random.default_rng(F).standard_normal(
        (rows + 1) * F + 2).astype(np.float32)).cuda()
    views = {"base": flat[:rows * F].view(rows, F),
             "one_row_in": flat[F:(rows + 1) * F].view(rows, F),
             "two_floats_in": flat[2:rows * F + 2].view(rows, F)}
    for what, h in views.items():
        before = agg.launch_counts["aggregate_edges"]
        out = agg.aggregate_edges(*args, h)
        again = agg.aggregate_edges(*args, h)
        want = agg.aggregate_edges_plain(*args, h)
        torch.cuda.synchronize()
        assert agg.launch_counts["aggregate_edges"] == before + (
            2 if coo["tile_off"].size else 0), what
        assert torch.equal(out, again), what
        torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL * max(
            1.0, float(want.abs().max())), msg=what)


@pytest.mark.gpu
def test_autograd_backward_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    coo = _batch_layouts()[1]
    layout = [torch.from_numpy(coo[k]).cuda() for k in FWD + BWD]
    h = torch.from_numpy(_h(1, coo["n_src_pad"], 16)).cuda()
    g = torch.from_numpy(_h(2, coo["cols"].shape[0] * 128, 16)).cuda()
    hk = h.clone().requires_grad_(True)
    before = agg.launch_counts["aggregate_edges"]
    agg.AggregateEdges.apply(*layout, hk).backward(g)
    torch.cuda.synchronize()
    assert agg.launch_counts["aggregate_edges"] == before + 2  # fwd + bwd
    dh = agg.aggregate_edges_plain(*layout[4:], g)
    torch.testing.assert_close(hk.grad, dh, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["graphsage", "gcn"])
def test_trainer_on_card_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.core import scheduler as sched
    from repro_torch.core.trainer import SyncGNNTrainer
    from repro_torch.nn.param import flatten, params_to_numpy
    g = synthetic_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
    cfg = GNNModelConfig(name, hidden=16, fanouts=(4, 3), batch_targets=32,
                         aggregate_backend="pallas_edges")
    cpu = SyncGNNTrainer(g, cfg, num_devices=2, device="cpu")
    card = SyncGNNTrainer(g, cfg, num_devices=2, device="cuda",
                          params=params_to_numpy(cpu.params))
    groups = list(sched.iterations(cpu.epoch_schedule()))[:3]
    lrs = []
    for group in groups:
        before = agg.launch_counts["aggregate_edges"]
        m_card = card.run_iteration(group)
        # 2 devices' batches x (layer-0 fwd, layer-1 fwd, layer-1 bwd)
        assert agg.launch_counts["aggregate_edges"] - before == 6
        m_cpu = cpu.run_iteration(group)
        np.testing.assert_allclose(m_card["loss"], m_cpu["loss"], rtol=RTOL)
        lrs.append(m_cpu["lr"])
    # Adam can step an entry whose gradient is round-off on both sides by
    # the full learning rate either way (see test_torch_trainer.py)
    for a, b in zip(flatten(card.params), flatten(cpu.params)):
        a, b = a.cpu().numpy(), b.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * sum(lrs))
        assert np.isclose(a, b, rtol=1e-4, atol=1e-5).mean() > 0.99

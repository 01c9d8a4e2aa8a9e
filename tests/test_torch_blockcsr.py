"""The port's block-CSR datapath (``aggregate_backend="pallas"``) against
the reference's Pallas kernel.

On the CPU ``aggregate_blockcsr`` runs ``aggregate_blockcsr_plain``, held
against ``repro.kernels.aggregate.aggregate_blockcsr`` in interpret mode;
``densify_tiles`` is held bitwise against the reference's
``densify_tiles`` and ``densify_tiles_np``; ``AggregateCompact`` and
``AggregateBlockCSR`` against ``jax.vjp`` of ``aggregate_compact_vjp`` and
``aggregate_blockcsr_vjp``. ``real_slot_counts`` is held against the
numpy layout builder, and ``AggregateCompact``, which passes those counts
(the plain version then stops after the last real slot), bitwise against
the plain products over every slot. Tolerance rtol 1e-5, atol 1e-6 times the
largest magnitude of the reference (at least 1e-6): fp32 products that
contract 128 terms per slot, summed in another order. The tests marked
``gpu`` hold the CUDA kernel against its plain version on the card and
skip here; they need no JAX, so the reference is imported only by the
tests that use it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.kernels import aggregate as agg
from repro_torch.kernels.layout import (BLK, build_block_coo_pair,
                                        build_block_csr, densify_tiles_np)

RTOL, ATOL = 1e-5, 1e-6
FWD = ("tile_id", "tile_off", "val", "cols")
TRANSPOSE = ("tile_id_t", "tile_off_t", "val", "cols_t")

# sampled-layer shapes: n_src, n_dst, edges, share of edges kept, F, and
# max_blk (None = as many slots as the layout needs)
CASES = {
    "multi_block": dict(n_src=300, n_dst=260, n_edges=2000, F=16),
    "ragged_F70": dict(n_src=200, n_dst=130, n_edges=900, F=70),
    "paper_F602": dict(n_src=400, n_dst=300, n_edges=1500, F=602),
    "padding_slots": dict(n_src=500, n_dst=140, n_edges=300, F=33,
                          max_blk=6),
    "fully_masked": dict(n_src=150, n_dst=140, n_edges=500, F=8,
                         mask_p=0.0),
    "empty": dict(n_src=150, n_dst=140, n_edges=0, F=8),
}


def _edges(case, seed=0):
    """Distinct (src, dst) pairs with random weights — the sampler's
    per-layer contract: (src, dst, mask, values, n_src, n_dst, max_blk,
    F)."""
    kw = dict(CASES[case])
    F = kw.pop("F")
    mask_p = kw.pop("mask_p", 0.9)
    max_blk = kw.pop("max_blk", None)
    n_src, n_dst, n_edges = kw["n_src"], kw["n_dst"], kw["n_edges"]
    rng = np.random.default_rng(seed)
    pairs = rng.choice(n_src * n_dst, n_edges, replace=False)
    es = (pairs % n_src).astype(np.int32)
    ed = (pairs // n_src).astype(np.int32)
    em = rng.random(n_edges) < mask_p
    vals = rng.standard_normal(n_edges).astype(np.float32)
    return es, ed, em, vals, n_src, n_dst, max_blk, F


def _coo(case, seed=0):
    """The edges of ``_edges`` in the compact layout, with the operand
    width."""
    es, ed, em, vals, n_src, n_dst, max_blk, F = _edges(case, seed)
    return build_block_coo_pair(es, ed, em, n_src, n_dst, vals,
                                max_blk=max_blk), F


def _arr(seed, *shape):
    return np.random.default_rng(seed + 100).standard_normal(
        shape).astype(np.float32)


def _blocks(coo, transpose=False):
    tid, toff, _, cols = (coo[k] for k in (TRANSPOSE if transpose else FWD))
    return densify_tiles_np(tid, toff, coo["val"], *cols.shape), cols


def _atol(ref) -> float:
    return ATOL * max(1.0, float(np.abs(ref).max())) if ref.size else ATOL


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference(case):
    import jax.numpy as jnp
    from repro.kernels import aggregate as jagg
    coo, F = _coo(case)
    blocks, cols = _blocks(coo)
    h = _arr(1, coo["n_src_pad"], F)
    before = dict(agg.launch_counts)
    out = agg.aggregate_blockcsr(_t(blocks), _t(cols), _t(h)).numpy()
    assert agg.launch_counts == before  # the CPU takes the plain version
    ref = np.asarray(jagg.aggregate_blockcsr(
        jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(h),
        interpret=True))
    assert out.shape == ref.shape == (cols.shape[0] * BLK, F)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=_atol(ref))
    if case in ("fully_masked", "empty"):
        assert not out.any()


@pytest.mark.parametrize("case", ["multi_block", "padding_slots",
                                  "fully_masked", "empty"])
@pytest.mark.parametrize("transpose", [False, True])
def test_densify_tiles_bitwise(case, transpose):
    import jax.numpy as jnp
    from repro.kernels import aggregate as jagg
    from repro.kernels import layout as jlayout
    coo, _ = _coo(case)
    tid, toff, val, cols = (coo[k] for k in (TRANSPOSE if transpose
                                             else FWD))
    out = agg.densify_tiles(_t(tid), _t(toff), _t(val), *cols.shape).numpy()
    ref_np = jlayout.densify_tiles_np(tid, toff, val, *cols.shape)
    ref_j = np.asarray(jagg.densify_tiles(jnp.asarray(tid),
                                          jnp.asarray(toff),
                                          jnp.asarray(val), *cols.shape))
    assert out.shape == (*cols.shape, BLK, BLK)
    np.testing.assert_array_equal(out, ref_np)
    np.testing.assert_array_equal(out, ref_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_autograd_matches_jax_vjp(case):
    """``AggregateCompact`` walks only the real slots, forward over A and
    backward over A^T: bitwise the plain products over every slot of the
    densified tiles, and within tolerance of ``jax.vjp`` of the
    reference's ``aggregate_compact_vjp``."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import aggregate as jagg
    coo, F = _coo(case)
    h = _arr(2, coo["n_src_pad"], F)
    g = _arr(3, coo["cols"].shape[0] * BLK, F)
    keys = ("tile_id", "tile_off", "val", "cols", "tile_id_t",
            "tile_off_t", "cols_t")
    layout = [jnp.asarray(coo[k]) for k in keys]
    out_j, vjp = jax.vjp(
        lambda x: jagg.aggregate_compact_vjp(*layout, x, interpret=True),
        jnp.asarray(h))
    dh_j = np.asarray(vjp(jnp.asarray(g))[0])

    ht = _t(h).requires_grad_(True)
    out_t = agg.AggregateCompact.apply(*(_t(coo[k]) for k in keys), ht)
    out_t.backward(_t(g))
    (blocks, cols), (blocks_t, cols_t) = _blocks(coo), _blocks(coo, True)
    assert torch.equal(out_t.detach(), agg.aggregate_blockcsr_plain(
        _t(blocks), _t(cols), _t(h)))
    assert torch.equal(ht.grad, agg.aggregate_blockcsr_plain(
        _t(blocks_t), _t(cols_t), _t(g)))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=_atol(np.asarray(out_j)))
    np.testing.assert_allclose(ht.grad.numpy(), dh_j, rtol=RTOL,
                               atol=_atol(dh_j))


@pytest.mark.parametrize("case", ["multi_block", "ragged_F70"])
def test_blockcsr_autograd_matches_jax_vjp(case):
    import jax
    import jax.numpy as jnp
    from repro.kernels import aggregate as jagg
    coo, F = _coo(case)
    (blocks, cols), (blocks_t, cols_t) = _blocks(coo), _blocks(coo, True)
    h = _arr(4, coo["n_src_pad"], F)
    g = _arr(5, cols.shape[0] * BLK, F)
    dense = [jnp.asarray(x) for x in (blocks, cols, blocks_t, cols_t)]
    out_j, vjp = jax.vjp(
        lambda x: jagg.aggregate_blockcsr_vjp(*dense, x, interpret=True),
        jnp.asarray(h))
    dh_j = np.asarray(vjp(jnp.asarray(g))[0])

    ht = _t(h).requires_grad_(True)
    out_t = agg.AggregateBlockCSR.apply(
        *(_t(x) for x in (blocks, cols, blocks_t, cols_t)), ht)
    out_t.backward(_t(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=_atol(np.asarray(out_j)))
    np.testing.assert_allclose(ht.grad.numpy(), dh_j, rtol=RTOL,
                               atol=_atol(dh_j))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("transpose", [False, True])
def test_real_slot_counts_match_numpy_layout(case, transpose):
    """The counts cover every real slot of the numpy layout and no more:
    ``build_block_csr`` packs a block's real (nonzero) tiles first, and
    only row 0 may count one zero tile more, the slot a masked edge's
    tile_id 0 names."""
    es, ed, em, vals, n_src, n_dst, _, _ = _edges(case)
    coo, _ = _coo(case)
    tid, _, _, cols = (coo[k] for k in (TRANSPOSE if transpose else FWD))
    if transpose:
        es, ed, n_src, n_dst = ed, es, n_dst, n_src
    blocks, _, _ = build_block_csr(es, ed, em, n_src, n_dst, vals,
                                   max_blk=cols.shape[1])
    real = np.abs(blocks).sum(axis=(2, 3)) != 0   # (n_dstb, max_blk)
    want = real.sum(1)
    for row, n in zip(real, want):   # packed first
        assert row[:n].all() and not row[n:].any()
    got = agg.real_slot_counts(_t(tid), *cols.shape)
    assert got.dtype == torch.int32 and got.shape == (cols.shape[0],)
    got = got.numpy()
    masked_edge = bool((~em).any())
    if masked_edge and want[0] == 0:
        want[0] = 1
    np.testing.assert_array_equal(got, want)


def _counting_densify(monkeypatch):
    calls = []
    real = agg.densify_tiles

    def densify(tile_id, tile_off, val, n_tile_rows, max_blk):
        calls.append((n_tile_rows, max_blk))
        return real(tile_id, tile_off, val, n_tile_rows, max_blk)

    monkeypatch.setattr(agg, "densify_tiles", densify)
    return calls


@pytest.mark.parametrize("h_needs_grad", [False, True])
def test_transpose_densified_only_when_h_needs_grad(monkeypatch,
                                                    h_needs_grad):
    """Layer 0's h is the input features: its backward must not densify
    A^T (31.2 GB at the paper's batch). Here the loss also depends on a
    weight, so the backward runs either way."""
    calls = _counting_densify(monkeypatch)
    coo, F = _coo("multi_block")
    keys = ("tile_id", "tile_off", "val", "cols", "tile_id_t",
            "tile_off_t", "cols_t")
    h = _t(_arr(6, coo["n_src_pad"], F)).requires_grad_(h_needs_grad)
    w = _t(_arr(7, F, 4)).requires_grad_(True)
    out = agg.AggregateCompact.apply(*(_t(coo[k]) for k in keys), h)
    (out @ w).square().sum().backward()
    assert w.grad is not None
    want = [coo["cols"].shape]
    if h_needs_grad:
        want.append(coo["cols_t"].shape)
    assert calls == [tuple(s) for s in want]


def test_model_step_densifies_three_times(monkeypatch):
    """One GraphSAGE loss and backward on ``"pallas"``: layer-0 forward,
    layer-1 forward and layer-1 backward, the three launches of a
    training step on the card."""
    from repro_torch.core.sampler import NeighborSampler
    from repro_torch.core.trainer import batch_to_arrays
    from repro_torch.data.graphs import synthetic_graph
    from repro_torch.gnn import models as tm
    from repro_torch.kernels.layout import (block_capacities,
                                            build_layer_layouts)
    from repro_torch.nn.param import flatten, init_params, unflatten
    g = synthetic_graph(scale=10, edge_factor=6, feat_dim=16, num_classes=4)
    cfg = GNNModelConfig("graphsage", hidden=16, fanouts=(4, 3),
                         batch_targets=32, aggregate_backend="pallas")
    mb = NeighborSampler(g, cfg, g.train_ids).batch_at(0, 0)
    caps = block_capacities(cfg)
    layout = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                                 caps, "mean")
    feats = g.features[mb.nodes[0]] * mb.node_mask[0][:, None]
    batch = batch_to_arrays(mb, feats, "cpu", layout)
    params = init_params(tm.param_spec(cfg, 16, 4), 0, "cpu")
    leaves = [p.requires_grad_(True) for p in flatten(params)]
    calls = _counting_densify(monkeypatch)
    loss, _ = tm.loss_fn(cfg, unflatten(params, leaves), batch)
    torch.autograd.grad(loss, leaves)
    assert calls == [tuple(layout["agg_cols"][0].shape),
                     tuple(layout["agg_cols"][1].shape),
                     tuple(layout["agg_cols_t"][1].shape)]


@pytest.mark.parametrize("bad", ["dtype", "cols_dtype", "blocks_shape",
                                 "rows", "strided", "nblk_dtype",
                                 "nblk_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    coo, F = _coo("multi_block")
    blocks, cols = (_t(x) for x in _blocks(coo))
    h = _t(_arr(0, coo["n_src_pad"], F))
    nblk = None
    if bad == "dtype":
        h = h.double()
    elif bad == "cols_dtype":
        cols = cols.long()
    elif bad == "blocks_shape":
        blocks = blocks[:, :-1].contiguous()
    elif bad == "rows":
        h = h[:-1]
    elif bad == "nblk_dtype":
        nblk = torch.ones(cols.shape[0], dtype=torch.int64)
    elif bad == "nblk_shape":
        nblk = torch.ones(cols.shape[0] + 1, dtype=torch.int32)
    else:
        h = _t(_arr(0, coo["n_src_pad"], 2 * F))[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        agg.aggregate_blockcsr(blocks, cols, h, nblk)


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, counts):
    """Every slot (the ``ops.aggregate`` entry), or only the real slots
    with the destination blocks heaviest first (the trainer's), against
    the plain version over every slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    coo, F = _coo(case)
    for transpose, rows in ((False, coo["n_src_pad"]),
                            (True, coo["cols"].shape[0] * BLK)):
        blocks, cols = (_t(x).cuda() for x in _blocks(coo, transpose))
        nblk = (agg.real_slot_counts(
            _t(coo[(TRANSPOSE if transpose else FWD)[0]]).cuda(),
            *cols.shape) if counts else None)
        h = _t(_arr(8, rows, F)).cuda()
        before = agg.launch_counts["aggregate_blockcsr"]
        out = agg.aggregate_blockcsr(blocks, cols, h, nblk)
        torch.cuda.synchronize()
        assert agg.launch_counts["aggregate_blockcsr"] == before + 1
        want = agg.aggregate_blockcsr_plain(blocks, cols, h)
        torch.testing.assert_close(out, want, rtol=RTOL,
                                   atol=_atol(want.cpu().numpy()))


@pytest.mark.gpu
def test_compact_autograd_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    coo, F = _coo("ragged_F70")
    keys = ("tile_id", "tile_off", "val", "cols", "tile_id_t",
            "tile_off_t", "cols_t")
    h = _arr(9, coo["n_src_pad"], F)
    g = _arr(10, coo["cols"].shape[0] * BLK, F)
    res = []
    for dev in ("cpu", "cuda"):
        ht = _t(h).to(dev).requires_grad_(True)
        before = agg.launch_counts["aggregate_blockcsr"]
        out = agg.AggregateCompact.apply(
            *(_t(coo[k]).to(dev) for k in keys), ht)
        out.backward(_t(g).to(dev))
        launched = agg.launch_counts["aggregate_blockcsr"] - before
        assert launched == (2 if dev == "cuda" else 0)  # fwd + bwd
        res.append((out.detach().cpu(), ht.grad.cpu()))
    for a, b in zip(*res):
        torch.testing.assert_close(b, a, rtol=RTOL, atol=_atol(a.numpy()))


@pytest.mark.gpu
def test_pallas_trainer_on_card_matches_cpu():
    """GraphSAGE on ``"pallas"``: three kernel launches per device batch
    and iteration (layer-0 forward, layer-1 forward and backward), and the
    losses of the CPU's plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from repro_torch.core import scheduler as sched
    from repro_torch.core.trainer import SyncGNNTrainer
    from repro_torch.data.graphs import synthetic_graph
    from repro_torch.nn.param import params_to_numpy
    g = synthetic_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
    cfg = GNNModelConfig("graphsage", hidden=16, fanouts=(4, 3),
                         batch_targets=32, aggregate_backend="pallas")
    cpu = SyncGNNTrainer(g, cfg, num_devices=2, device="cpu")
    card = SyncGNNTrainer(g, cfg, num_devices=2, device="cuda",
                          params=params_to_numpy(cpu.params))
    for group in list(sched.iterations(cpu.epoch_schedule()))[:3]:
        agg.reset_launch_counts()
        m_card = card.run_iteration(group)
        assert {k: v for k, v in agg.launch_counts.items() if v} == {
            "aggregate_blockcsr": 6}
        m_cpu = cpu.run_iteration(group)
        np.testing.assert_allclose(m_card["loss"], m_cpu["loss"], rtol=RTOL)

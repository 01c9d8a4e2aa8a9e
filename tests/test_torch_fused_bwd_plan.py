"""The plan of ``fused_bwd``'s dw pass (``kernels/aggregate.py``:
``fused_bwd_shape`` and ``fused_bwd_plan``), on hand-made segment offsets,
and a plain-torch emulation of the grouped sum the CUDA kernel takes (one
partial per group, each summed over its blocks in order, the partials
added in group order) held against ``fused_bwd_plain``.

Tolerance as in ``test_torch_fused.py``: rtol 1e-5, and atol 1e-6 times
the largest magnitude of the plain result (at least 1e-6); the emulation
only sums the same products in another fixed order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import aggregate as agg
from repro_torch.kernels.layout import build_block_coo_pair

RTOL, ATOL = 1e-5, 1e-6
SMS = 132   # an H100's SMs
FWD = ("tile_off", "val", "tile_seg", "cols")


def _seg(edges_per_block, max_blk=6, seed=0):
    """Segment offsets (n_dstb*max_blk + 1,) int32 whose destination block
    i holds edges_per_block[i] edges, spread over its slots at random."""
    rng = np.random.default_rng(seed)
    per_slot = []
    for e in edges_per_block:
        cut = np.sort(rng.integers(0, e + 1, max_blk - 1))
        per_slot += np.diff(np.concatenate([[0], cut, [e]])).tolist()
    return torch.tensor(np.concatenate([[0], np.cumsum(per_slot)]),
                        dtype=torch.int32)


def _paper_layer0(seed=0):
    # the paper batch's layer 0: 208 destination blocks, the real rows in
    # the first 52, ~1,142 edges each
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1090, 1199, 52)] + [0] * 156


SEGS = {
    "paper_layer0": _paper_layer0(),
    "skewed": [0] * 17 + [3000] + [0] * 22,
    "front_quarter": [int(x) for x in np.random.default_rng(1).integers(
        200, 1200, 10)] + [0] * 30,
    "alternating": [0 if i % 2 == 0 else 7 * i for i in range(30)],
    "uniform": [300] * 64,
    "all_empty": [0] * 12,
    "one_block": [100],
    "tail_only": [0] * 9 + [50],
}


def _work(edges, dense):
    """Each block's work as the plan counts it, and whether it has any."""
    e = torch.tensor(edges, dtype=torch.int64)
    if dense:
        return e + agg._BWD_BLOCK_COST, torch.ones_like(e, dtype=torch.bool)
    return e, e > 0


@pytest.mark.parametrize("dense", [False, True], ids=["edges", "dense"])
@pytest.mark.parametrize("groups", [1, 3, 26, 64])
@pytest.mark.parametrize("name", list(SEGS))
def test_plan_cuts_busy_blocks_into_ordered_contiguous_groups(name, groups,
                                                              dense):
    edges = SEGS[name]
    n_dstb = len(edges)
    bounds = agg.fused_bwd_plan(_seg(edges), 6, groups, dense)
    assert bounds.dtype == torch.int64 and bounds.shape == (groups + 1,)
    b = bounds.tolist()
    assert b[0] == 0 and b[-1] <= n_dstb
    assert all(x <= y for x, y in zip(b, b[1:])), "groups out of order"
    work, busy = _work(edges, dense)
    # the groups are contiguous and ordered, so a block below b[-1] lies in
    # exactly one of them; past b[-1] no block may have work
    owner = torch.searchsorted(bounds, torch.arange(n_dstb), right=True) - 1
    inside = torch.arange(n_dstb) < b[-1]
    assert bool(inside[busy].all()), "a busy block falls in no group"
    assert bool((owner[inside] >= 0).all()) and bool(
        (owner[inside] < groups).all())
    # each group's work is within one block of an equal share
    total = int(work.sum())
    share = torch.zeros(groups, dtype=torch.int64).index_add_(
        0, owner[inside], work[inside])
    assert int(share.sum()) == total
    assert int(share.max()) <= total / groups + int(work.max())


@pytest.mark.parametrize("n_dstb,F,N", [
    (208, 602, 128), (8, 128, 41), (26, 602, 128), (1, 16, 8),
    (5000, 2048, 2048), (3, 5, 7), (40, 331, 41)])
def test_shape_keeps_partials_under_the_cap_in_one_wave(n_dstb, F, N):
    slab, groups = agg.fused_bwd_shape(n_dstb, F, N, SMS)
    assert slab % 32 == 0 and 32 <= slab <= 128
    assert 1 <= groups <= n_dstb
    assert groups == 1 or groups * F * N * 4 <= agg._BWD_PARTIAL_CAP
    ctas = groups * -(-F // slab) * -(-N // 128)
    assert groups == 1 or ctas <= SMS


def test_shape_fills_the_card_at_the_paper_shapes():
    # layer 0 of the paper batch: one thread block on at least 98% of the
    # SMs, in one wave
    slab, groups = agg.fused_bwd_shape(208, 602, 128, SMS)
    ctas = groups * -(-602 // slab)
    assert 0.98 * SMS <= ctas <= SMS
    assert groups * 602 * 128 * 4 <= agg._BWD_PARTIAL_CAP
    # layer 1 (8 blocks, F 128, N 41) takes narrower slabs than one a block
    slab1, groups1 = agg.fused_bwd_shape(8, 128, 41, SMS)
    assert groups1 == 8 and slab1 < 128


def _layout(n_src, n_dst, n_edges, dst_rows, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = dst_rows
    pairs = rng.choice(n_src * (hi - lo), n_edges, replace=False)
    es = (pairs % n_src).astype(np.int32)
    ed = (lo + pairs // n_src).astype(np.int32)
    em = rng.random(n_edges) < 0.9
    vals = rng.standard_normal(n_edges).astype(np.float32)
    return build_block_coo_pair(es, ed, em, n_src, n_dst, vals,
                                edge_stream=True)


LAYOUTS = {
    "skewed": (300, 40 * 128, 2000, (17 * 128, 18 * 128)),
    "front_quarter": (500, 40 * 128, 4000, (0, 10 * 128)),
    "spread": (300, 6 * 128 - 20, 2500, (0, 6 * 128 - 20)),
    "empty": (200, 5 * 128, 0, (0, 5 * 128)),
}


def _grouped_dw(coo, h, g, s, bias, groups):
    """dw and db as the kernel sums them: per group, z_i^T dy_i over its
    blocks in order (a block with no edge and no s skipped), then the
    partials in group order, over the groups the plan gave a block."""
    lay = [torch.from_numpy(coo[k]) for k in FWD]
    n_dstb, max_blk = coo["cols"].shape
    z = agg.aggregate_edges_plain(*lay, h)
    if s is not None:
        z = z + s
    bounds = agg.fused_bwd_plan(lay[2], max_blk, groups,
                                s is not None or bias).tolist()
    seg = lay[2][::max_blk].tolist()
    dw = torch.zeros(h.shape[1], g.shape[1])
    db = torch.zeros(g.shape[1])
    for grp in range(groups):
        if bounds[grp] == bounds[grp + 1]:
            continue
        part = torch.zeros_like(dw)
        part_b = torch.zeros_like(db)
        for i in range(bounds[grp], bounds[grp + 1]):
            rows = slice(i * 128, (i + 1) * 128)
            if seg[i + 1] > seg[i] or s is not None:
                part += z[rows].T @ g[rows]
            part_b += g[rows].sum(0)
        dw += part
        db += part_b
    return dw, (db if bias else None)


@pytest.mark.parametrize("groups", [1, 4, 7])
@pytest.mark.parametrize("bias,self_term", [(False, False), (True, False),
                                            (False, True)])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_grouped_sum_matches_plain(name, bias, self_term, groups):
    n_src, n_dst, n_edges, dst_rows = LAYOUTS[name]
    coo = _layout(n_src, n_dst, n_edges, dst_rows)
    rng = np.random.default_rng(3)
    n_pad = coo["cols"].shape[0] * 128
    F, N = 24, 41
    h = torch.from_numpy(rng.standard_normal(
        (coo["n_src_pad"], F)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n_pad, N)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((F, N)).astype(np.float32))
    b = torch.zeros(N) if bias else None
    s = (torch.from_numpy(rng.standard_normal((n_pad, F)).astype(
        np.float32)) if self_term else None)
    dw, db = _grouped_dw(coo, h, g, s, bias, groups)
    want_dw, want_db, _ = agg.fused_bwd_plain(
        *[torch.from_numpy(coo[k]) for k in FWD], h, g, w, b, s)
    torch.testing.assert_close(dw, want_dw, rtol=RTOL, atol=ATOL * max(
        1.0, float(want_dw.abs().max())))
    assert (db is None) == (want_db is None)
    if bias:
        torch.testing.assert_close(db, want_db, rtol=RTOL, atol=ATOL * max(
            1.0, float(want_db.abs().max())))

"""The shape of ``aggregate_fused``'s grid (``kernels/aggregate.py``:
``aggregate_fused_shape``) at the paper's shapes, and a plain-torch
emulation of the split sum the CUDA kernel takes (each rank of a cluster
sums the products of its slabs of z columns, r, r + cluster, ..., and the
ranks' partials are added in rank order before b and act) held against
``aggregate_fused_plain``.

Tolerance as in ``test_torch_fused.py``: rtol 1e-5, and atol 1e-6 times
the largest magnitude of the plain result (at least 1e-6); the emulation
only sums the same products in another fixed order.
"""
import numpy as np
import pytest
import torch

from test_torch_fused_bwd_plan import SEGS
from repro_torch.kernels import aggregate as agg
from repro_torch.kernels.layout import build_block_coo_pair
from repro_torch.kernels.update_mlp import update_epilogue

RTOL, ATOL = 1e-5, 1e-6
SMS = 132   # an H100's SMs
FWD = ("tile_off", "val", "tile_seg", "cols")
PAPER_SHAPES = {  # (n_dstb, F, N) of the paper batch's launches
    "layer0": (208, 602, 128),
    "layer1": (8, 128, 41),
    "gin128_layer0": (26, 602, 128),
    "gin128_layer1": (1, 128, 41),
}


def _ctas(n_dstb, N, cluster):
    return cluster * n_dstb * -(-N // 128)


def _check_shape(n_dstb, F, N):
    slab, cluster, rounds = agg.aggregate_fused_shape(n_dstb, F, N, SMS)
    slabs = -(-F // slab)
    assert slab in (160, 128, 32)
    assert 1 <= cluster <= 8
    # slabs x cluster covers F, every rank takes a slab, no round is idle
    assert slab * cluster * rounds >= F
    assert cluster <= max(1, slabs)
    assert rounds == -(-slabs // cluster)
    return slab, cluster, rounds


@pytest.mark.parametrize("name", list(PAPER_SHAPES))
def test_shape_fills_a_wave_at_the_paper_shapes(name):
    n_dstb, F, N = PAPER_SHAPES[name]
    slab, cluster, rounds = _check_shape(n_dstb, F, N)
    ctas = _ctas(n_dstb, N, cluster)
    if name in ("layer0", "gin128_layer0"):
        # F = 602 in four slabs of 160 (not five of 128): a cluster of 4,
        # one round; layer 0 fills a wave, GIN's 26 blocks fit in one
        assert (slab, cluster, rounds) == (160, 4, 1)
        assert ctas >= SMS if name == "layer0" else SMS / 2 < ctas <= SMS
    else:
        # too few blocks for a wave: the narrow slab spreads them widest
        assert (slab, cluster, rounds) == (32, 4, 1)
        assert ctas == 4 * n_dstb


@pytest.mark.parametrize("n_dstb,F,N", [
    (1, 16, 8), (5000, 2048, 2048), (3, 5, 7), (40, 331, 41),
    (3, 1100, 41), (40, 1100, 41), (40, 1300, 41), (2, 602, 128),
    (30, 512, 128), (1, 0, 5)])
def test_shape_covers_f_within_the_portable_cluster(n_dstb, F, N):
    slab, cluster, rounds = _check_shape(n_dstb, F, N)
    if slab != 32:  # a wide slab busies half the SMs
        assert 2 * _ctas(n_dstb, N, cluster) > SMS
    if slab == 160:  # only where 128 would take more slabs
        assert -(-F // 160) < -(-F // 128)
    if F > 8 * slab:  # past 8 slabs: the ranks take several rounds
        assert cluster == 8 and rounds > 1


def _layout(edges_per_block, n_src=700, seed=0):
    """A layout whose destination block i holds edges_per_block[i] edges
    (about 10% masked), at random rows and sources."""
    rng = np.random.default_rng(seed)
    n_dst = 128 * len(edges_per_block)
    ed = np.concatenate([128 * i + rng.integers(0, 128, e)
                         for i, e in enumerate(edges_per_block)] +
                        [np.zeros(0, np.int64)]).astype(np.int32)
    es = rng.integers(0, n_src, len(ed)).astype(np.int32)
    em = rng.random(len(ed)) < 0.9
    vals = rng.standard_normal(len(ed)).astype(np.float32)
    return build_block_coo_pair(es, ed, em, n_src, n_dst, vals,
                                edge_stream=True)


def _split_sum(lay, h, w, b, s, act, slab, cluster):
    """out as the kernel sums it: rank r's partial is the sum over its
    slabs r, r + cluster, ... of z[:, slab] @ w[slab]; the partials are
    added in rank order, then b and act; a block with no edge and no s
    writes act(b)."""
    z = agg.aggregate_edges_plain(*lay, h)
    if s is not None:
        z = z + s
    F = h.shape[1]
    n_slabs = -(-F // slab)
    y = torch.zeros(z.shape[0], w.shape[1])
    for r in range(cluster):
        part = torch.zeros_like(y)
        for k in range(r, n_slabs, cluster):
            cut = slice(k * slab, (k + 1) * slab)
            part += z[:, cut] @ w[cut]
        y += part
    out = update_epilogue(y, b, act)
    if s is None:
        max_blk = lay[3].shape[1]
        seg = lay[2][::max_blk]
        empty = (seg[1:] == seg[:-1]).repeat_interleave(128)
        out[empty] = update_epilogue(torch.zeros(1, w.shape[1]), b, act)
    return out


@pytest.mark.parametrize("F", [24, 331, 1300])
@pytest.mark.parametrize("bias,self_term,act", [
    (False, False, "none"), (True, False, "relu"), (False, True, "none"),
    (True, True, "gelu")])
@pytest.mark.parametrize("name", list(SEGS))
def test_split_sum_matches_plain(name, bias, self_term, act, F):
    coo = _layout(SEGS[name])
    lay = [torch.from_numpy(coo[k]) for k in FWD]
    n_dstb = coo["cols"].shape[0]
    N = 41
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal(
        (coo["n_src_pad"], F)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((F, N))
                          / np.sqrt(F)).astype(np.float32))
    b = (torch.from_numpy(rng.standard_normal(N).astype(np.float32))
         if bias else None)
    s = (torch.from_numpy(rng.standard_normal(
        (n_dstb * 128, F)).astype(np.float32)) if self_term else None)
    slab, cluster, rounds = agg.aggregate_fused_shape(n_dstb, F, N, SMS)
    if F == 1300:  # past 8 slabs at any width: several rounds a rank
        assert cluster == 8 and rounds > 1
    got = _split_sum(lay, h, w, b, s, act, slab, cluster)
    want = agg.aggregate_fused_plain(*lay, h, w, b, s, act)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL * max(
        1.0, float(want.abs().max())))
    if name == "all_empty":  # E == 0: act(s @ w + b)
        assert coo["tile_off"].size == 0 or int(coo["tile_seg"][-1]) == 0
        torch.testing.assert_close(
            want, update_epilogue(
                (s if s is not None else torch.zeros(n_dstb * 128, F)) @ w,
                b, act), rtol=RTOL, atol=ATOL)

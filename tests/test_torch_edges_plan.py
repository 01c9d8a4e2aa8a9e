"""The grid of ``aggregate_edges`` (``kernels/aggregate.py``:
``aggregate_edges_shape`` and ``aggregate_edges_vec``) at the paper's
launches and on small cases, and a plain emulation of the order the CUDA
kernel (``csrc/aggregate_edges.cu``) sums in, held against
``aggregate_edges_plain``: a thread block of each (row group, destination
block) resolves the block's edges CHUNK at a time, puts those of its rows
in row order by per-warp counts, gives each warp a run of whole rows with
about equal edges, and sums each row in edge order, resuming a row whose
edges span chunks from the sum it stored.

Tolerance as in ``test_torch_aggregate.py``: rtol 1e-5, and atol 1e-6
times the largest magnitude of the plain result (at least 1e-6); the
emulation sums the same products in another fixed order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import aggregate as agg
from repro_torch.kernels.layout import BLK, build_block_coo_pair

RTOL, ATOL = 1e-5, 1e-6
SMS = 132   # an H100's SMs
FWD = ("tile_off", "val", "tile_seg", "cols")
# as csrc/aggregate_edges.cu: edges resolved at once, warps of a thread
# block, columns a warp walks at once
CHUNK, WARPS, SPAN = 2048, 8, 128
PAPER_LAUNCHES = {  # (n_dstb, F) of the paper batch's launches
    "layer0_fwd": (208, 602),
    "layer1_fwd": (8, 128),
    "layer1_bwd": (208, 128),
}


@pytest.mark.parametrize("name", list(PAPER_LAUNCHES))
def test_shape_at_the_paper_launches(name):
    n_dstb, F = PAPER_LAUNCHES[name]
    groups = agg.aggregate_edges_shape(n_dstb, F, SMS)
    if name == "layer0_fwd":
        # 32 rows of 602 columns a thread block: the 52 busy destination
        # blocks become 208 thread blocks, which the card holds at once
        assert groups == 4
    elif name == "layer1_fwd":
        # 8 destination blocks become a thread block for about every SM
        assert groups == 16 and n_dstb * groups >= 0.95 * SMS
    else:
        assert groups == 4 and n_dstb * groups >= 4 * SMS


@pytest.mark.parametrize("n_dstb,F", [
    (1, 1), (1, 41), (3, 602), (8, 128), (208, 602), (208, 128), (5000, 4),
    (2, 4096), (40, 130), (0, 16)])
def test_shape_covers_every_row_and_column_once(n_dstb, F):
    groups = agg.aggregate_edges_shape(n_dstb, F, SMS)
    R = BLK // groups
    assert groups * R == BLK and R >= 8  # one warp a row at least
    rows = np.concatenate([g * R + np.arange(R) for g in range(groups)])
    assert np.array_equal(np.sort(rows), np.arange(BLK))
    if R > 8:  # rows stop halving once the grid fills the card
        assert n_dstb * groups >= 4 * SMS and R * F <= 32768
    for v in (4, 2, 1):
        if F % v:
            continue
        # lane l of a warp holds columns f0 + v (32 c + l) + [0, v) for
        # c < 4 / v, f0 stepping by SPAN; those at or past F are masked
        cols = np.concatenate([
            f0 + v * (32 * c + lane) + np.arange(v)
            for f0 in range(0, F, SPAN) for c in range(4 // v)
            for lane in range(32)])
        cols = cols[cols < F]
        assert np.array_equal(np.sort(cols), np.arange(F))


@pytest.mark.parametrize("F,offset,want", [
    (128, 0, 4), (602, 0, 2), (130, 0, 2), (41, 0, 1), (1, 0, 1),
    (602, 602, 2), (128, 2, 2), (128, 1, 1), (128, 128, 4)])
def test_vec_is_the_widest_load_row_length_and_base_allow(F, offset, want):
    flat = torch.zeros(4 * F + offset + 8)
    assert flat.data_ptr() % 16 == 0
    h = flat[offset:offset + 4 * F].view(4, F)
    assert h.is_contiguous()
    assert agg.aggregate_edges_vec(h) == want


def _layout(rows_edges, n_src, max_blk=None, seed=0, mask_p=0.9):
    """A layout of len(rows_edges) destination rows, row d holding
    rows_edges[d] distinct random sources (about 10% masked)."""
    rng = np.random.default_rng(seed)
    ed = np.concatenate([np.full(e, d) for d, e in enumerate(rows_edges)] +
                        [np.zeros(0, np.int64)]).astype(np.int32)
    es = np.concatenate([rng.choice(n_src, e, replace=False)
                         for e in rows_edges] +
                        [np.zeros(0, np.int64)]).astype(np.int32)
    perm = rng.permutation(len(ed))  # the sampler's edges come unsorted
    ed, es = ed[perm], es[perm]
    em = rng.random(len(ed)) < mask_p
    vals = rng.standard_normal(len(ed)).astype(np.float32)
    return build_block_coo_pair(es, ed, em, n_src, len(rows_edges), vals,
                                max_blk=max_blk, edge_stream=True)


def _row_order(rows, r0, R):
    """The places the kernel's counting sort gives one chunk's edges
    (``rows``: each edge's row in its destination block) for the group of
    rows r0 .. r0+R: warp w ranks the edges of its share [w*share,
    (w+1)*share); an edge's place is its row's start, plus the row's edges
    in earlier warps, plus those earlier in its warp. Returns (places of
    the kept edges, the kept edges, start (R+1,))."""
    n = len(rows)
    share = -(-n // (32 * WARPS)) * 32
    assert WARPS * share >= n and share <= CHUNK // WARPS
    keep = np.flatnonzero((rows >= r0) & (rows < r0 + R))
    rk = rows[keep] - r0
    warp = keep // share
    wcnt = np.zeros((WARPS, R), np.int64)
    lp = np.zeros(len(keep), np.int64)
    for j, (w, r) in enumerate(zip(warp, rk)):  # edges in order
        lp[j] = wcnt[w, r]
        wcnt[w, r] += 1
    woff = np.cumsum(wcnt, axis=0) - wcnt
    start = np.concatenate([[0], np.cumsum(wcnt.sum(0))])
    return start[rk] + woff[warp, rk] + lp, keep, start


def _runs(start, R):
    """Each warp's run of whole rows: from the first row starting at
    w/WARPS of the edges to the first starting at (w+1)/WARPS."""
    m = int(start[R])

    def first_row(target):
        return int(np.searchsorted(start[:R], target, side="left"))

    bounds = [first_row(w * m // WARPS) for w in range(WARPS)] + [R]
    return [(bounds[w], bounds[w + 1]) for w in range(WARPS)]


def _emulate(lay, h, groups):
    """out as the kernel forms it, in float32 sums of edge order."""
    tile_off, val, seg, cols = (t.numpy() for t in lay)
    h = h.numpy()
    n_dstb, max_blk = cols.shape
    R = BLK // groups
    out = np.full((n_dstb * BLK, h.shape[1]), np.nan, np.float32)
    for i in range(n_dstb):
        seg_i = seg[i * max_blk:(i + 1) * max_blk + 1]
        e_begin, e_end = int(seg_i[0]), int(seg_i[-1])
        for g in range(groups):
            r0 = g * R
            block = out[i * BLK + r0:i * BLK + r0 + R]
            started = np.zeros(R, bool)
            for c0 in range(e_begin, e_end, CHUNK):
                n = min(CHUNK, e_end - c0)
                e = c0 + np.arange(n)
                slot = np.searchsorted(seg_i, e, side="right") - 1
                off = tile_off[e].astype(np.int64)
                src = cols[i, slot].astype(np.int64) * BLK + off % BLK
                places, keep, start = _row_order(off // BLK, r0, R)
                m = int(start[R])
                # a stable sort of the group's edges by row
                assert np.array_equal(np.sort(places), np.arange(m))
                order = np.empty(m, np.int64)
                order[places] = keep
                assert np.array_equal(
                    order, keep[np.argsort(off[keep] // BLK, kind="stable")])
                runs = _runs(start, R)
                assert [r for lo, hi in runs for r in range(lo, hi)] == \
                    list(range(R))  # every row in one warp's run
                for lo, hi in runs:
                    for r in range(lo, hi):
                        edges = order[start[r]:start[r + 1]]
                        if not len(edges):
                            continue
                        acc = (block[r].copy() if started[r]
                               else np.zeros(h.shape[1], np.float32))
                        for x in edges:
                            acc = (acc + val[c0 + x] * h[src[x]]).astype(
                                np.float32)
                        block[r] = acc
                started |= start[1:] > start[:-1]
            block[~started] = 0.0
    return torch.from_numpy(out)


def _paper_like(seed=0):
    """Three destination blocks as at the paper's layer 0: ~9 edges a
    row, the last block empty."""
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(0, 19, 256)] + [0] * 128


CASES = {
    # (rows' edges, n_src, max_blk)
    "paper_like": (_paper_like(), 2000, None),
    "skewed": ([0] * 40 + [600] + [1] * 60 + [0] * 27 + [3] * 128, 1500,
               None),
    "row_past_a_chunk": ([2] * 70 + [2500] + [4] * 57, 2700, None),
    "block_past_a_chunk": ([20] * 128 + [0] * 128 + [17] * 128, 600, None),
    "empty_blocks": ([0] * 128 + [5] * 10 + [0] * 246 + [2] * 3, 400,
                     None),
    "empty_layer": ([0] * 256, 300, None),
    # layer 0's slot capacity: a 1,281-entry seg slice a block, most of
    # its slots empty
    "max_blk_1280": ([0] * 128 + [9] * 128, 8000, 1280),
}


@pytest.mark.parametrize("F", [1, 41, 128, 130, 602])
@pytest.mark.parametrize("name", list(CASES))
def test_emulated_order_matches_plain(name, F):
    rows_edges, n_src, max_blk = CASES[name]
    coo = _layout(rows_edges, n_src, max_blk)
    lay = [torch.from_numpy(coo[k]) for k in FWD]
    n_dstb = coo["cols"].shape[0]
    if max_blk is not None:
        assert coo["cols"].shape[1] == max_blk
    if name == "row_past_a_chunk":  # one row's valid edges span chunks
        valid = coo["tile_off"][:coo["tile_seg"][-1]]
        assert np.bincount(valid // BLK).max() > CHUNK
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal(
        (coo["n_src_pad"], F)).astype(np.float32))
    groups = agg.aggregate_edges_shape(n_dstb, F, SMS)
    want = agg.aggregate_edges_plain(*lay, h)
    for g in sorted({1, groups, 16}):
        got = _emulate(lay, h, g)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL * max(
            1.0, float(want.abs().max())))
    if name == "empty_layer":
        assert int(coo["tile_seg"][-1]) == 0 and not want.any()

"""The grid of ``fused_bwd_merged`` (``kernels/aggregate.py``:
``fused_bwd_merged_shape``, ``fused_bwd_merged_smem_bytes``), the layout
invariant that lets its dh role skip the scan of ``cols[0]``, and a plain
emulation of the order its dw role sums in, held against
``fused_bwd_merged_plain``.

The CUDA kernel (``csrc/aggregate_fused_bwd.cu``) runs one launch in two
roles. Its dh role is ``aggregate_edges``' thread block over A^T, so dh is
``aggregate_edges`` over the transposed segments; the reference instead
sets the source blocks that no slot of ``cols[0]`` names to +0.0. The two
agree because every transposed edge's source block is named by the
forward slot it came from: pinned here on the ``MERGED_CASES`` layouts of
``test_torch_fused.py`` and on a 128-target GIN batch. Its dw role cuts
the destination block's 128 rows into ``dw_groups`` groups; each forms its
rows of z in edge order, its partial z_R^T g_R (and sum_rows g_R), and the
partials are added in group order.

Tolerance as in ``test_torch_fused.py``: rtol 1e-5, and atol 1e-6 times
the largest magnitude of the plain result (at least 1e-6); the emulation
sums the same products in another fixed order.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core.sampler import NeighborSampler
from repro_torch.data.graphs import synthetic_graph
from repro_torch.gnn.models import AGG_KIND
from repro_torch.kernels import aggregate as agg
from repro_torch.kernels.layout import (BLK, block_capacities,
                                        build_layer_layouts)
import test_torch_edges_plan as plan
import test_torch_fused as fused

RTOL, ATOL = 1e-5, 1e-6
SMS = 132   # an H100's SMs
FWD = ("tile_off", "val", "tile_seg", "cols")
BWD = ("tile_off_t", "val_t", "tile_seg_t", "cols_t")
# the static shared memory of the row walk (csrc/edge_rows.cuh: Smem, as
# the build report gives it) and what two thread blocks of an SM may hold
# beside their dynamic shared memory (Hopper: 228 KB an SM, 1 KB of it
# reserved a block)
WALK_SMEM = 31_364
SM_SMEM = 233_472 - 2 * 1024


@pytest.mark.parametrize("n_srcb,F,N", [
    (26, 128, 41),   # GIN's last layer at 128 targets (chip_smoke.py)
    (1, 1, 1), (1, 16, 8), (3, 256, 257), (26, 200, 130), (208, 128, 41),
    (5000, 4, 2), (7, 101, 41)])
def test_shape_covers_every_row_and_column_once(n_srcb, F, N):
    dh_groups, dw_groups, ctas = agg.fused_bwd_merged_shape(n_srcb, F, N,
                                                            SMS)
    # the dh role: aggregate_edges' grid over A^T
    assert dh_groups == agg.aggregate_edges_shape(n_srcb, F, SMS)
    # the dw role: whole groups of the one destination block's rows, 8 at
    # a time into the product, one cluster of at most 16 thread blocks
    R = BLK // dw_groups
    assert dw_groups * R == BLK and R % 8 == 0 and 2 <= dw_groups <= 16
    rows = np.concatenate([k * R + np.arange(R) for k in range(dw_groups)])
    assert np.array_equal(rows, np.arange(BLK))
    # the grid: the dw cluster, then the dh row groups padded to whole
    # clusters; every (source block, row) once
    assert ctas % dw_groups == 0
    assert ctas - dw_groups >= dh_groups * n_srcb > ctas - 2 * dw_groups
    R_dh = BLK // dh_groups
    dh_rows = np.concatenate([j * BLK + k * R_dh + np.arange(R_dh)
                              for j in range(n_srcb)
                              for k in range(dh_groups)])
    assert np.array_equal(dh_rows, np.arange(n_srcb * BLK))
    # the dw role's columns: 16-column tiles of F, 8-column tiles of N in
    # passes of 128; those at or past F and N are masked
    f = np.concatenate([mt * 16 + np.arange(16) for mt in range(-(-F // 16))])
    n = np.concatenate([n0 + nt * 8 + np.arange(8)
                        for n0 in range(0, N, 128)
                        for nt in range(-(-min(128, N - n0) // 8))])
    assert np.array_equal(f[f < F], np.arange(F))
    assert np.array_equal(n[n < N], np.arange(N))
    # two thread blocks an SM with the row walk's static shared memory
    smem = agg.fused_bwd_merged_smem_bytes(F, dw_groups)
    assert 2 * (WALK_SMEM + smem) <= SM_SMEM


def test_shape_at_the_gin_launch():
    # 26 source blocks of 8-row groups for dh, a cluster of 16 dw thread
    # blocks of 8 rows
    assert agg.fused_bwd_merged_shape(26, 128, 41, SMS) == (16, 16, 432)
    assert agg.fused_bwd_merged_smem_bytes(128, 16) == 4 * 8 * (2 * 136 + 136)


@pytest.mark.parametrize("F", [1, 31, 128, 200, 256])
@pytest.mark.parametrize("dw_groups", [8, 16])
def test_dw_shared_memory_stays_under_the_budget(F, dw_groups):
    """Groups of at most 16 rows, at every F the merged branch takes (at
    most 256), keep two thread blocks an SM: the z and s tiles' rows hold
    F + 8 to F + 39 floats (a stride of 8 mod 32 banks), the g tile's 136."""
    smem = agg.fused_bwd_merged_smem_bytes(F, dw_groups)
    R = BLK // dw_groups
    ldz = -(-F // 32) * 32 + 8
    assert ldz % 32 == 8 and F + 8 <= ldz < F + 40
    assert smem == 4 * R * (2 * ldz + 136)
    assert 2 * (WALK_SMEM + smem) <= SM_SMEM


def _gin_batch():
    """Layer 1 of a 128-target GIN batch sampled from a small graph: one
    destination block."""
    g = synthetic_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
    cfg = GNNModelConfig("gin", hidden=16, fanouts=(4, 3), batch_targets=128,
                         aggregate_backend="pallas_fused")
    mb = NeighborSampler(g, cfg, g.train_ids).batch_at(0, 0)
    lay = build_layer_layouts(mb.edge_src, mb.edge_dst, mb.edge_mask,
                              block_capacities(cfg), AGG_KIND["gin"],
                              edge_stream=True)
    coo = {k[4:]: v[1] for k, v in lay.items()}
    coo["n_src_pad"] = coo["cols_t"].shape[0] * BLK
    assert coo["cols"].shape[0] == 1 and coo["tile_seg"][-1] > 0
    return coo


def _merged_layouts():
    names = sorted({c[0] for c in fused.MERGED_CASES})
    return [(name, fused._layout(name)) for name in names] + [
        ("gin128", _gin_batch())]


@pytest.mark.parametrize("name,coo", _merged_layouts(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_every_transposed_edge_lies_in_a_named_block(name, coo):
    """A source block with an edge of A^T is named by a slot of cols[0],
    so dh over A^T needs no mask: fused_bwd_merged_plain's dh (masked as
    the reference masks it) equals aggregate_edges_plain over A^T."""
    assert coo["cols"].shape[0] == 1
    n_srcb, max_blk_t = coo["cols_t"].shape
    seg_t = coo["tile_seg_t"]
    busy = np.flatnonzero(np.diff(seg_t[::max_blk_t]) > 0)
    named = set(coo["cols"][0][np.diff(coo["tile_seg"]) > 0].tolist())
    assert set(busy.tolist()) <= named
    F, N = 16, 8
    h, w, _, s, g = map(fused._t, fused._operands(coo, F, N, False, True))
    dz = g @ w.T
    lay = [torch.from_numpy(coo[k]) for k in FWD + BWD]
    _, _, dh = agg.fused_bwd_merged_plain(*lay, h, g, dz, s)
    assert torch.equal(dh, agg.aggregate_edges_plain(*lay[4:], dz))
    unnamed = sorted(set(range(n_srcb)) - named)
    for j in unnamed:
        rows = dh[j * BLK:(j + 1) * BLK]
        assert not rows.any() and not torch.signbit(rows).any()


def _emulate_dw(lay, h, g, s, has_bias, dw_groups):
    """dw (and db) as the kernel's dw role sums them: z's rows in edge
    order (``test_torch_edges_plan``'s emulation of the row walk, in the
    same groups), plus s; each group's partial z_R^T g_R and sum_rows g_R
    in float32; the partials added in group order from zero."""
    z = plan._emulate(lay, h, dw_groups).numpy()
    if s is not None:
        z = z + s.numpy()
    g = g.numpy()
    R = BLK // dw_groups
    dw = np.zeros((z.shape[1], g.shape[1]), np.float32)
    db = np.zeros(g.shape[1], np.float32)
    for k in range(dw_groups):
        rows = slice(k * R, (k + 1) * R)
        dw = dw + (z[rows].T @ g[rows]).astype(np.float32)
        db = db + g[rows].sum(0, dtype=np.float32)
    return torch.from_numpy(dw), (torch.from_numpy(db) if has_bias
                                  else None)


def _one_block(rows_edges, n_src, seed=0):
    """A one-destination-block layout whose row d holds rows_edges[d]
    distinct sources (about 10% masked)."""
    assert len(rows_edges) == BLK
    coo = plan._layout(rows_edges, n_src, seed=seed)
    assert coo["cols"].shape[0] == 1
    return coo


EMULATED = {
    # (rows' edges, n_src)
    "paper_like": ([int(x) for x in np.random.default_rng(5).integers(
        0, 19, BLK)], 3328),
    # one row past a 2,048-edge chunk: its group resumes its sum
    "row_past_a_chunk": ([2] * 70 + [2500] + [4] * 57, 2700),
    # rows 16 .. 63 empty: whole groups with no edge
    "empty_groups": ([5] * 16 + [0] * 48 + [3] * 64, 600),
    "no_edges": ([0] * BLK, 300),
}


@pytest.mark.parametrize("F,N,has_s,has_bias", [
    (128, 41, True, False), (256, 257, True, True), (16, 8, False, True),
    (101, 130, False, False)])
@pytest.mark.parametrize("name", list(EMULATED))
def test_emulated_dw_matches_plain(name, F, N, has_s, has_bias):
    rows_edges, n_src = EMULATED[name]
    coo = _one_block(rows_edges, n_src)
    if name == "row_past_a_chunk":
        valid = coo["tile_off"][:coo["tile_seg"][-1]]
        assert np.bincount(valid // BLK).max() > plan.CHUNK
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.standard_normal(
        (coo["n_src_pad"], F)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((BLK, N)).astype(np.float32))
    s = (torch.from_numpy(rng.standard_normal((BLK, F)).astype(np.float32))
         if has_s else None)
    dz = torch.from_numpy(rng.standard_normal((BLK, F)).astype(np.float32))
    lay = [torch.from_numpy(coo[k]) for k in FWD + BWD]
    want_dw, want_db, _ = agg.fused_bwd_merged_plain(*lay, h, g, dz, s,
                                                     has_bias)
    _, dw_groups, _ = agg.fused_bwd_merged_shape(coo["cols_t"].shape[0], F,
                                                 N, SMS)
    for groups in sorted({dw_groups, 4, 16}):
        dw, db = _emulate_dw(lay[:4], h, g, s, has_bias, groups)
        torch.testing.assert_close(dw, want_dw, rtol=RTOL, atol=ATOL * max(
            1.0, float(want_dw.abs().max())))
        assert (db is None) == (want_db is None)
        if db is not None:
            torch.testing.assert_close(db, want_db, rtol=RTOL, atol=ATOL * max(
                1.0, float(want_db.abs().max())))

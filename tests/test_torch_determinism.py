"""The ``"reference"`` datapath repeats its bits (ROADMAP.md C.6).

Its segment sums, forward and backward, are sorted segment reductions in
edge order (``gnn/models.py``: ``aggregate``, ``gather_rows``), never an
atomic ``index_add``, whose sums change order from run to run on CUDA. On
the CPU they are held against ``index_add`` (rtol 1e-5, atol 1e-6: fp32
sums in another order); the tests marked ``gpu`` run the same work twice
on the card and require equal bits, from one aggregation up to two
training iterations, and skip here.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.trainer import SyncGNNTrainer
from repro_torch.data.graphs import synthetic_graph
from repro_torch.gnn import models as tm
from repro_torch.nn.param import flatten

RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(num_layers=2, hidden=16, fanouts=(4, 3), batch_targets=32)


def _edges(seed=0, n_src=500, n_dst=200, E=20_000, F=24):
    """Many edges per source and destination row, so every sum has many
    terms, some of them masked."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n_src, F)).astype(
                np.float32)),
            torch.from_numpy(rng.integers(0, n_src, E).astype(np.int32)),
            torch.from_numpy(rng.integers(0, n_dst, E).astype(np.int32)),
            torch.from_numpy(rng.random(E) < 0.9), n_dst,
            torch.from_numpy(rng.standard_normal((n_dst, F)).astype(
                np.float32)))


def _aggregate_and_grad(h, src, dst, mask, n_dst, g, kind):
    h = h.clone().requires_grad_(True)
    out = tm.aggregate(h, src, dst, mask, n_dst, kind)
    out.backward(g)
    return out.detach(), h.grad


@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_segment_sums_match_index_add(kind):
    h, src, dst, mask, n_dst, g = _edges()
    out, dh = _aggregate_and_grad(h, src, dst, mask, n_dst, g, kind)
    m = mask.float()[:, None]
    agg = torch.zeros(n_dst, h.shape[1]).index_add(0, dst, h[src] * m)
    deg = torch.zeros(n_dst).index_add(0, dst, mask.float())[:, None]
    scale = deg.clamp_min(1.0) if kind == "mean" else torch.ones_like(deg)
    torch.testing.assert_close(out, agg / scale, rtol=RTOL, atol=ATOL)
    want = torch.zeros_like(h).index_add(0, src, (g / scale)[dst] * m)
    torch.testing.assert_close(dh, want, rtol=RTOL, atol=ATOL)


def test_empty_edge_list_gives_zeros():
    h, src, dst, mask, n_dst, g = _edges(E=0)
    out, dh = _aggregate_and_grad(h, src, dst, mask, n_dst, g, "mean")
    assert out.shape == (n_dst, h.shape[1]) and not out.any()
    assert not dh.any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_aggregate_repeats_its_bits_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: atomics change order only there")
    args = [x.cuda() if isinstance(x, torch.Tensor) else x
            for x in _edges(E=400_000)]
    first = _aggregate_and_grad(*args, kind)
    for _ in range(3):
        for a, b in zip(first, _aggregate_and_grad(*args, kind)):
            assert torch.equal(a, b)
    cpu = _aggregate_and_grad(*(x.cpu() if isinstance(x, torch.Tensor)
                                else x for x in args), kind)
    for a, b in zip(first, cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["graphsage", "gin"])
def test_reference_trainer_repeats_its_bits_on_card(name):
    """Two trainers on ``"reference"`` from one seed take the same batches
    and give bitwise the same losses and parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: atomics change order only there")
    g = synthetic_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
    cfg = GNNModelConfig(name, aggregate_backend="reference", **SMALL)
    runs = []
    for _ in range(2):
        t = SyncGNNTrainer(g, cfg, num_devices=2, device="cuda", seed=3)
        losses = [t.run_iteration(group)["loss"] for group in
                  list(sched.iterations(t.epoch_schedule()))[:2]]
        runs.append((losses, [p.cpu() for p in flatten(t.params)]))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 24, 128, 602])
def test_segment_sum_repeats_its_bits_on_card(F):
    """The card's segment sum (``index_put_`` with ``accumulate``: a stable
    sort of the index, each run of equal indices summed in order by one
    warp) at each width its kernels split on (one column, up to a warp,
    wider), over runs of up to a few hundred rows and empty segments: the
    same bits on every call, and within the summation error bound
    (n u sum|x|, n the longest run, u = 2^-24) of the float64 sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(F)
    n, E = 3_000, 300_000
    index = torch.from_numpy(rng.integers(0, n - 500, E)).cuda()
    x = torch.from_numpy(rng.standard_normal((E, F)).astype(
        np.float32)).cuda()
    segs = tm._segments(index, n)
    first = tm._segment_sum(x, segs)
    for _ in range(3):
        assert torch.equal(tm._segment_sum(x, segs), first)
    idx, xd = index.cpu(), x.cpu().double()
    exact = torch.zeros(n, F, dtype=torch.float64).index_add_(0, idx, xd)
    mag = torch.zeros(n, F, dtype=torch.float64).index_add_(0, idx, xd.abs())
    runs = int(torch.bincount(idx, minlength=n).max())
    err = (first.cpu().double() - exact).abs()
    assert bool((err <= runs * 2.0 ** -24 * mag).all())
    assert not first[n - 500:].any()   # the empty segments


@pytest.mark.gpu
@pytest.mark.parametrize("F", [1, 128])
def test_masked_segment_sum_on_card_spreads_the_padding(F):
    """Masked entries (+-0, as a masked message is) all naming row 0, as a
    batch's padding does, are summed into the spread rows past n and
    dropped: the sums equal the CPU's (which keeps them in row 0) within
    the error bound, repeat their bits, and the output has n rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(F)
    n, E, pad = 2_000, 200_000, 40_000
    index = torch.from_numpy(rng.integers(0, n, E))
    mask = torch.ones(E, dtype=torch.bool)
    mask[-pad:] = False
    index[-pad:] = 0
    x = torch.from_numpy(rng.standard_normal((E, F)).astype(np.float32))
    x[-pad:] = 0.0
    segs = tm._segments(index.cuda(), n, mask.cuda())
    first = tm._segment_sum(x.cuda(), segs)
    assert first.shape == (n, F)
    assert torch.equal(tm._segment_sum(x.cuda(), segs), first)
    cpu = tm._segment_sum(x, tm._segments(index, n, mask))
    xd = x.double()
    mag = torch.zeros(n, F, dtype=torch.float64).index_add_(0, index,
                                                             xd.abs())
    runs = int(torch.bincount(index[mask], minlength=n).max())
    err = (first.cpu().double() - cpu.double()).abs()
    assert bool((err <= 2 * runs * 2.0 ** -24 * mag).all())

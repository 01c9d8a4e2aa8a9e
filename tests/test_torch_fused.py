"""The port's fused aggregate -> update datapath against the reference's
Pallas kernels.

On the CPU each wrapper runs its plain version, which is held against
``repro.kernels.aggregate``'s ``aggregate_fused``, ``_fused_bwd_call`` and
``_fused_bwd_merged_call`` in interpret mode (under the test-local
``jax_shims``) and against the unfused composition
``ops.aggregate_update(..., use_pallas=False)``; ``AggregateFused``'s
gradients are held against ``jax.vjp`` of ``aggregate_fused_vjp`` in each
of its three backward branches. The tests marked ``gpu`` hold each CUDA
kernel against its plain version on the card and skip here.

Tolerance: rtol 1e-5, and atol 1e-6 times the largest magnitude in the
reference (at least 1e-6). The products here contract up to 331 features
or 384 rows of terms of size ~1-10, and fp32 sums taken in another order
differ by about sqrt(K)·eps of the terms' size; an element that cancels
towards zero keeps that absolute error, which a fixed atol of 1e-6 would
call a mismatch (1.9e-6 on an output of size 4 at F = 200, seen here).

In the gelu backward the reference's ``jax.grad`` of the tanh-form gelu
forms ``1 - tanh(u)^2`` and, in fp32, errs by up to 3.8e-6 (absolute,
against float64) where tanh saturates; the port's sigmoid form errs by
< 3e-7 (``test_gelu_derivative_against_float64`` pins both; ROADMAP.md
C.5). So the gelu backward cases run the reference on float64 operands
(under ``jax.enable_x64`` for the one call): its Pallas kernel still
accumulates the aggregate in fp32, but forms the update product and
gelu's derivative in float64, and the comparison keeps the tolerance
above.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from jax_reference_shims import jax_shims  # noqa: F401  (a fixture)
from repro_torch.kernels import aggregate as agg
from repro_torch.kernels.layout import build_block_coo_pair

RTOL, ATOL = 1e-5, 1e-6
FWD = ("tile_off", "val", "tile_seg", "cols")
BWD = ("tile_off_t", "val_t", "tile_seg_t", "cols_t")
ACTS = ("none", "relu", "gelu")

# sampled-layer shapes: (n_src, n_dst, edges, share of edges kept, whether
# (src, dst) pairs may repeat, so that several edges share one cell[, the
# destination rows [lo, hi) the edges land in, when not all of them])
LAYOUTS = {
    "multi_block": (300, 260, 2000, 0.9, False),
    "multi_edge": (200, 150, 3000, 0.9, True),
    "zero_edges": (150, 140, 0, 0.9, False),
    "fully_masked": (150, 140, 500, 0.0, False),
    "ragged_tail": (140, 130, 700, 0.9, False),
    "single_block": (300, 100, 1500, 0.9, False),
    "single_block_multi_edge": (200, 90, 1200, 0.9, True),
    "single_block_masked": (200, 90, 400, 0.0, False),
    # fused_bwd's plans on the card: every edge in 1 of 40 blocks; the real
    # rows in the first quarter of the blocks, as the sampler gives them;
    # the paper's layer-0 and layer-1 widths at fewer blocks
    "skewed": (300, 40 * 128, 2000, 0.9, False, (17 * 128, 18 * 128)),
    "front_quarter": (3000, 40 * 128, 6000, 0.9, False, (0, 10 * 128)),
    "layer0_like": (4000, 26 * 128, 9000, 0.95, True, (0, 7 * 128)),
    "layer1_like": (3328, 8 * 128, 8000, 0.95, False),
    # ~5,700 edges in one destination block: more than the 2,048 the dw
    # kernel resolves at once, so it walks the block in three chunks
    "dense_block": (600, 2 * 128, 6000, 0.95, False, (0, 128)),
    # one destination block whose row 5 holds ~2,850 edges: that row's
    # group walks it over two 2,048-edge chunks
    "single_block_dense_row": (3500, 100, 3000, 0.95, False, (5, 6)),
}


def _layout(name, seed=0):
    n_src, n_dst, n_edges, keep, repeat, *rows = LAYOUTS[name]
    lo, hi = rows[0] if rows else (0, n_dst)
    rng = np.random.default_rng(seed)
    if repeat:
        pairs = rng.integers(0, n_src * (hi - lo), n_edges)
    else:
        pairs = rng.choice(n_src * (hi - lo), n_edges, replace=False)
    es = (pairs % n_src).astype(np.int32)
    ed = (lo + pairs // n_src).astype(np.int32)
    em = rng.random(n_edges) < keep
    vals = rng.standard_normal(n_edges).astype(np.float32)
    return build_block_coo_pair(es, ed, em, n_src, n_dst, vals,
                                edge_stream=True)


def _arr(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _operands(coo, F, N, bias, self_term, seed=0):
    """h, w, b, s and an output cotangent g for one layout, as numpy."""
    n_dst_pad = coo["cols"].shape[0] * 128
    h = _arr(seed + 1, coo["n_src_pad"], F)
    w = _arr(seed + 2, F, N) / np.float32(np.sqrt(F))
    b = _arr(seed + 3, N) if bias else None
    s = _arr(seed + 4, n_dst_pad, F) if self_term else None
    g = _arr(seed + 5, n_dst_pad, N)
    return h, w, b, s, g


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _layout_t(coo, keys):
    return [torch.from_numpy(coo[k]) for k in keys]


def _layout_j(coo, keys):
    import jax.numpy as jnp
    return [jnp.asarray(coo[k]) for k in keys]


def _j(x, dtype=None):
    import jax.numpy as jnp
    return None if x is None else jnp.asarray(x, dtype)


def _reference_precision(act):
    """(context, float dtype) to run the reference's backward in: float64
    under ``jax.enable_x64`` for gelu (see the module docstring), else
    float32 as it is."""
    import contextlib

    import jax
    import jax.numpy as jnp
    if act == "gelu":
        return jax.enable_x64(True), jnp.float64
    return contextlib.nullcontext(), jnp.float32


def _atol(ref) -> float:
    ref = np.asarray(ref)
    return ATOL * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)


def _close(a, b, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=_atol(b), err_msg=what)


# every (act, bias, self term) combination, and a cycle of them over the
# layouts and widths so each layout meets several
COMBOS = list(itertools.product(ACTS, (False, True), (False, True)))
WIDTHS = (16, 200, 331)


def _cycled(layouts):
    return [(lay, F) + COMBOS[(i * len(WIDTHS) + j) % len(COMBOS)]
            for i, lay in enumerate(layouts) for j, F in enumerate(WIDTHS)]


FWD_CASES = (_cycled(["multi_block", "multi_edge", "zero_edges",
                      "fully_masked", "ragged_tail", "single_block"])
             + [("multi_block", 16) + c for c in COMBOS])


def _case_id(c):
    lay, F, act, bias, self_term = c
    return f"{lay}-F{F}-{act}{'-b' if bias else ''}{'-s' if self_term else ''}"


@pytest.mark.parametrize("case", FWD_CASES, ids=_case_id)
def test_plain_forward_matches_pallas_and_unfused(case, jax_shims):
    import jax
    from repro.kernels.aggregate import aggregate_fused as j_fused
    from repro.kernels.ops import aggregate_update
    lay, F, act, bias, self_term = case
    coo = _layout(lay)
    h, w, b, s, _ = _operands(coo, F, 41, bias, self_term)
    out = agg.aggregate_fused(*_layout_t(coo, FWD), _t(h), _t(w), _t(b),
                              _t(s), act=act)
    assert out.shape == (coo["cols"].shape[0] * 128, 41)
    assert out.dtype == torch.float32
    ref = jax.jit(j_fused, static_argnames=("act", "interpret"))(
        *_layout_j(coo, FWD), _j(h), _j(w), _j(b), _j(s), act=act,
        interpret=True)
    _close(out, ref, "vs the Pallas kernel")
    unfused = aggregate_update(*_layout_j(coo, FWD), _j(h), _j(w), _j(b),
                               _j(s), act=act, use_pallas=False)
    _close(out, unfused, "vs the unfused composition")


BWD_CASES = _cycled(["multi_block", "multi_edge", "fully_masked",
                     "ragged_tail", "single_block"])


@pytest.mark.parametrize("case", BWD_CASES, ids=_case_id)
def test_plain_backward_matches_pallas(case, jax_shims):
    import jax
    import jax.numpy as jnp
    from repro.kernels.aggregate import EDGE_CHUNK, _fused_bwd_call
    lay, F, act, bias, self_term = case
    coo = _layout(lay)
    h, w, b, s, g = _operands(coo, F, 41, bias, self_term)
    dw, db, dy = agg.fused_bwd(*_layout_t(coo, FWD), _t(h), _t(g), _t(w),
                               _t(b), _t(s), act=act)
    precision, fdt = _reference_precision(act)
    with precision:
        dw_j, db_j, dy_j = jax.jit(functools.partial(
            _fused_bwd_call, act=act, z_dtype=fdt, edge_chunk=EDGE_CHUNK,
            interpret=True))(*_layout_j(coo, FWD), *(
                _j(x, fdt) for x in (h, g, w, b, s)))
        dw_j, db_j, dy_j = (None if x is None else np.asarray(x)
                            for x in (dw_j, db_j, dy_j))
    _close(dw, dw_j, "dw")
    assert (db is None) == (db_j is None) == (not bias)
    if bias:
        _close(db, db_j, "db")
    assert (dy is None) == (dy_j is None) == (act == "none")
    if dy is not None:
        _close(dy, dy_j, "dy")


MERGED_CASES = [(lay, F, "none", bias, self_term)
                for lay in ("single_block", "single_block_multi_edge",
                            "single_block_masked")
                for F in (16, 200)
                for bias, self_term in ((False, False), (True, True))]
MERGED_CASES += [("single_block", 16, "none", True, False),
                 ("single_block", 200, "none", False, True)]


@pytest.mark.parametrize("case", MERGED_CASES, ids=_case_id)
def test_plain_merged_backward_matches_pallas(case, jax_shims):
    import jax
    import jax.numpy as jnp
    from repro.kernels.aggregate import (EDGE_CHUNK,
                                         _fused_bwd_merged_call)
    lay, F, _, bias, self_term = case
    coo = _layout(lay)
    assert coo["cols"].shape[0] == 1
    h, w, b, s, g = _operands(coo, F, 41, bias, self_term)
    dz = g @ w.T
    dw, db, dh = agg.fused_bwd_merged(
        *_layout_t(coo, FWD + BWD), _t(h), _t(g), _t(dz), _t(s),
        has_bias=bias)
    dw_j, db_j, dh_j = jax.jit(functools.partial(
        _fused_bwd_merged_call, z_dtype=jnp.float32, edge_chunk=EDGE_CHUNK,
        interpret=True))(*_layout_j(coo, FWD + BWD), _j(h), _j(g), _j(dz),
                         _j(w), _j(b), _j(s))
    _close(dw, dw_j, "dw")
    if bias:
        _close(db, db_j, "db")
    else:
        assert db is None
    _close(dh, dh_j, "dh")
    # source blocks no slot names are exactly +0.0, as in the reference
    named = set(coo["cols"][0].tolist())
    for blk in range(coo["n_src_pad"] // 128):
        if blk not in named:
            rows = dh[blk * 128:(blk + 1) * 128]
            assert not rows.any() and not torch.signbit(rows).any()


# (layout, act, bias, self term) per backward branch of AggregateFused
VJP_CASES = {
    "general": [("multi_block", "none", False, False),
                ("multi_block", "relu", True, True),
                ("ragged_tail", "gelu", True, False),
                ("multi_edge", "none", False, True)],
    "merged": [("single_block", "none", False, True),
               ("single_block_multi_edge", "none", True, False)],
    "zero_capacity": [("zero_edges", "none", False, True),
                      ("zero_edges", "relu", True, True)],
}


@pytest.mark.parametrize("branch,case", [
    (br, c) for br, cs in VJP_CASES.items() for c in cs],
    ids=lambda x: x if isinstance(x, str) else "-".join(map(str, x)))
def test_autograd_matches_jax_vjp(branch, case, jax_shims, monkeypatch):
    import jax
    import jax.numpy as jnp
    from repro.kernels.aggregate import EDGE_CHUNK, aggregate_fused_vjp
    lay, act, bias, self_term = case
    F, N = 24, 41
    coo = _layout(lay)
    h, w, b, s, g = _operands(coo, F, N, bias, self_term)

    calls = []
    for name in ("fused_bwd", "fused_bwd_merged"):
        real = getattr(agg, name)
        monkeypatch.setattr(agg, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    leaves = {k: (_t(v).clone().requires_grad_(True) if v is not None
                  else None)
              for k, v in dict(h=h, w=w, b=b, s=s).items()}
    out = agg.AggregateFused.apply(*_layout_t(coo, FWD + BWD), leaves["h"],
                                   leaves["w"], leaves["b"], leaves["s"],
                                   act)
    out.backward(torch.from_numpy(g))
    # a layer with no edges takes the general branch, as one with edges
    assert calls == {"general": ["fused_bwd"], "merged": ["fused_bwd_merged"],
                     "zero_capacity": ["fused_bwd"]}[branch]

    precision, fdt = _reference_precision(act)
    with precision:
        bj = _j(b, fdt) if bias else jnp.zeros((N,), fdt)
        sj = _j(s, fdt) if self_term else jnp.zeros((1, F), fdt)
        lay_j = _layout_j(coo, FWD + BWD)

        def f(h_, w_, b_, s_):
            return aggregate_fused_vjp(*lay_j, h_, w_, b_, s_, act, bias,
                                       self_term, None, EDGE_CHUNK, True)

        out_j, grads_j = jax.jit(lambda *a: (
            f(*a), jax.vjp(f, *a)[1](_j(g, fdt))))(_j(h, fdt), _j(w, fdt),
                                                  bj, sj)
        out_j = np.asarray(out_j)
        dh_j, dw_j, db_j, ds_j = (np.asarray(x) for x in grads_j)
    _close(out, out_j, "out")
    _close(leaves["h"].grad, dh_j, "dh")
    _close(leaves["w"].grad, dw_j, "dw")
    if bias:
        _close(leaves["b"].grad, db_j, "db")
    if self_term:
        _close(leaves["s"].grad, ds_j, "ds")


def test_gelu_derivative_against_float64():
    """The port's gelu derivative (plain version; the kernel uses the same
    sigmoid form) against float64, and the reference's ``jax.grad`` of
    ``jax.nn.gelu`` in fp32 against float64: the reason its gelu backward
    is compared in float64 (ROADMAP.md C.5)."""
    import jax
    import jax.numpy as jnp
    y = np.linspace(-9.0, 9.0, 200_001).astype(np.float32)
    yd = y.astype(np.float64)
    c = np.sqrt(2.0 / np.pi)
    t = np.tanh(c * (yd + 0.044715 * yd ** 3))
    exact = 0.5 * (1 + t) + 0.5 * yd * (1 - t * t) * c * (
        1 + 3 * 0.044715 * yd * yd)
    port = agg._act_grad(torch.from_numpy(y), "gelu").numpy()
    ref = np.asarray(jax.vmap(jax.grad(jax.nn.gelu))(jnp.asarray(y)))
    assert np.abs(port - exact).max() < 3e-7  # ~3 ulp of gelu' <= 1.13
    ref_err = np.abs(ref - exact).max()
    assert 1e-6 < ref_err < 4e-6


def test_merged_branch_without_dh_need_as_the_reference(monkeypatch):
    """One destination block takes the merged kernel as the reference does,
    even when h takes no gradient (the input features): its dh is dropped,
    and no aggregate_edges runs."""
    coo = _layout("single_block")
    h, w, _, _, g = _operands(coo, 16, 8, False, False)
    calls = []
    for name in ("fused_bwd", "fused_bwd_merged", "aggregate_edges"):
        real = getattr(agg, name)
        monkeypatch.setattr(agg, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    wt = torch.from_numpy(w).requires_grad_(True)
    out = agg.AggregateFused.apply(*_layout_t(coo, FWD + BWD), _t(h), wt,
                                   None, None, "none")
    out.backward(torch.from_numpy(g))
    assert calls == ["fused_bwd_merged"]
    _close(wt.grad, agg.fused_bwd_plain(*_layout_t(coo, FWD), _t(h), _t(g),
                                        wt.detach())[0])


def test_cpu_wrappers_take_the_plain_path():
    coo = _layout("multi_block")
    h, w, b, s, g = map(_t, _operands(coo, 16, 8, True, True))
    lay = _layout_t(coo, FWD)
    before = dict(agg.launch_counts)
    assert torch.equal(agg.aggregate_fused(*lay, h, w, b, s, act="relu"),
                       agg.aggregate_fused_plain(*lay, h, w, b, s, "relu"))
    for a, p in zip(agg.fused_bwd(*lay, h, g, w, b, s, act="gelu"),
                    agg.fused_bwd_plain(*lay, h, g, w, b, s, "gelu")):
        assert torch.equal(a, p)
    coo1 = _layout("single_block")
    h1, w1, _, _, g1 = map(_t, _operands(coo1, 16, 8, False, False))
    dz = g1 @ w1.T
    lay1 = _layout_t(coo1, FWD + BWD)
    for a, p in zip(agg.fused_bwd_merged(*lay1, h1, g1, dz)[::2],
                    agg.fused_bwd_merged_plain(*lay1, h1, g1, dz)[::2]):
        assert torch.equal(a, p)
    assert agg.launch_counts == before  # no kernel launched on the CPU


@pytest.mark.parametrize("bad", ["w_rows", "b_shape", "s_shape", "act",
                                 "w_dtype", "z_dtype"])
def test_fused_wrapper_rejects_bad_inputs(bad):
    coo = _layout("multi_block")
    h, w, b, s, _ = map(_t, _operands(coo, 16, 8, True, True))
    kw = dict(act="none")
    if bad == "w_rows":
        w = w[:-1].contiguous()
    elif bad == "b_shape":
        b = b[:-1].contiguous()
    elif bad == "s_shape":
        s = s[:-128].contiguous()
    elif bad == "act":
        kw["act"] = "tanh"
    elif bad == "w_dtype":
        w = w.double()
    else:
        kw["z_dtype"] = torch.bfloat16
    err = NotImplementedError if bad == "z_dtype" else (TypeError,
                                                        ValueError)
    with pytest.raises(err):
        agg.aggregate_fused(*_layout_t(coo, FWD), h, w, b, s, **kw)


def test_merged_wrapper_rejects_more_than_one_destination_block():
    coo = _layout("multi_block")
    h, w, _, _, g = map(_t, _operands(coo, 16, 8, False, False))
    with pytest.raises(ValueError, match="one destination block"):
        agg.fused_bwd_merged(*_layout_t(coo, FWD + BWD), h, g[:128],
                             g[:128] @ w.T)


# -- on the card ----------------------------------------------------------------

def _cuda(xs):
    return [None if x is None else x.cuda() for x in xs]


@pytest.mark.gpu
@pytest.mark.parametrize("lay,F,N,act,bias,self_term", [
    ("multi_block", 16, 8, "none", False, False),
    ("multi_block", 331, 41, "gelu", True, True),
    ("multi_edge", 200, 130, "relu", True, False),
    ("ragged_tail", 101, 257, "none", False, True),
    ("zero_edges", 16, 41, "relu", True, True),
    ("fully_masked", 64, 41, "none", True, True),
])
def test_fused_kernels_match_plain_on_card(lay, F, N, act, bias, self_term):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    coo = _layout(lay)
    h, w, b, s, g = _cuda(map(_t, _operands(coo, F, N, bias, self_term)))
    lay_c = _cuda(_layout_t(coo, FWD))
    before = dict(agg.launch_counts)
    out = agg.aggregate_fused(*lay_c, h, w, b, s, act=act)
    bwd = agg.fused_bwd(*lay_c, h, g, w, b, s, act=act)
    torch.cuda.synchronize()
    assert agg.launch_counts["aggregate_fused"] == (
        before["aggregate_fused"] + 1)
    assert agg.launch_counts["fused_bwd"] == before["fused_bwd"] + 1
    want = agg.aggregate_fused_plain(*lay_c, h, w, b, s, act)
    torch.testing.assert_close(out, want, rtol=RTOL, atol=_atol(want.cpu()))
    for got, want in zip(bwd, agg.fused_bwd_plain(*lay_c, h, g, w, b, s,
                                                  act)):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, rtol=RTOL,
                                       atol=_atol(want.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("lay,F,N,act,bias,self_term", [
    ("skewed", 64, 41, "none", False, False),
    ("skewed", 128, 128, "none", True, True),
    ("front_quarter", 200, 130, "none", False, False),
    ("front_quarter", 331, 41, "relu", True, True),
    ("layer0_like", 602, 128, "none", False, False),
    ("layer0_like", 602, 128, "none", False, True),
    ("layer1_like", 128, 41, "none", False, False),
    ("layer1_like", 128, 41, "none", True, False),
    ("zero_edges", 602, 128, "none", False, True),
    ("zero_edges", 40, 41, "none", True, True),
    ("dense_block", 96, 41, "none", False, False),
    ("dense_block", 602, 128, "none", True, True),
])
def test_fused_bwd_plans_match_plain_on_card_bitwise_repeatable(
        lay, F, N, act, bias, self_term):
    """fused_bwd's dw pass over skewed, front-loaded and empty layouts at
    the paper's widths: against the plain version, and bitwise equal over
    two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    coo = _layout(lay)
    h, w, b, s, g = _cuda(map(_t, _operands(coo, F, N, bias, self_term)))
    lay_c = _cuda(_layout_t(coo, FWD))
    before = agg.launch_counts["fused_bwd"]
    first = agg.fused_bwd(*lay_c, h, g, w, b, s, act=act)
    second = agg.fused_bwd(*lay_c, h, g, w, b, s, act=act)
    torch.cuda.synchronize()
    assert agg.launch_counts["fused_bwd"] == before + 2
    want = agg.fused_bwd_plain(*lay_c, h, g, w, b, s, act)
    for got, again, ref in zip(first, second, want):
        assert (got is None) == (again is None) == (ref is None)
        if got is not None:
            torch.testing.assert_close(got, ref, rtol=RTOL,
                                       atol=_atol(ref.cpu()))
            assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("lay,F,N,act,bias,self_term", [
    ("skewed", 64, 41, "none", False, False),
    ("skewed", 128, 128, "relu", True, True),
    ("front_quarter", 200, 130, "none", False, False),
    # 9 slabs of 160 columns over a cluster of 8: rank 0 takes two
    ("front_quarter", 1300, 41, "none", True, False),
    ("layer0_like", 602, 128, "none", False, False),
    ("layer0_like", 602, 128, "none", False, True),
    ("layer1_like", 128, 41, "none", False, False),
    ("zero_edges", 602, 128, "none", False, True),
    ("dense_block", 96, 41, "none", False, False),
    # three resolve chunks, 19 slabs of 32 columns over a cluster of 8
    ("dense_block", 602, 128, "gelu", True, True),
    ("ragged_tail", 101, 257, "none", True, True),
    ("multi_block", 331, 41, "relu", True, False),
])
def test_fused_fwd_matches_plain_on_card_bitwise_repeatable(
        lay, F, N, act, bias, self_term):
    """aggregate_fused over skewed, front-loaded, empty and dense layouts at
    the paper's widths and past 8 slabs of z columns: against the plain
    version, and bitwise equal over two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    coo = _layout(lay)
    h, w, b, s, _ = _cuda(map(_t, _operands(coo, F, N, bias, self_term)))
    lay_c = _cuda(_layout_t(coo, FWD))
    before = agg.launch_counts["aggregate_fused"]
    first = agg.aggregate_fused(*lay_c, h, w, b, s, act=act)
    second = agg.aggregate_fused(*lay_c, h, w, b, s, act=act)
    torch.cuda.synchronize()
    assert agg.launch_counts["aggregate_fused"] == before + 2
    want = agg.aggregate_fused_plain(*lay_c, h, w, b, s, act)
    torch.testing.assert_close(first, want, rtol=RTOL, atol=_atol(want.cpu()))
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("lay,F,N,bias,self_term", [
    ("single_block", 16, 8, False, False),
    ("single_block", 200, 41, True, True),
    ("single_block_multi_edge", 101, 130, True, False),
    ("single_block_masked", 64, 41, False, True),
    ("single_block", 256, 257, True, True),
    ("single_block", 202, 41, False, True),
    ("single_block_dense_row", 128, 41, False, True),
    ("single_block_dense_row", 256, 130, True, False),
    ("single_block_multi_edge", 128, 41, False, True),
    ("single_block_masked", 256, 257, True, True),
])
def test_merged_kernel_matches_plain_on_card(lay, F, N, bias, self_term):
    """fused_bwd_merged against its plain version, in one launch a call,
    with the same bits from two launches, dh bit for bit the
    aggregate_edges kernel over A^T, and +0.0 (no sign bit) on the source
    blocks no slot of cols[0] names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    coo = _layout(lay)
    if lay == "single_block_dense_row":  # one row's edges span two chunks
        valid = coo["tile_off"][:coo["tile_seg"][-1]]
        assert np.bincount(valid // 128).max() > 2048
    h, w, _, s, g = _cuda(map(_t, _operands(coo, F, N, bias, self_term)))
    dz = (g @ w.T).contiguous()
    lay_c = _cuda(_layout_t(coo, FWD + BWD))
    before = dict(agg.launch_counts)
    got = agg.fused_bwd_merged(*lay_c, h, g, dz, s, has_bias=bias)
    torch.cuda.synchronize()
    assert agg.launch_counts == {**before, "fused_bwd_merged":
                                 before["fused_bwd_merged"] + 1}
    again = agg.fused_bwd_merged(*lay_c, h, g, dz, s, has_bias=bias)
    dh_edges = agg.aggregate_edges(*lay_c[4:], dz)
    torch.cuda.synchronize()
    assert agg.launch_counts["fused_bwd_merged"] == (
        before["fused_bwd_merged"] + 2)
    want = agg.fused_bwd_merged_plain(*lay_c, h, g, dz, s, bias)
    for a, b, p in zip(got, again, want):
        assert (a is None) == (b is None) == (p is None)
        if a is not None:
            torch.testing.assert_close(a, p, rtol=RTOL,
                                       atol=_atol(p.cpu()))
            assert torch.equal(a, b)
    assert torch.equal(got[2], dh_edges)
    for blk in sorted(set(range(coo["n_src_pad"] // 128))
                      - set(coo["cols"][0].tolist())):
        rows = got[2][blk * 128:(blk + 1) * 128]
        assert not rows.any() and not torch.signbit(rows).any()


@pytest.mark.gpu
@pytest.mark.parametrize("lay,F,N,bias,self_term", [
    ("single_block_dense_row", 128, 41, False, True),
    ("single_block_dense_row", 256, 130, True, False),
])
def test_merged_kernel_and_plain_repeat_their_bits_on_card(lay, F, N, bias,
                                                            self_term):
    """ROADMAP.md C.9: the merged kernel and its plain version each give
    one bit pattern over five runs, where a destination row holds ~1,500
    edges. The plain aggregate sums them in edge order (``index_put_`` with
    ``accumulate``); ``index_add_``'s atomics gave a new dw each run (20
    patterns in 20, ``tests/merged_plain_repeat.py``), at times past the
    allowance of the kernel's fixed-order dw."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    coo = _layout(lay)
    h, w, _, s, g = _cuda(map(_t, _operands(coo, F, N, bias, self_term)))
    dz = (g @ w.T).contiguous()
    lay_c = _cuda(_layout_t(coo, FWD + BWD))
    kernel = [agg.fused_bwd_merged(*lay_c, h, g, dz, s, has_bias=bias)
              for _ in range(5)]
    plain = [agg.fused_bwd_merged_plain(*lay_c, h, g, dz, s, bias)
             for _ in range(5)]
    torch.cuda.synchronize()
    for runs in (kernel, plain):
        for again in runs[1:]:
            for a, b in zip(runs[0], again):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b)
    for a, p in zip(kernel[0], plain[0]):
        if a is not None:
            torch.testing.assert_close(a, p, rtol=RTOL, atol=_atol(p.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("branch,case", [
    (br, c) for br, cs in VJP_CASES.items() for c in cs])
def test_autograd_on_card_matches_cpu(branch, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    lay, act, bias, self_term = case
    coo = _layout(lay)
    ops = _operands(coo, 24, 41, bias, self_term)
    grads = []
    for dev in ("cpu", "cuda"):
        leaves = [None if x is None
                  else _t(x).to(dev).requires_grad_(True) for x in ops[:4]]
        out = agg.AggregateFused.apply(
            *[t.to(dev) for t in _layout_t(coo, FWD + BWD)], *leaves, act)
        out.backward(_t(ops[4]).to(dev))
        grads.append([out.detach().cpu()] + [
            None if x is None else x.grad.cpu() for x in leaves])
    for a, b in zip(*grads):
        if a is not None:
            torch.testing.assert_close(b, a, rtol=RTOL, atol=_atol(a))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["graphsage", "gin"])
def test_fused_trainer_on_card_matches_cpu(name):
    """Three iterations on the card against the same trainer on the CPU.
    At this size layer 0 has two destination blocks (fused_bwd, no dh: the
    input features take none) and layer 1 one (fused_bwd_merged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs.gnn import GNNModelConfig
    from repro_torch.core import scheduler as sched
    from repro_torch.core.trainer import SyncGNNTrainer
    from repro_torch.data.graphs import synthetic_graph
    from repro_torch.nn.param import flatten, params_to_numpy
    g = synthetic_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
    cfg = GNNModelConfig(name, hidden=16, fanouts=(4, 3), batch_targets=32,
                         aggregate_backend="pallas_fused")
    cpu = SyncGNNTrainer(g, cfg, num_devices=2, device="cpu")
    card = SyncGNNTrainer(g, cfg, num_devices=2, device="cuda",
                          params=params_to_numpy(cpu.params))
    lrs = []
    for group in list(sched.iterations(cpu.epoch_schedule()))[:3]:
        before = dict(agg.launch_counts)
        m_card = card.run_iteration(group)
        got = {k: agg.launch_counts[k] - before[k] for k in before}
        # 2 devices' batches x (2 forwards, 1 general and 1 merged backward)
        assert {k: v for k, v in got.items() if v} == {
            "aggregate_fused": 4, "fused_bwd": 2, "fused_bwd_merged": 2}
        m_cpu = cpu.run_iteration(group)
        np.testing.assert_allclose(m_card["loss"], m_cpu["loss"], rtol=RTOL)
        lrs.append(m_cpu["lr"])
    # Adam can step an entry whose gradient is round-off on both sides by
    # the full learning rate either way (see test_torch_trainer.py)
    for a, b in zip(flatten(card.params), flatten(cpu.params)):
        a, b = a.cpu().numpy(), b.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * sum(lrs))
        assert np.isclose(a, b, rtol=1e-4, atol=1e-5).mean() > 0.99

"""``repro_torch.kernels.ops`` against ``repro.kernels.ops``: ``update``
(the ``update_mlp`` kernel), ``aggregate`` (``aggregate_blockcsr``) and
``aggregate_update`` (``aggregate_fused``, or the unfused composition),
``flash_attention`` (``flash_attention_fwd``, or the oracle) and ``wkv6``
(``wkv6_chunk``, or the oracle), called with the reference's signatures and keyword names on the same numpy
inputs. The reference runs its Pallas kernels in interpret mode; its fused
branch takes the test-local ``jax_shims``.

Tolerance: rtol 1e-5, and atol 1e-6 times the largest magnitude of the
reference (at least 1e-6): fp32 products contracting up to 602 terms,
summed in another order; ``flash_attention`` and ``wkv6`` keep the
reference's own tolerances, stated at their tests. The tests marked ``gpu`` hold the CUDA
``update_mlp`` against its plain version and drive the three entry points
on the card; they skip here. They need no JAX, so the reference is
imported only by the tests that use it.
"""
import numpy as np
import pytest
import torch

from jax_reference_shims import jax_shims  # noqa: F401  (a fixture)
from repro_torch.kernels import aggregate as agg
from repro_torch.kernels import ops
from repro_torch.kernels.layout import (BLK, build_block_coo_pair,
                                        densify_tiles_np)
from repro_torch.kernels.update_mlp import (plan, update_mlp,
                                            update_mlp_plain)

RTOL, ATOL = 1e-5, 1e-6
ACTS = ("none", "relu", "gelu")
# (M, K, N): the paper's layer-0 update (26,624 padded rows, 602
# features), a ragged M (1,000 = 7 x 128 + 104) with ragged K and N, and
# the last layer's (1,024 x 128) @ (128 x 41)
SHAPES = {"paper_layer0": (26_624, 602, 128), "ragged": (1_000, 70, 41),
          "paper_layer1": (1_024, 128, 41)}
# on the card also: K 1 and 7 (rows 4 and 28 bytes apart: 4-byte copies),
# and the 64 x 128 tile plan with a ragged M (17,001 = 265 x 64 + 41), K
# 602 (rows 8-byte aligned) and N 41
CARD_SHAPES = {**SHAPES, "one_row": (1, 3, 5), "k1": (300, 1, 41),
               "k7": (1_000, 7, 130), "big_tiles_ragged": (17_001, 602, 41)}


def _arr(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _atol(ref) -> float:
    return ATOL * max(1.0, float(np.abs(ref).max())) if ref.size else ATOL


def _mlp_operands(shape, seed=0):
    M, K, N = shape
    return (_arr(seed, M, K), _arr(seed + 1, K, N, scale=K ** -0.5),
            _arr(seed + 2, N))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_update_matches_reference(shape, act):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    x, w, b = _mlp_operands(SHAPES[shape])
    ref = np.asarray(jops.update(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), act=act))
    before = dict(agg.launch_counts)
    out = ops.update(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), act=act)
    assert agg.launch_counts == before  # the CPU takes the plain version
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=_atol(ref))


@pytest.mark.parametrize("act", ACTS)
def test_update_plain_branch_matches_reference(act):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    x, w, b = _mlp_operands(SHAPES["ragged"], seed=3)
    ref = np.asarray(jops.update(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), act=act, use_pallas=False))
    out = ops.update(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), act=act, use_pallas=False)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=_atol(ref))


@pytest.mark.parametrize("M,N,sms,want", [
    (26_624, 128, 132, 0),   # the paper's layer 0: 416 tiles of 64 x 128
    (1_024, 41, 132, 1),     # layer 1: 16 big tiles; 64 of 16 x 64
    (17_001, 41, 132, 0),    # 266 big tiles, two per SM
    (16_832, 128, 132, 1),   # 263: fewer than two per SM
    (1, 5, 132, 1), (16_896, 128, 132, 0), (4_096, 128, 16, 0)])
def test_update_mlp_tile_plan(M, N, sms, want):
    """The big 64 x 128 tiles only where they give at least two thread
    blocks per SM; else the 16 x 64 tiles, which spread a small output."""
    assert plan(M, N, sms) == want


@pytest.mark.parametrize("which", ["x", "w", "b"])
def test_update_refuses_bf16(which):
    args = dict(zip("xwb", (torch.from_numpy(a) for a in
                            _mlp_operands(SHAPES["ragged"]))))
    args[which] = args[which].bfloat16()
    with pytest.raises(NotImplementedError, match="A.15"):
        ops.update(args["x"], args["w"], args["b"], act="relu")


def _blockcsr(seed, n_src, n_dst, n_edges):
    rng = np.random.default_rng(seed)
    pairs = rng.choice(n_src * n_dst, n_edges, replace=False)
    es = (pairs % n_src).astype(np.int32)
    ed = (pairs // n_src).astype(np.int32)
    em = rng.random(n_edges) < 0.9
    vals = rng.standard_normal(n_edges).astype(np.float32)
    return build_block_coo_pair(es, ed, em, n_src, n_dst, vals,
                                edge_stream=True)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("F,feat_block", [(16, 256), (70, 256), (70, 32),
                                          (602, 256)])
def test_aggregate_matches_reference(F, feat_block, use_pallas):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    coo = _blockcsr(0, 300, 260, 1500)
    blocks = densify_tiles_np(coo["tile_id"], coo["tile_off"], coo["val"],
                              *coo["cols"].shape)
    h = _arr(4, coo["n_src_pad"], F)
    if use_pallas:
        ref = np.asarray(jops.aggregate(
            jnp.asarray(blocks), jnp.asarray(coo["cols"]), jnp.asarray(h),
            feat_block=feat_block))
    else:  # the reference's jit'd plain branch fails (ROADMAP.md C.7), so
        # its oracle is called as it is
        ref = jref.aggregate_dense_ref(blocks, coo["cols"], h)
    out = ops.aggregate(torch.from_numpy(blocks),
                        torch.from_numpy(coo["cols"]), torch.from_numpy(h),
                        feat_block=feat_block, use_pallas=use_pallas)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=_atol(ref))
    # the feature block does not change the port's result
    assert torch.equal(out, ops.aggregate(
        torch.from_numpy(blocks), torch.from_numpy(coo["cols"]),
        torch.from_numpy(h), use_pallas=use_pallas))


def _aggregate_update_operands(F, N, self_term, seed=5):
    coo = _blockcsr(seed, 300, 260, 1500)
    n_dst_pad = coo["cols"].shape[0] * BLK
    lay = [coo[k] for k in ("tile_off", "val", "tile_seg", "cols")]
    h = _arr(seed, coo["n_src_pad"], F)
    w = _arr(seed + 1, F, N, scale=F ** -0.5)
    b = _arr(seed + 2, N)
    s = _arr(seed + 3, n_dst_pad, F) if self_term else None
    return lay, h, w, b, s


def _both(lay, h, w, b, s, act, use_pallas):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    def j(x):
        return None if x is None else jnp.asarray(x)

    def t(x):
        return None if x is None else torch.from_numpy(x)
    ref = np.asarray(jops.aggregate_update(
        *map(j, lay), j(h), j(w), j(b), j(s), act=act,
        use_pallas=use_pallas))
    outs = [ops.aggregate_update(*map(t, lay), t(h), t(w), t(b), t(s),
                                 act=act, use_pallas=up)
            for up in (True, False)]
    return ref, outs


@pytest.mark.parametrize("act,self_term", [("none", False), ("relu", True),
                                           ("gelu", True)])
def test_aggregate_update_matches_reference_unfused(act, self_term):
    ref, outs = _both(*_aggregate_update_operands(70, 41, self_term), act,
                      use_pallas=False)
    for out in outs:  # the fused and the unfused branch of the port
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL,
                                   atol=_atol(ref))


def test_aggregate_update_matches_reference_fused(jax_shims):
    ref, outs = _both(*_aggregate_update_operands(33, 20, True), "relu",
                      use_pallas=True)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL,
                                   atol=_atol(ref))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("causal,sq,sk,d", [(True, 128, 128, 64),
                                            (False, 64, 192, 128)])
def test_flash_attention_matches_reference(causal, sq, sk, d, use_pallas):
    """Tolerance atol 2e-4 / rtol 1e-4, the reference's own
    (``tests/test_kernels.py``): fp32 softmax over up to 192 keys, in one
    pass against the kernel's online one."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    q, k, v = (_arr(20 + i, 3, n, d) for i, n in enumerate((sq, sk, sk)))
    ref = np.asarray(jops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, use_pallas=use_pallas))
    before = dict(agg.launch_counts)
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, use_pallas=use_pallas)
    assert agg.launch_counts == before
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("s,k,chunk", [(80, 32, 16), (48, 64, 8)])
def test_wkv6_matches_reference(s, k, chunk, use_pallas):
    """Tolerance atol 1e-4 / rtol 1e-4, the reference's own: fp32
    recurrences over up to 80 tokens, in chunks against the reference's
    chunks or token by token."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    args = (_arr(30, 3, s, k, scale=0.5), _arr(31, 3, s, k, scale=0.5),
            _arr(32, 3, s, k, scale=0.5), -np.exp(_arr(33, 3, s, k)),
            _arr(34, 3, 1, k, scale=0.5))
    ref = np.asarray(jops.wkv6(*map(jnp.asarray, args), chunk=chunk,
                               use_pallas=use_pallas))
    out = ops.wkv6(*map(torch.from_numpy, args), chunk=chunk,
                   use_pallas=use_pallas)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def _cuda(*xs):
    return [x.cuda() for x in xs]


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_update_mlp_kernel_matches_plain_on_card(shape, act):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w, b = _cuda(*(torch.from_numpy(a) for a in _mlp_operands(
        CARD_SHAPES[shape])))
    before = agg.launch_counts["update_mlp"]
    out = update_mlp(x, w, b, act)
    torch.cuda.synchronize()
    assert agg.launch_counts["update_mlp"] == before + 1
    want = update_mlp_plain(x, w, b, act)
    torch.testing.assert_close(out, want, rtol=RTOL,
                               atol=_atol(want.cpu().numpy()))


@pytest.mark.gpu
def test_entry_points_launch_their_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, w, b = _cuda(*(torch.from_numpy(a) for a in _mlp_operands(
        SHAPES["ragged"])))
    lay, h, w2, b2, s = _aggregate_update_operands(70, 41, True)
    lay = _cuda(*(torch.from_numpy(a) for a in lay))
    h, w2, s = _cuda(*(torch.from_numpy(a) for a in (h, w2, s)))
    coo = _blockcsr(0, 300, 260, 1500)
    blocks = torch.from_numpy(densify_tiles_np(
        coo["tile_id"], coo["tile_off"], coo["val"], *coo["cols"].shape))
    blocks, cols = _cuda(blocks, torch.from_numpy(coo["cols"]))
    hb = torch.from_numpy(_arr(4, coo["n_src_pad"], 70)).cuda()
    agg.reset_launch_counts()
    outs = [ops.update(x, w, b, act="relu"),
            ops.aggregate(blocks, cols, hb),
            ops.aggregate_update(*lay, h, w2, None, s),
            ops.aggregate_update(*lay, h, w2, None, s, use_pallas=False)]
    torch.cuda.synchronize()
    assert {k: v for k, v in agg.launch_counts.items() if v} == {
        "update_mlp": 1, "aggregate_blockcsr": 1, "aggregate_fused": 1,
        "aggregate_edges": 1}
    torch.testing.assert_close(outs[2], outs[3], rtol=RTOL,
                               atol=_atol(outs[3].cpu().numpy()))

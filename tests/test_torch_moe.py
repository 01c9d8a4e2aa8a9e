"""The port's MoE layer (``nn.moe``) against ``repro.nn.moe``: capacity,
the routing with its ties, the per-row ranks, the dispatch and the
combine, and ``moe_ffn`` on 2-D and 3-D inputs (a decode step's S = 1
among them), with and without dropped pairs, forward and gradients, in
fp32 and bf16. The smoke models are in ``tests/test_torch_moe_train.py``.
Inputs come from numpy seeds, and JAX is imported only inside the tests
(the card has none).

Tolerances, each atol times the largest magnitude of the reference's
result (at least 1), as ``tests/test_torch_lm.py``'s ``_close``:
* BLOCK_TOL, rtol 1e-4 / atol 1e-5: ``route`` and ``moe_ffn`` in fp32
  (products over at most 64 terms, the softmax and the sums over K taken
  in another order); the chosen experts and the kept pairs must be equal,
  and the dispatch buffer (a copy of rows) bitwise;
* BF16_TOL, rtol 2e-2 / atol 2e-2, and BF16_LOSS_TOL, rtol 1e-3 / atol
  1e-3 for the aux loss: bf16 tokens and weights (the dense model's bf16
  tolerances, ``tests/test_torch_lm_train.py``: bf16 values round in other
  places on the two sides).
The ``gpu`` test holds ``moe_ffn`` on the card against the CPU (skipped
here), fp32 with TF32 off, at MODEL_TOL (rtol 1e-4 / atol 1e-4): the same
experts and kept pairs, and two card runs bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoESpec
from repro_torch.nn import moe as tmoe

BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_LOSS_TOL = dict(rtol=1e-3, atol=1e-3)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _moe_params(d, f, m, seed=0, scale=0.2):
    """numpy weights of one MoE layer (the reference's spec order)."""
    from repro.nn.moe import moe_spec
    return {k: _normal(seed + i, *s.shape, scale=scale)
            for i, (k, s) in enumerate(sorted(moe_spec(d, f, m).items()))}


def _jax(p):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}


def _spec(E, K, cf=1.25, ef=0):
    from repro.configs.base import MoESpec as JSpec
    return (MoESpec(E, K, cf, ef), JSpec(E, K, cf, ef))


def _reference_keep(experts, E, C):
    """The reference's ranking (``_moe_ffn_spmd``) of (B, S, K) experts:
    which pairs it keeps."""
    import jax
    import jax.numpy as jnp
    B = experts.shape[0]
    flat_e = jnp.asarray(experts).reshape(B, -1)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, E, dtype=jnp.int32), axis=1) - 1
    rank = jnp.take_along_axis(pos, flat_e[..., None], axis=2)[..., 0]
    return np.asarray(rank < C).reshape(experts.shape)


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 64, 1000, 4096])
@pytest.mark.parametrize("E,K,cf", [(64, 8, 1.25), (8, 2, 1.25), (8, 2, 0.5),
                                    (64, 8, 8.0), (4, 2, 2.0)])
def test_capacity_matches_reference(n, E, K, cf):
    from repro.nn.moe import capacity as j_capacity
    mine, theirs = _spec(E, K, cf)
    assert tmoe.capacity(n, mine) == j_capacity(n, theirs)
    assert tmoe.capacity(n, mine) % 8 == 0


@pytest.mark.parametrize("E,K", [(8, 2), (64, 8), (4, 2)])
def test_route_matches_reference(E, K):
    """Weights, experts (equal, in the same order) and the aux loss, with
    gradients of a weighted sum of the weights and the aux loss."""
    import jax
    import jax.numpy as jnp
    from repro.nn.moe import route as j_route
    mine, theirs = _spec(E, K)
    x, w = _normal(0, 40, 32), _normal(1, 32, E, scale=0.3)
    c = _normal(2, 40, K)

    def j_obj(w, x):
        wt, ex, aux = j_route(w, x, theirs)
        return jnp.sum(wt * c) + aux, (wt, ex, aux)
    (_, (jw, je, ja)), (jgw, jgx) = jax.jit(jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True))(jnp.asarray(w), jnp.asarray(x))
    tw, tx = (torch.from_numpy(a).requires_grad_() for a in (w, x))
    wt, ex, aux = tmoe.route(tw, tx, mine)
    assert ex.dtype == torch.int64 and wt.dtype == aux.dtype == torch.float32
    assert np.array_equal(ex.numpy(), np.asarray(je))
    _close(wt, jw, BLOCK_TOL)
    _close(aux, ja, BLOCK_TOL)
    gw, gx = torch.autograd.grad((wt * torch.from_numpy(c)).sum() + aux,
                                 (tw, tx))
    _close(gw, jgw, BLOCK_TOL)
    _close(gx, jgx, BLOCK_TOL)


@pytest.mark.parametrize("E,K", [(64, 8), (8, 2)])
def test_route_ties_pick_the_reference_experts(E, K):
    """A zero router gives every row a uniform distribution: both pick
    experts 0..K-1 in order. A router whose second half of columns repeats
    the first half ties every expert with its twin: both pick the same
    experts in the same order (the lower index first)."""
    from repro.nn.moe import route as j_route
    mine, theirs = _spec(E, K)
    x = _normal(3, 16, 24)
    _, je, _ = j_route(np.zeros((24, E), np.float32), x, theirs)
    _, te, _ = tmoe.route(torch.zeros(24, E), torch.from_numpy(x), mine)
    want = np.broadcast_to(np.arange(K), (16, K))
    assert np.array_equal(np.asarray(je), want)
    assert np.array_equal(te.numpy(), want)
    half = _normal(4, 24, E // 2)
    w = np.concatenate([half, half], axis=1)
    _, je, _ = j_route(w, x, theirs)
    _, te, _ = tmoe.route(torch.from_numpy(w), torch.from_numpy(x), mine)
    assert np.array_equal(te.numpy(), np.asarray(je))
    # twins come in pairs, the lower first
    assert (te[:, 0::2] < te[:, 1::2]).all()


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_dispatch_and_combine_match_reference(cf):
    """One batch row: the port's buffer is the reference's
    ``_local_dispatch`` buffer (bitwise: a copy of rows), its kept pairs
    the reference's, and ``combine`` over the same expert outputs the
    reference's ``_local_combine``."""
    import jax.numpy as jnp
    from repro.nn.moe import _local_combine, _local_dispatch
    from repro.nn.moe import capacity as j_capacity
    E, K, N, d = 8, 2, 48, 16
    mine, theirs = _spec(E, K, cf)
    C = j_capacity(N, theirs)
    x, w = _normal(5, N, d), _normal(6, d, E, scale=0.5)
    jbuf, jw, _, jslots = _local_dispatch(
        jnp.asarray(x), jnp.asarray(w), theirs, C, jnp.float32)
    jkeep = jslots[2]
    wt, ex, _ = tmoe.route(torch.from_numpy(w), torch.from_numpy(x), mine)
    slots = tmoe.rank(ex.view(1, N, K), mine, C)
    assert slots.C == C
    keep = slots.keep.reshape(-1).numpy()
    assert np.array_equal(keep, np.asarray(jkeep))
    if cf < 1:
        assert not keep.all()
    buf = tmoe.dispatch(torch.from_numpy(x)[None], slots, E)
    assert tuple(buf.shape) == (E, C, d)
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))
    out_buf = _normal(7, E, C, d)
    want = _local_combine(jnp.asarray(out_buf), jw, jslots, N, d, C)
    got = tmoe.combine(torch.from_numpy(out_buf), wt.view(1, N, K), slots)
    _close(got[0], want, BLOCK_TOL)


def test_ranks_are_counted_per_batch_row():
    """Two batch rows routed alike keep the same pairs: the count starts
    again at each row (``capacity(S)`` a row, not ``capacity(B * S)``)."""
    E, K, S = 4, 2, 24
    mine, _ = _spec(E, K, 0.5)
    C = tmoe.capacity(S, mine)
    ex = torch.from_numpy(np.random.default_rng(8).integers(
        0, E, (1, S, K))).expand(3, S, K).contiguous()
    slots = tmoe.rank(ex, mine, C)
    assert np.array_equal(slots.keep.numpy(), _reference_keep(ex.numpy(), E,
                                                              C))
    assert torch.equal(slots.keep[0], slots.keep[2])
    assert not slots.keep.all()
    kept = slots.write[slots.keep]
    assert len(torch.unique(kept)) == len(kept)       # one pair a row
    assert (slots.write[~slots.keep] >= E * 3 * C).all()   # the overflow


@pytest.mark.parametrize("shape,cf", [((2, 24, 32), 1.25), ((37, 32), 1.25),
                                      ((3, 20, 32), 0.5), ((30, 32), 0.5),
                                      ((4, 1, 32), 1.25)])
def test_moe_ffn_matches_reference(shape, cf):
    """``moe_ffn`` on 3-D and 2-D inputs (a 2-D input is one batch row),
    a decode step's S = 1 among them: the output, the aux loss and the
    gradients of every weight and of x. With capacity_factor 0.5 pairs
    are dropped (on both sides: the kept pairs are equal)."""
    import jax
    import jax.numpy as jnp
    from repro.nn.moe import capacity as j_capacity
    from repro.nn.moe import moe_ffn as j_moe_ffn
    from repro.nn.moe import route as j_route
    E, K, d, f = 8, 2, 32, 48
    mine, theirs = _spec(E, K, cf)
    p = _moe_params(d, f, theirs)
    x = _normal(9, *shape)
    c = _normal(10, *shape)

    def j_obj(p, x):
        out, aux = j_moe_ffn(p, x, theirs)
        return jnp.sum(out * c) + aux, (out, aux)
    (_, (jo, ja)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True))(_jax(p), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_ffn(tp, tx, mine)
    assert out.shape == tx.shape and out.dtype == torch.float32
    x3 = x if x.ndim == 3 else x[None]
    _, je, _ = j_route(jnp.asarray(p["router"]), jnp.asarray(
        x3.reshape(-1, d)), theirs)
    C = j_capacity(x3.shape[1], theirs)
    _, te, _ = tmoe.route(tp["router"], torch.from_numpy(x3.reshape(-1, d)),
                          mine)
    assert np.array_equal(te.numpy(), np.asarray(je))
    keep = _reference_keep(np.asarray(je).reshape(*x3.shape[:2], K), E, C)
    if cf < 1:
        assert not keep.all()
    _close(out, jo, BLOCK_TOL)
    _close(aux, ja, BLOCK_TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(c)).sum() + aux,
                                [tp[k] for k in sorted(tp)] + [tx])
    for got, want in zip(grads, [jgp[k] for k in sorted(tp)] + [jgx]):
        _close(got, want, BLOCK_TOL)


def test_moe_ffn_bf16_matches_reference():
    """bf16 weights and tokens (the reference's fp32 draws rounded on both
    sides): the output at BF16_TOL, the aux loss at BF16_LOSS_TOL, the
    same experts."""
    import jax.numpy as jnp
    from repro.nn.moe import moe_ffn as j_moe_ffn
    E, K, d, f = 8, 2, 64, 64
    mine, theirs = _spec(E, K)
    p = _moe_params(d, f, theirs, seed=11)
    x = _normal(12, 2, 16, d)
    jo, ja = j_moe_ffn({k: v.astype(jnp.bfloat16) for k, v in
                        _jax(p).items()}, jnp.asarray(x, jnp.bfloat16),
                       theirs)
    out, aux = tmoe.moe_ffn(_torch(p, torch.bfloat16),
                            torch.from_numpy(x).bfloat16(), mine)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close(out, np.asarray(jo.astype(jnp.float32)), BF16_TOL)
    _close(aux, np.asarray(ja), BF16_LOSS_TOL)


# ---------------------------------------------------------------------------
# on the card (skipped here)
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_ffn_on_card_matches_the_cpu(cf):
    """fp32 ``moe_ffn`` (forward and gradients) on the card against the
    CPU from the same weights: the same experts and kept pairs, the rest
    at MODEL_TOL; two card runs give the same bits."""
    _card()
    E, K, d, f = 64, 8, 256, 128
    m = MoESpec(E, K, cf)
    gen = torch.Generator().manual_seed(0)
    p = {"router": torch.randn(d, E, generator=gen) * 0.1,
         "wi_gate": torch.randn(E, d, f, generator=gen) * d ** -0.5,
         "wi_up": torch.randn(E, d, f, generator=gen) * d ** -0.5,
         "wo": torch.randn(E, f, d, generator=gen) * f ** -0.5}
    x = torch.randn(2, 512, d, generator=gen)
    c = torch.randn(2, 512, d, generator=gen)
    out = {}
    for dev in ("cpu", "cuda", "cuda"):
        tp = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        tx = x.to(dev).requires_grad_()
        y, aux = tmoe.moe_ffn(tp, tx, m)
        grads = torch.autograd.grad((y * c.to(dev)).sum() + aux,
                                    [tp[k] for k in sorted(tp)] + [tx])
        _, ex, _ = tmoe.route(tp["router"], tx.reshape(-1, d), m)
        res = [t.detach().cpu() for t in (y, aux, *grads)] + [ex.cpu()]
        if dev in out:
            assert all(torch.equal(a, b) for a, b in zip(res, out[dev]))
        out[dev] = res
    assert torch.equal(out["cuda"][-1], out["cpu"][-1])
    for got, want in zip(out["cuda"][:-1], out["cpu"][:-1]):
        _close(got, want.numpy(), MODEL_TOL)

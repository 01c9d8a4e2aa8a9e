"""RWKV-6's training step in the port against ``repro``: the plain WKV6
backward (``wkv6_chunk_bwd_plain``) against ``jax.vjp`` of the reference's
``wkv6_chunked`` and against autograd through ``wkv6_chunk_plain``; the
CUDA backward's design in plain PyTorch (walks a span of 64 tokens a step
against the 16-token walk's boundaries, the span pass's algebra, the
scratch layout); the ``WKV6Chunk`` autograd op; ``timemix`` in train
mode; ``rwkv.loss_fn`` with every gradient leaf (remat on and off, fp32
and bf16); three
``make_train_step`` steps with gradient accumulation; the launcher
(``launch.train --arch rwkv6-3b``); and what the backward's wrapper refuses
before any launch (CPU tensors sent down its card path to a stubbed
launch). Inputs come from numpy seeds, the reference's parameters are
carried across by ``nn.param.params_from_numpy``, and JAX is imported only
inside the tests (the card has none).

Tolerances, each atol times the largest magnitude of the reference's
result (at least 1):
* BLOCK_TOL, rtol 1e-4 / atol 1e-5: the WKV6 gradients and ``timemix`` in
  fp32 (fp32 sums over up to 1,024 tokens in chunks of 16 against the
  reference's chunks, whose length divides S: 1 at S = 37; measured worst
  5.5e-6 of the scale in a float64 check);
* MODEL_TOL, rtol 1e-4 / atol 1e-4: the loss and every gradient leaf of
  the two-layer smoke model, and the parameters, moments and metrics after
  three AdamW steps (measured worst 1.3e-6 of a leaf's scale);
* BF16_TOL, rtol 2e-2 / atol 2e-2 and BF16_LOSS_TOL, rtol 1e-3 / atol
  1e-3: the bf16 smoke model. The reference's ``wkv6_chunked`` rounds the
  pairwise decays and A to bf16 (2^-8 relative) where the port's kernel
  keeps fp32, and bf16 activations round in other places on the two
  sides; the embedding table's gradient sums repeated tokens' bf16 rows
  (measured worst over three seeds: 1.6e-2 of the table's scale, 2e-3 for
  every other leaf, 1.6e-4 of the loss). These are the dense model's bf16
  tolerances (``tests/test_torch_lm_train.py``).
The ``gpu`` tests hold the CUDA backward against its plain version on the
card (skipped here): fp32 at WKV_TOL (rtol 1e-4 / atol 1e-4, the
forward's); in bf16 dr, dk and dv (rounded to bf16 by both) at rtol 1e-2
with that atol, dlw, du and ds0 (fp32 from the same bf16 inputs) at
WKV_TOL. Two launches give the same bits.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import wkv6 as wk
from repro_torch.kernels.wkv6 import (WKV6Chunk, wkv6_chunk_bwd,
                                      wkv6_chunk_bwd_plain, wkv6_chunk_plain)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build, sample_inputs
from repro_torch.nn import rwkv6 as trw
from repro_torch.nn.param import (flatten, params_from_numpy,
                                  params_to_numpy, unflatten)
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedules import get_schedule

BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
GRADS = ("dr", "dk", "dv", "dlw", "du", "ds0")


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol):
    """assert_allclose with atol times the largest magnitude of ``want``
    (at least 1)."""
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _wkv_case(B, S, H, K, seed=0, strong=False, batch_u=False):
    """r, k, v, lw, u, s0, dy, ds as numpy fp32. ``strong``: log-decays
    down to -e^3 (decays to e^-20 a token)."""
    r, k, v = (_normal(seed + i, B, S, H, K, scale=0.5) for i in range(3))
    x = _normal(seed + 3, B, S, H, K)
    lw = -np.exp(np.clip(x, -3, 3) if strong else x)
    if strong:
        lw[:, ::3] = -np.exp(3.0)
    u = _normal(seed + 4, *((B,) if batch_u else ()), H, K, scale=0.5)
    s0 = _normal(seed + 5, B, H, K, K)
    dy = _normal(seed + 6, B, S, H, K)
    ds = _normal(seed + 7, B, H, K, K)
    return r, k, v, lw.astype(np.float32), u, s0, dy, ds


# ---------------------------------------------------------------------------
# the plain backward
# ---------------------------------------------------------------------------

def _reference_vjp(r, k, v, lw, u, s0, dy, ds):
    """The six gradients by ``jax.vjp`` of the reference's
    ``wkv6_chunked`` (a per-batch u vmapped over the batch)."""
    import jax
    import jax.numpy as jnp
    from repro.nn.rwkv6 import wkv6_chunked

    def f(r, k, v, lw, u, s0):
        if u.ndim == 2:
            return wkv6_chunked(r, k, v, lw, u, s0)
        y, st = jax.vmap(lambda *a: wkv6_chunked(
            *(t[None] for t in a[:4]), a[4], a[5][None]))(r, k, v, lw, u, s0)
        return y[:, 0], st[:, 0]
    _, vjp = jax.vjp(f, *map(jnp.asarray, (r, k, v, lw, u, s0)))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(ds)))]


@pytest.mark.parametrize("S,state,final,batch_u,strong", [
    (64, False, False, False, False),
    (64, True, True, False, False),
    (37, False, True, True, False),     # ragged; the reference's chunk is 1
    (37, True, False, False, False),
    (64, True, True, True, True),       # strong decays
    (1024, True, True, False, False),   # dlw over a long sequence
])
def test_plain_bwd_matches_reference_vjp(S, state, final, batch_u, strong):
    r, k, v, lw, u, s0, dy, ds = _wkv_case(2, S, 3, 16, seed=S,
                                           strong=strong, batch_u=batch_u)
    if not state:
        s0 = np.zeros_like(s0)
    if not final:
        ds = np.zeros_like(ds)
    want = _reference_vjp(r, k, v, lw, u, s0, dy, ds)
    got = wkv6_chunk_bwd_plain(*map(torch.from_numpy, (r, k, v, lw, u)),
                               torch.from_numpy(s0) if state else None,
                               torch.from_numpy(dy),
                               torch.from_numpy(ds) if final else None)
    assert got[5] is None if not state else got[5].shape == s0.shape
    for name, g, w in zip(GRADS, got, want):
        if g is None:
            continue
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        _close(g, w, BLOCK_TOL)


@pytest.mark.parametrize("S,state,final,batch_u", [
    (48, True, True, False), (21, False, False, True), (16, True, False,
                                                        True)])
def test_plain_bwd_matches_autograd_through_the_plain_forward(S, state,
                                                              final, batch_u):
    r, k, v, lw, u, s0, dy, ds = map(torch.from_numpy, _wkv_case(
        2, S, 2, 32, seed=7, batch_u=batch_u))
    leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u, s0)]
    y, st = wkv6_chunk_plain(*leaves[:5], leaves[5] if state else None)
    loss = (y * dy).sum() + ((st * ds).sum() if final else 0)
    want = torch.autograd.grad(loss, leaves[:5] + leaves[5:] * state)
    got = wkv6_chunk_bwd_plain(r, k, v, lw, u, s0 if state else None, dy,
                               ds if final else None)
    for g, w in zip(got, want):
        _close(g, w.numpy(), BLOCK_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [True, False])
def test_wkv6chunk_gradients_are_the_plain_backward(state, dtype):
    """On the CPU the autograd op's forward is ``wkv6_chunk_plain`` and its
    backward ``wkv6_chunk_bwd_plain``, bit for bit; a final state that
    nothing uses gets no cotangent (None, not zeros)."""
    r, k, v, lw, u, s0, dy, ds = map(torch.from_numpy, _wkv_case(
        1, 40, 2, 16, seed=3))
    r, k, v, u, dy = (t.to(dtype) for t in (r, k, v, u, dy))
    for use_state in (True, False):
        leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u, s0)]
        y, st = WKV6Chunk.apply(*leaves[:5], leaves[5] if state else None)
        y_p, st_p = wkv6_chunk_plain(r, k, v, lw, u, s0 if state else None)
        assert torch.equal(y, y_p) and torch.equal(st, st_p)
        loss = (y.float() * dy.float()).sum() + (
            (st * ds).sum() if use_state else 0)
        got = torch.autograd.grad(loss, leaves[:5] + leaves[5:] * state)
        want = wkv6_chunk_bwd_plain(r, k, v, lw, u, s0 if state else None,
                                    dy, ds if use_state else None)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype or w.dtype == torch.float32
            assert torch.equal(g, w.to(g.dtype))


# ---------------------------------------------------------------------------
# the kernel's design in plain PyTorch: walks a span of 64 tokens a step,
# chunk boundaries rebuilt inside each span, the pairs in four groups
# ---------------------------------------------------------------------------

def _chunk_walks(r, k, v, lw, s0, dy, ds, chunk=wk.CHUNK):
    """``wkv6_chunk_bwd_plain``'s walks, 16 tokens a step: the state at each
    chunk's start, the cotangent at each chunk's end, and ds0."""
    starts, s = [], s0
    for t0 in range(0, k.shape[1], chunk):
        starts.append(s)
        kc, vc, lwc = (a[:, t0:t0 + chunk] for a in (k, v, lw))
        c = torch.cumsum(lwc, dim=1)
        s = torch.exp(c[:, -1])[..., None] * s + torch.einsum(
            "blhk,blhv->bhkv", kc * torch.exp(c[:, -1:] - c), vc)
    ends, d = [None] * len(starts), ds
    for ci in reversed(range(len(starts))):
        ends[ci] = d
        rc, dyc, lwc = (a[:, ci * chunk:(ci + 1) * chunk] for a in (r, dy, lw))
        c = torch.cumsum(lwc, dim=1)
        d = torch.exp(c[:, -1])[..., None] * d + torch.einsum(
            "blhk,blhv->bhkv", rc * torch.exp(c - lwc), dyc)
    return starts, ends, d


def _span_walks(r, k, v, lw, s0, dy, ds, span=wk.SPAN):
    """The kernel's walks (``wkv6_bwd_walk``), a span a step: the state at
    each span's start, the cotangent at each span's end, and ds0. The
    state's tokens decay by D_t, the sum of lw after t in the span; the
    cotangent's by E_t, the sum before t; each sum is taken in its own
    direction, so no difference of two long cumsums enters an exponent."""
    def shift(x, first):   # x moved one token on, `first` filling the gap
        pad = torch.zeros_like(x[:, :1])
        return (torch.cat([pad, x[:, :-1]], 1) if first
                else torch.cat([x[:, 1:], pad], 1))
    starts, s = [], s0
    for t0 in range(0, k.shape[1], span):
        starts.append(s)
        kc, vc, lwc = (a[:, t0:t0 + span] for a in (k, v, lw))
        after = torch.cumsum(lwc.flip(1), 1).flip(1)          # sum_{u>=t}
        s = torch.exp(after[:, 0])[..., None] * s + torch.einsum(
            "blhk,blhv->bhkv", kc * torch.exp(shift(after, False)), vc)
    ends, d = [None] * len(starts), ds
    for n in reversed(range(len(starts))):
        ends[n] = d
        rc, dyc, lwc = (a[:, n * span:(n + 1) * span] for a in (r, dy, lw))
        upto = torch.cumsum(lwc, 1)                           # sum_{u<=t}
        d = torch.exp(upto[:, -1])[..., None] * d + torch.einsum(
            "blhk,blhv->bhkv", rc * torch.exp(shift(upto, True)), dyc)
    return starts, ends, d


def _rebuilt(r, k, v, lw, dy, starts, ends, span=wk.SPAN, chunk=wk.CHUNK):
    """Every chunk's start state and end cotangent rebuilt inside its span
    from the span's records, as ``wkv6_bwd_span`` does: the state forward
    from the span's start, the cotangent backward from its end."""
    S = k.shape[1]
    s_all, d_all = [], []
    for n, t0 in enumerate(range(0, S, span)):
        cs = list(range(t0, min(t0 + span, S), chunk))
        s, d_span = starts[n], [None] * len(cs)
        for t1 in cs:
            s_all.append(s)
            kc, vc, lwc = (a[:, t1:t1 + chunk] for a in (k, v, lw))
            c = torch.cumsum(lwc, dim=1)
            s = torch.exp(c[:, -1])[..., None] * s + torch.einsum(
                "blhk,blhv->bhkv", kc * torch.exp(c[:, -1:] - c), vc)
        d = ends[n]
        for i in reversed(range(len(cs))):
            d_span[i] = d
            rc, dyc, lwc = (a[:, cs[i]:cs[i] + chunk] for a in (r, dy, lw))
            c = torch.cumsum(lwc, dim=1)
            d = torch.exp(c[:, -1])[..., None] * d + torch.einsum(
                "blhk,blhv->bhkv", rc * torch.exp(c - lwc), dyc)
        d_all += d_span
    return s_all, d_all


@pytest.mark.parametrize("S,strong", [(4096, True), (4096, False),
                                      (4111, True), (50, False)])
def test_span_walks_give_every_chunk_boundary(S, strong):
    """The span-stepped walks' states and cotangents at every span
    boundary, the boundaries inside each span rebuilt from them, and ds0
    against the 16-token walk of ``wkv6_chunk_bwd_plain`` at WKV_TOL, over
    4,096 tokens with decays down to e^-20 a token (an overflow, or a
    cancellation in an exponent, would show here before any chip run)."""
    r, k, v, lw, u, s0, dy, ds = map(torch.from_numpy, _wkv_case(
        1, S, 2, 16, seed=11, strong=strong))
    starts, ends, ds0 = _chunk_walks(r, k, v, lw, s0, dy, ds)
    sp_starts, sp_ends, sp_ds0 = _span_walks(r, k, v, lw, s0, dy, ds)
    span = wk.SPAN // wk.CHUNK
    assert len(sp_starts) == -(-S // wk.SPAN)
    for n, (s, d) in enumerate(zip(sp_starts, sp_ends)):
        _close(s, starts[n * span].numpy(), WKV_TOL)
        _close(d, ends[min((n + 1) * span, len(ends)) - 1].numpy(), WKV_TOL)
    _close(sp_ds0, ds0.numpy(), WKV_TOL)
    s_all, d_all = _rebuilt(r, k, v, lw, dy, sp_starts, sp_ends)
    assert len(s_all) == len(starts) == len(d_all)
    for a, b in zip(s_all + d_all, starts + ends):
        _close(a, b.numpy(), WKV_TOL)


# the kernel's four groups of a chunk's pairs (t, j): rows, columns, and
# whether only j < t; each warp pair takes one
_PAIR_GROUPS = ((range(0, 8), range(0, 8), True),
                (range(8, 16), range(8, 16), True),
                (range(8, 12), range(0, 8), False),
                (range(12, 16), range(0, 8), False))


def _group_masks(L=wk.CHUNK):
    """The groups' masks over a chunk's (t, j); they must cover the pairs
    j < t, each once, and each fit the 32 slots of its warp's
    transpose-reduce."""
    masks = []
    for rows, cols, tri in _PAIR_GROUPS:
        m = torch.zeros((L, L), dtype=torch.bool)
        for t in rows:
            for j in cols:
                m[t, j] = j < t or not tri
        masks.append(m)
    count = torch.stack(masks).sum(0)
    assert torch.equal(count, torch.tril(torch.ones(L, L, dtype=torch.long),
                                         diagonal=-1))
    assert max(int(m.sum()) for m in masks) <= 32
    return masks


def _span_pass(r, k, v, lw, u, dy, starts, ends, span=wk.SPAN,
               chunk=wk.CHUNK):
    """``wkv6_bwd_span``'s algebra in plain fp32 PyTorch: chunk boundaries
    rebuilt inside each span, the chunks last to first, the pairs' terms by
    the kernel's groups and joined in its order (dr' rows 8-15: rows 8-11 or
    12-15 against 0-7, then 8-15 among themselves; dk' columns 0-7: rows
    0-7, then 8-11, then 12-15), dlw's sums inside each chunk. Returns dr,
    dk, dv, dlw and du (per batch)."""
    B, S, H, K = k.shape
    f = torch.float32
    masks = [m[None, :, :, None, None] for m in _group_masks()]
    uf = (u if u.dim() == 3 else u[None]).to(f)
    out = [torch.zeros((B, S, H, K), dtype=f) for _ in range(4)]
    du = torch.zeros((B, H, K), dtype=f)
    s_all, d_all = _rebuilt(r, k, v, lw, dy, starts, ends, span, chunk)
    for ci in reversed(range(len(s_all))):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        rc, kc, vc, lwc, dyc = (a[:, sl] for a in (r, k, v, lw, dy))
        s, d = s_all[ci], d_all[ci]
        c = torch.cumsum(lwc, 1)
        ce = c - lwc
        n = kc.shape[1]
        dec = ce[:, :, None] - c[:, None, :]                  # (B, t, j, H, K)
        G = torch.einsum("blhv,bmhv->blmh", dyc, vc)[..., None]
        part = [torch.exp(dec.masked_fill(~m[:, :n, :n], -1e30))
                for m in masks]
        drp = [torch.einsum("bljhk,bljhk,bjhk->blhk", p, G.expand_as(p), kc)
               for p in part]
        dkp = [torch.einsum("bljhk,bljhk,blhk->bjhk", p, G.expand_as(p), rc)
               for p in part]
        A = sum(torch.einsum("blhk,bjhk,bljhk->bljh", rc, kc, p) for p in part)
        drp = drp[0] + (drp[2] + drp[3] + drp[1])
        dkp = dkp[1] + ((dkp[0] + dkp[2]) + dkp[3])
        bonus = (rc * uf[:, None] * kc).sum(-1)
        Gd = torch.diagonal(G[..., 0], dim1=1, dim2=2).movedim(-1, 1)
        etl, ece = torch.exp(c[:, -1:] - c), torch.exp(ce)
        dr_f = ece * torch.einsum("bhkv,blhv->blhk", s, dyc) + drp
        dsv = etl * torch.einsum("bhkv,blhv->blhk", d, vc)
        dk_f = dkp + dsv
        out[0][:, sl] = dr_f + Gd[..., None] * uf[:, None] * kc
        out[1][:, sl] = dk_f + Gd[..., None] * uf[:, None] * rc
        out[2][:, sl] = (torch.einsum("bljh,blhv->bjhv", A, dyc)
                         + bonus[..., None] * dyc
                         + torch.einsum("blhk,bhkv->blhv", kc * etl, d))
        end = (torch.exp(c[:, -1]) * (d * s).sum(-1) + (kc * dsv).sum(1))
        p, q = rc * dr_f, kc * dk_f
        out[3][:, sl] = (p.flip(1).cumsum(1).flip(1) - p
                         - q.flip(1).cumsum(1).flip(1) + end[:, None])
        du += (Gd[..., None] * rc * kc).sum(1)
    return (*out, du if u.dim() == 3 else du.sum(0))


@pytest.mark.parametrize("S,state,final,batch_u,strong", [
    (200, True, True, False, False),    # ragged last span of 8 tokens
    (64, False, True, True, True),      # one span, decays to e^-20
    (37, True, False, False, False),    # shorter than a span
])
def test_span_pass_algebra_matches_the_plain_backward(S, state, final,
                                                      batch_u, strong):
    """The span pass's algebra (``_span_pass``) from the span walks'
    records against ``wkv6_chunk_bwd_plain`` at WKV_TOL: dr, dk, dv, dlw
    and du, with the pairs split as the kernel splits them."""
    r, k, v, lw, u, s0, dy, ds = map(torch.from_numpy, _wkv_case(
        2, S, 3, 16, seed=S, strong=strong, batch_u=batch_u))
    s0 = s0 if state else torch.zeros_like(s0)
    ds = ds if final else torch.zeros_like(ds)
    starts, ends, _ = _span_walks(r, k, v, lw, s0, dy, ds)
    got = _span_pass(r, k, v, lw, u, dy, starts, ends)
    want = wkv6_chunk_bwd_plain(r, k, v, lw, u, s0 if state else None, dy,
                                ds if final else None)
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape, name
        _close(g, w.numpy(), WKV_TOL)


@pytest.mark.parametrize("B,S,H,K,spans", [(1, 4096, 40, 64, 64),
                                           (2, 4111, 3, 32, 65),
                                           (1, 1, 2, 16, 1)])
def test_bwd_scratch_floats_follow_the_span_layout(B, S, H, K, spans):
    """The scratch holds, for each head and span of 64 tokens, the (K, K)
    state at the span's start and its cotangent at the span's end, then
    du's part of the span: 84.5 MB at RWKV-6-3B's training shape (a
    16-token layout took 338 MB)."""
    n = wk.wkv6_chunk_bwd_scratch_floats(B, S, H, K)
    assert n == B * H * spans * (2 * K * K + K)
    if (B, S, H, K) == (1, 4096, 40, 64):
        assert 4 * n == 84_541_440


# ---------------------------------------------------------------------------
# timemix, the model, the step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 24])
def test_timemix_train_output_and_gradients_match_reference(S):
    """Output and the gradient of every parameter and of x, by
    ``jax.vjp`` of the reference's ``timemix`` from no state."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import RWKVSpec as JSpec
    from repro.nn import rwkv6 as jrw
    spec = get_smoke_config("rwkv6-3b").rwkv
    jspec = JSpec(**spec.__dict__)
    d = 64
    sp = jrw.timemix_spec(d, jspec)
    p = {name: _normal(30 + i, *s.shape, scale=0.3)
         for i, (name, s) in enumerate(sorted(sp.items()))}
    p["w_base"] = p["w_base"] - 1.0   # decays well inside (0, 1)
    x = _normal(50, 2, S, d)
    dout = _normal(51, 2, S, d)
    out, vjp = jax.vjp(lambda p, x: jrw.timemix(p, x, jspec)[0],
                       {n: jnp.asarray(a) for n, a in p.items()},
                       jnp.asarray(x))
    jg_p, jg_x = vjp(jnp.asarray(dout))
    tp = {n: torch.from_numpy(a.copy()).requires_grad_()
          for n, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    got, _ = trw.timemix(tp, tx, spec)
    _close(got, np.asarray(out), BLOCK_TOL)
    names = sorted(tp)
    grads = torch.autograd.grad(got, [tp[n] for n in names] + [tx],
                                torch.from_numpy(dout))
    for name, g in zip(names, grads):
        _close(g, np.asarray(jg_p[name]), BLOCK_TOL)
    _close(grads[-1], np.asarray(jg_x), BLOCK_TOL)


def _perturbed(jp):
    """The reference's init leaves u, the mixes and the decay base at
    zero: give them weight."""
    import jax
    keys = ("u", "mu_base", "mu_k", "mu_r", "w_base")
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (x + 0.2 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), x.shape)
            if any(getattr(k, "key", None) in keys for k in path) else x),
        jp)


def _bundles(seed=2, **cfg_kw):
    """The reference's and the port's bundles of rwkv6-3b's smoke config
    (with ``cfg_kw`` replaced) and the reference's fp32 parameters,
    bridged."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import build as j_build
    jb = j_build(j_smoke("rwkv6-3b").replace(**cfg_kw))
    jp = _perturbed(jb.init_params(jax.random.PRNGKey(seed), jnp.float32))
    tb = build(get_smoke_config("rwkv6-3b").replace(**cfg_kw))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jb, jp, tb, tp


def _batch(B, S, seed=5, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _port_grads(tb, tp, batch):
    leaves = [t.clone().requires_grad_() for t in flatten(tp)]
    loss, met = tb.loss_fn(unflatten(tp, leaves),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, met, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_fn_and_every_gradient_leaf_match_reference(remat):
    import jax
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles(remat=remat)
    batch = _batch(2, 48)
    (j_loss, j_met), j_grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads = _port_grads(tb, tp, batch)
    assert set(met) == set(j_met) == {"loss", "ce"}
    for key in met:
        _close(met[key], np.asarray(j_met[key]), MODEL_TOL)
    _close(loss, np.asarray(j_loss), MODEL_TOL)
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for got, want in zip(grads, j_leaves):
        assert tuple(got.shape) == want.shape
        _close(got, np.asarray(want), MODEL_TOL)


def test_bf16_loss_and_every_gradient_leaf_match_reference():
    """The smoke model in bf16 (the reference's fp32 init rounded on both
    sides): the loss at BF16_LOSS_TOL and every gradient leaf at
    BF16_TOL."""
    import jax
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles(seed=3)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = unflatten(tp, [t.bfloat16() for t in flatten(tp)])
    batch = _batch(2, 48)
    (j_loss, _), j_grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = _port_grads(tb, tp, batch)
    assert loss.dtype == torch.float32
    _close(loss, np.asarray(j_loss), BF16_LOSS_TOL)
    for got, want in zip(grads, jax.tree.leaves(j_grads)):
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)


def test_remat_full_and_none_give_bitwise_equal_gradients(monkeypatch):
    """Per-layer remat recomputes each layer in the backward: the same ops
    on the same inputs, so on the CPU the same bits; the recompute runs
    each layer's WKV6 forward again."""
    batch = _batch(2, 40, seed=6)
    calls = []
    forward = WKV6Chunk.forward

    def counting(ctx, *a):
        calls.append(1)
        return forward(ctx, *a)
    monkeypatch.setattr(WKV6Chunk, "forward", staticmethod(counting))
    runs = []
    for remat in ("full", "none"):
        tb = build(get_smoke_config("rwkv6-3b").replace(remat=remat))
        tp = tb.init_params(3, torch.float32, "cpu")
        calls.clear()
        loss, _, grads = _port_grads(tb, tp, batch)
        runs.append((loss, grads, len(calls)))
    (l_full, g_full, n_full), (l_none, g_none, n_none) = runs
    assert torch.equal(l_full, l_none)
    assert all(torch.equal(a, b) for a, b in zip(g_full, g_none))
    assert (n_full, n_none) == (4, 2)   # 2 layers, recomputed under remat


@pytest.mark.parametrize("accum,B,n_micro", [(1, 4, 1), (2, 4, 2)])
def test_train_steps_match_reference(accum, B, n_micro):
    """Three ``make_train_step`` steps against the reference's jitted step,
    AdamW on a cosine schedule, grad_accum 1 and 2: parameters, m, v, the
    step and the metrics (their keys too)."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as j_make
    from repro.optim.adam import AdamW as JAdamW
    from repro.optim.schedules import get_schedule as j_schedule
    jb, jp, tb, tp = _bundles(seed=1, grad_accum=accum)
    batches = [_batch(B, 32, seed=10 + i) for i in range(3)]
    j_opt = JAdamW(j_schedule("cosine", 1e-3, 2, 10))
    j_state = j_opt.init(jp)
    j_step = jax.jit(j_make(jb, j_opt))
    opt = AdamW(get_schedule("cosine", 1e-3, 2, 10))
    state = opt.init(flatten(tp))
    step = make_train_step(tb, opt)
    keys = ({"loss", "ce"} if n_micro == 1 else {"loss"}) | {"lr",
                                                            "grad_norm"}
    for b in batches:
        jp, j_state, j_met = j_step(
            jp, j_state, {k: jnp.asarray(v) for k, v in b.items()})
        tp, state, met = step(
            tp, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(met) == set(j_met) == keys
        for key in keys:
            _close(met[key], np.asarray(j_met[key]), MODEL_TOL)
    assert state["step"] == int(j_state["step"]) == 3
    for got, want in zip(flatten(tp), jax.tree.leaves(jp)):
        _close(got, np.asarray(want), MODEL_TOL)
    for name in ("m", "v"):
        for got, want in zip(state[name], jax.tree.leaves(j_state[name])):
            _close(got, np.asarray(want), MODEL_TOL)


def test_launcher_trains_rwkv_and_its_loss_falls():
    """Each step draws new uniform tokens, so one step's loss moves by
    ~0.1 about the trend: the last five steps' mean must fall below the
    first five's."""
    from repro_torch.launch import train
    res = train.main(["--arch", "rwkv6-3b", "--device", "cpu", "--batch",
                      "4", "--seq", "64", "--lr", "1e-2", "--steps", "20"])
    losses = res["losses"]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


# ---------------------------------------------------------------------------
# the backward's wrapper: what it refuses before a launch
# ---------------------------------------------------------------------------

class _Launched(Exception):
    pass


@pytest.fixture
def as_if_on_card(monkeypatch):
    """Sends CPU tensors down the wrapper's card path up to the launch,
    where binding the library raises ``_Launched``: what the wrapper
    refuses is refused before any launch, and nothing falls back to the
    plain version."""
    def launch(*_):
        raise _Launched()
    monkeypatch.setattr(wk, "on_card", lambda what, t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kbuild, "bind", launch)


def _operands(dtype=torch.float32, K=16, **change):
    """r, k, v, lw, u, state, dy, ds_out on the CPU, (1, 20, 2, K), with
    ``change`` ({name: tensor or a function of the tensor}) applied."""
    r, k, v, lw, u, s0, dy, ds = map(torch.from_numpy, _wkv_case(
        1, 20, 2, K, seed=1))
    ops = dict(r=r.to(dtype), k=k.to(dtype), v=v.to(dtype), lw=lw,
               u=u.to(dtype), state=s0, dy=dy.to(dtype), ds_out=ds)
    for name, f in change.items():
        ops[name] = f(ops[name]) if callable(f) else f
    return ops


def _offset(t):
    """``t``'s values in a view that starts one element past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    flat[1:] = t.flatten()
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("change,error,what", [
    (dict(dy=lambda t: t[:, :-1]), ValueError, "dy has shape"),
    (dict(ds_out=lambda t: t[:, :1]), ValueError, "ds_out has shape"),
    (dict(u=lambda t: t[:1]), ValueError, "u has shape"),
    (dict(K=8), ValueError, "K = V in"),
    (dict(dtype=torch.float16), TypeError, "takes r, k, v"),
    (dict(lw=lambda t: t.bfloat16()), TypeError, "lw must be"),
    (dict(dy=lambda t: t.bfloat16()), TypeError, "dy must be"),
    (dict(ds_out=lambda t: t.bfloat16()), TypeError, "ds_out must be"),
    (dict(dy=lambda t: t.transpose(2, 3).contiguous().transpose(2, 3)),
     ValueError, "contiguous"),
    (dict(dy=_offset), ValueError, "16-byte"),
    (dict(lw=_offset), ValueError, "16-byte"),
])
def test_bwd_refuses_what_the_kernel_does_not_take(as_if_on_card, change,
                                                   error, what):
    before = kbuild.launch_counts["wkv6_chunk_bwd"]
    with pytest.raises(error, match=what):
        wkv6_chunk_bwd(**_operands(**change))
    assert kbuild.launch_counts["wkv6_chunk_bwd"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("given", ["both", "neither"])
def test_bwd_takes_to_the_launch_what_it_reads(as_if_on_card, dtype, given):
    drop = {} if given == "both" else dict(state=None, ds_out=None)
    with pytest.raises(_Launched):
        wkv6_chunk_bwd(**_operands(dtype, **drop))


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version, one step
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bwd_on_card(B, S, H, K, dtype, state, final, batch_u, seed=0,
                 strong=False):
    r, k, v, lw, u, s0, dy, ds = (torch.from_numpy(a).cuda() for a in
                                  _wkv_case(B, S, H, K, seed=seed,
                                            batch_u=batch_u, strong=strong))
    r, k, v, u, dy = (t.to(dtype) for t in (r, k, v, u, dy))
    return (r, k, v, lw, u, s0 if state else None, dy,
            ds if final else None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,state,final,batch_u", [
    (2, 64, 3, 64, False, False, False),
    (1, 37, 2, 32, True, True, False),    # ragged, both states
    (3, 17, 2, 16, False, True, True),    # one token past a chunk
    (1, 1007, 4, 64, True, True, False),  # many chunks, ragged
    (1, 1, 2, 64, True, True, False),     # one token
    (1, 15, 2, 64, True, True, False),    # shorter than a chunk and a span
    (1, 65, 2, 64, True, True, False),    # one token past a span
    (1, 4111, 2, 64, True, True, False),  # many spans, ragged
    (1, 300, 3, 16, True, True, False),   # K 16 over several spans
    (1, 300, 3, 32, True, True, False),   # K 32 over several spans
    (2, 200, 3, 64, True, True, True),    # B 2, a per-batch u
])
def test_wkv6_bwd_kernel_matches_plain_on_card(B, S, H, K, state, final,
                                               batch_u, dtype):
    _card()
    _check_bwd_on_card(_bwd_on_card(B, S, H, K, getattr(torch, dtype), state,
                                    final, batch_u))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_bwd_kernel_holds_strong_decays_on_card(dtype):
    """Decays down to e^-20 a token over 4,096 tokens (64 spans), both
    states: an exponent that overflowed or cancelled would show here."""
    _card()
    _check_bwd_on_card(_bwd_on_card(1, 4096, 4, 64, getattr(torch, dtype),
                                    True, True, False, seed=2, strong=True))


def _check_bwd_on_card(args):
    """One launch (one count) against the plain version at the kernel's
    tolerances."""
    dt = args[0].dtype
    before = kbuild.launch_counts["wkv6_chunk_bwd"]
    got = wkv6_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert kbuild.launch_counts["wkv6_chunk_bwd"] == before + 1
    want = wkv6_chunk_bwd_plain(*args)
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        rtol = 1e-2 if name in ("dr", "dk", "dv") and dt != torch.float32 \
            else WKV_TOL["rtol"]
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=WKV_TOL["atol"] * scale)


@pytest.mark.gpu
def test_wkv6_bwd_two_launches_give_the_same_bits_on_card():
    _card()
    args = _bwd_on_card(2, 300, 40, 64, torch.bfloat16, True, True, False,
                        seed=4)
    a = wkv6_chunk_bwd(*args)
    b = wkv6_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_rwkv_train_step_on_card_matches_the_cpu():
    """One smoke-config train step (grad_accum 2, remat) on the card in
    fp32 against the same step on the CPU: 8 wkv6_chunk launches (2 layers
    x 2 micro-batches x the forward and remat's recompute) and 4
    wkv6_chunk_bwd, nothing else; the metrics and every parameter within
    MODEL_TOL."""
    _card()
    cfg = get_smoke_config("rwkv6-3b").replace(grad_accum=2)
    tb = build(cfg)
    batch = sample_inputs(cfg, ShapeSpec("t", 64, 2, "train"),
                          np.random.default_rng(0), "cpu")
    p0 = params_to_numpy(tb.init_params(0, torch.float32, "cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        tp = params_from_numpy(p0, dev)
        opt = AdamW(get_schedule("cosine", 1e-3, 2, 10))
        kbuild.reset_launch_counts()
        out[dev] = make_train_step(tb, opt)(
            tp, opt.init(flatten(tp)),
            {k: v.to(dev) for k, v in batch.items()})
        torch.cuda.synchronize()
        if dev == "cuda":
            assert {n: c for n, c in kbuild.launch_counts.items() if c} == {
                "wkv6_chunk": 8, "wkv6_chunk_bwd": 4}
    (p_cpu, _, m_cpu), (p_card, _, m_card) = out["cpu"], out["cuda"]
    for key in m_cpu:
        _close(m_card[key], m_cpu[key].numpy(), MODEL_TOL)
    for a, b in zip(flatten(p_card), flatten(p_cpu)):
        _close(a, b.numpy(), MODEL_TOL)

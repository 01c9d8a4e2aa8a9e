"""The port's dense LM training step against ``repro``: the flash forward's
log-sum-exp and the plain flash backward against the reference's
``_flash_fwd_scan`` and ``jax.vjp`` of its ``flash_attention``; the
``FlashAttention`` autograd op, ``attend(mode="train")`` and
``cross_entropy``; ``lm.loss_fn`` with its gradients (remat on and off);
three ``make_train_step`` steps with and without gradient accumulation;
and the launcher (``launch.train``): its loss falls, a resumed run is
bitwise the uninterrupted one, and the reference restores its checkpoint;
and what the backward's wrapper refuses on the bf16 (wgmma) route before
any launch (CPU tensors sent down its card path to a stubbed launch).
Inputs come from numpy seeds, the reference's parameters are carried
across by ``nn.param.params_from_numpy``, and JAX is imported only inside
the tests (the card has none).

Tolerances, each atol times the largest magnitude of the reference's
result (at least 1), as ``tests/test_torch_lm.py``'s ``_close``:
* BLOCK_TOL, rtol 1e-4 / atol 1e-5: the lse, the layers and their
  gradients in fp32 (products over at most 64 terms and 36 keys, taken in
  another order: the reference scans chunks of keys, the plain version
  takes the softmax in one pass);
* MODEL_TOL, rtol 1e-4 / atol 1e-4: the loss and every gradient leaf of
  the two-layer model, and the parameters, moments and metrics after three
  AdamW steps (two layers of those sums, then AdamW's m / sqrt(v), which
  divides a gradient's error by its own size);
* BF16_TOL, rtol 2e-2 / atol 2e-2: the flash backward on bf16 operands
  (both round p and ds to bf16 where the reference does, but a last-bit
  difference in the fp32 value before a rounding moves it by one bf16 ulp,
  2^-7 relative; the reference also sums the G heads' rounded dk and dv in
  bf16 where the port sums in fp32 and rounds once); also the gradients
  of a bf16 model (measured worst 1.0e-2 of the leaf's scale);
* BF16_LOSS_TOL, rtol 1e-3 / atol 1e-3: the loss of the bf16 smoke model
  (bf16 activations rounded in other places; measured worst 1.7e-3 of a
  loss of 6.04 over three seeds).
bf16 logits are held at BLOCK_TOL: the product keeps fp32 sums and an
fp32 result, as the reference's (a bf16 result would be off by 1.3e-2).
The ``gpu`` tests hold the CUDA kernels against their plain versions on
the card (skipped here): fp32 at FLASH_TOL (atol 2e-4 / rtol 1e-4, the
forward's), bf16 at BF16_TOL; two launches give the same bits. A bf16
backward must also round where the plain version does: its relative
Frobenius error against the plain version stays under ROUNDING_LIMIT, 2^-11,
and against the plain version with p's or ds's rounding removed exceeds it
(a CPU simulation of a kernel with other fp32 sums reads 3e-5 to 1.2e-4
against 2.5e-3).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import (
    FlashAttention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_bwd_products, flash_attention_bwd_terms,
    flash_attention_fwd, flash_attention_plain)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.registry import build, sample_inputs
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tL
from repro_torch.nn.param import (flatten, params_from_numpy,
                                  params_to_numpy, unflatten)
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedules import get_schedule

BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
ROUNDING_LIMIT = 2.0 ** -11
FLASH_TOL = dict(rtol=1e-4, atol=2e-4)


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


def _qkv_do(seed, B, S, H, KH, D, Sk=None):
    Sk = S if Sk is None else Sk
    return (_normal(seed, B, S, H, D), _normal(seed + 1, B, Sk, KH, D),
            _normal(seed + 2, B, Sk, KH, D), _normal(seed + 3, B, S, H, D))


def _t(dtype, *xs):
    return [torch.from_numpy(x).to(dtype) for x in xs]


# ---------------------------------------------------------------------------
# flash: the plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_lse_matches_reference_scan(G, causal):
    """The plain forward's lse (from materialised scores) against the
    reference's online scan (chunks of 6 queries and 12 keys over S =
    36), (B, H, Sq) against its (B, nq, qc, H)."""
    import jax.numpy as jnp
    from repro.nn.attention import _flash_fwd_scan
    B, S, H, D = 2, 36, 4, 16
    q, k, v, _ = _qkv_do(0, B, S, H, H // G, D)
    out, lse = flash_attention_plain(*_t(torch.float32, q, k, v), causal,
                                     return_lse=True)
    j_out, j_lse = _flash_fwd_scan(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=2),
        jnp.repeat(jnp.asarray(v), G, axis=2), causal, 6, 12)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    _close(lse, np.asarray(j_lse).reshape(B, S, H).transpose(0, 2, 1),
           BLOCK_TOL)
    _close(out, np.asarray(j_out).reshape(B, S, H, D), BLOCK_TOL)
    # the output does not change when the lse is asked for
    assert torch.equal(out, flash_attention_plain(
        *_t(torch.float32, q, k, v), causal))


def _reference_vjp(q, k, v, do, G, causal, dtype):
    """The reference's out and (dq, dk, dv) of ``flash_attention`` over
    jnp.repeat-ed k and v, in chunks of 8 queries and 16 keys (ragged S
    picks the largest divisor below each)."""
    import jax
    import jax.numpy as jnp
    from repro.nn.attention import flash_attention as j_flash
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def f(q, k, v):
        return j_flash(q, jnp.repeat(k, G, axis=2), jnp.repeat(v, G, axis=2),
                       causal=causal, q_chunk=8, k_chunk=16)
    out, vjp = jax.vjp(f, *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do).astype(jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", [36, 29])
def test_plain_bwd_matches_reference_vjp(S, G, causal, dtype):
    """``flash_attention_bwd_plain`` (at the plain forward's output and
    lse) against ``jax.vjp`` of the reference's ``flash_attention``:
    several chunks of queries and keys (S 36: chunks of 6 and 12; S 29, a
    prime: chunks of 1), fp32 at BLOCK_TOL, bf16 at BF16_TOL."""
    dt = getattr(torch, dtype)
    B, H, D = 2, 4, 16
    q, k, v, do = _qkv_do(1, B, S, H, H // G, D)
    tq, tk, tv, tdo = _t(dt, q, k, v, do)
    out, lse = flash_attention_plain(tq, tk, tv, causal, return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal)
    want = _reference_vjp(q, k, v, do, G, causal, dt)
    tol = BLOCK_TOL if dt == torch.float32 else BF16_TOL
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out, *got), want):
        assert g.dtype == dt and tuple(g.shape) == w.shape, name
        _close(g, w, tol)


def test_flash_autograd_matches_autograd_through_plain():
    """``FlashAttention``'s gradients (the plain backward on the CPU)
    against autograd through ``flash_attention_plain`` itself, GQA and a
    ragged S, causal."""
    B, S, H, KH, D = 2, 23, 4, 2, 16
    q, k, v, do = _t(torch.float32, *_qkv_do(2, B, S, H, KH, D))
    grads = []
    for fn in (lambda a, b, c: FlashAttention.apply(a, b, c, True),
               lambda a, b, c: flash_attention_plain(a, b, c, True)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        grads.append([out] + list(torch.autograd.grad(out, leaves, do)))
    for got, want in zip(*grads):
        _close(got, want.detach().numpy(), BLOCK_TOL)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _attn_params(d=64, H=4, KH=2, hd=16, seed=20):
    return {"wq": _normal(seed, d, H, hd, scale=d ** -0.5),
            "wk": _normal(seed + 1, d, KH, hd, scale=d ** -0.5),
            "wv": _normal(seed + 2, d, KH, hd, scale=d ** -0.5),
            "wo": _normal(seed + 3, H, hd, d, scale=(H * hd) ** -0.5)}


def test_attend_train_output_and_gradients_match_reference():
    """``attend(mode="train")``: the output and the gradients of x and of
    wq, wk, wv and wo for a seeded output gradient, against the
    reference's train mode (rope at arange(S), causal flash)."""
    import jax
    import jax.numpy as jnp
    from repro.nn.attention import attend as j_attend
    B, S, d = 2, 20, 64
    p = _attn_params()
    x, g = _normal(30, B, S, d), _normal(31, B, S, d)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=10_000.0)

    def j_fn(p, x):
        out, cache = j_attend(p, x, positions=jnp.arange(S)[None, :],
                              mode="train", **kw)
        return jnp.sum(out * jnp.asarray(g)), (out, cache)
    (_, (j_out, j_cache)), (j_gp, j_gx) = jax.value_and_grad(
        j_fn, argnums=(0, 1), has_aux=True)(
        {k_: jnp.asarray(v_) for k_, v_ in p.items()}, jnp.asarray(x))
    tp = {k_: torch.from_numpy(v_).requires_grad_() for k_, v_ in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = tattn.attend(tp, tx, positions=torch.arange(S)[None, :],
                              mode="train", **kw)
    assert cache is None and j_cache is None
    gx, *gp = torch.autograd.grad(out, [tx, *tp.values()],
                                  torch.from_numpy(g))
    _close(out, np.asarray(j_out), BLOCK_TOL)
    _close(gx, np.asarray(j_gx), BLOCK_TOL)
    for name, got in zip(tp, gp):
        _close(got, np.asarray(j_gp[name]), BLOCK_TOL)


@pytest.mark.parametrize("real_vocab", [50, 47])
def test_cross_entropy_through_logits_matches_reference(real_vocab):
    """``logits_fn`` then ``cross_entropy``: the loss and the gradients of
    x and the table, with the padded vocab's -1e30 added in place (a padded
    column must get no gradient)."""
    import jax
    import jax.numpy as jnp
    from repro.nn import layers as jL
    B, S, d, vp = 2, 7, 16, 50
    table, x = _normal(40, vp, d, scale=0.3), _normal(41, B, S, d)
    labels = np.random.default_rng(42).integers(0, real_vocab, (B, S))

    def j_loss(table, x):
        logits = jL.logits_fn({"table": table}, x, real_vocab)
        return jL.cross_entropy(logits, jnp.asarray(labels, jnp.int32))
    j_val, (j_gt, j_gx) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x))
    tt = torch.from_numpy(table).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    loss = tL.cross_entropy(tL.logits_fn({"table": tt}, tx, real_vocab),
                            torch.from_numpy(labels.astype(np.int32)))
    gt, gx = torch.autograd.grad(loss, [tt, tx])
    _close(loss, np.asarray(j_val), BLOCK_TOL)
    _close(gt, np.asarray(j_gt), BLOCK_TOL)
    _close(gx, np.asarray(j_gx), BLOCK_TOL)
    assert not gt[real_vocab:].any()


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("real_vocab", [50, 47])
def test_bf16_logits_keep_fp32_like_the_reference(real_vocab, tied):
    """bf16 x and table: the logits are the reference's fp32 ones (fp32
    sums, no bf16 rounding of the result), and the cross-entropy's
    gradients of x and the table match its bf16 ones."""
    import jax
    import jax.numpy as jnp
    from repro.nn import layers as jL
    B, S, d, vp = 2, 7, 16, 50
    table, x = _normal(43, vp, d, scale=0.3), _normal(44, B, S, d)
    if not tied:
        table = np.ascontiguousarray(table.T)
    key = "table" if tied else "unembed"
    labels = np.random.default_rng(45).integers(0, real_vocab, (B, S))

    def j_loss(table, x):
        logits = jL.logits_fn({key: table}, x, real_vocab)
        return jL.cross_entropy(logits, jnp.asarray(labels, jnp.int32)), \
            logits
    (j_val, j_logits), (j_gt, j_gx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    tt, tx = (torch.from_numpy(a).bfloat16().requires_grad_()
              for a in (table, x))
    logits = tL.logits_fn({key: tt}, tx, real_vocab)
    loss = tL.cross_entropy(logits, torch.from_numpy(labels.astype(np.int32)))
    gt, gx = torch.autograd.grad(loss, [tt, tx])
    assert logits.dtype == torch.float32
    assert gt.dtype == gx.dtype == torch.bfloat16
    j_logits = np.asarray(j_logits)
    _close(logits[..., :real_vocab], j_logits[..., :real_vocab], BLOCK_TOL)
    _close(loss, np.asarray(j_val), BLOCK_TOL)
    _close(gt, np.asarray(j_gt.astype(jnp.float32)), BF16_TOL)
    _close(gx, np.asarray(j_gx.astype(jnp.float32)), BF16_TOL)


# ---------------------------------------------------------------------------
# the model and the step
# ---------------------------------------------------------------------------

def _bundles(seed=0, arch="llama3-8b", **cfg_kw):
    """The reference's and the port's bundles of ``arch``'s smoke config
    (with ``cfg_kw`` replaced) and the reference's fp32 parameters, bridged."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import build as j_build
    jb = j_build(j_smoke(arch).replace(**cfg_kw))
    jp = jb.init_params(jax.random.PRNGKey(seed), jnp.float32)
    tb = build(get_smoke_config(arch).replace(**cfg_kw))
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
    batch = _batch(2, 32)
    (j_loss, j_met), j_grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads = _port_grads(tb, tp, batch)
    assert set(met) == set(j_met) == {"loss", "ce", "aux"}
    for key in met:
        _close(met[key], np.asarray(j_met[key]), MODEL_TOL)
    _close(loss, np.asarray(j_loss), MODEL_TOL)
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for got, want in zip(grads, j_leaves):
        assert tuple(got.shape) == want.shape
        _close(got, np.asarray(want), MODEL_TOL)


@pytest.mark.parametrize("arch", ["minicpm-2b", "starcoder2-7b", "yi-9b"])
def test_dense_configs_loss_and_every_gradient_leaf_match_reference(arch):
    """The other dense configs at their smoke widths, fp32, remat "full":
    tied embeddings (MiniCPM-2B), the gelu MLP and layernorm
    (StarCoder2-7B), GQA (Yi-9B)."""
    import jax
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles(arch=arch)
    batch = _batch(2, 32)
    (j_loss, j_met), j_grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads = _port_grads(tb, tp, batch)
    _close(loss, np.asarray(j_loss), MODEL_TOL)
    _close(met["ce"], np.asarray(j_met["ce"]), MODEL_TOL)
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
    jb, jp, tb, tp = _bundles()
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = unflatten(tp, [t.bfloat16() for t in flatten(tp)])
    batch = _batch(2, 32)
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
    each layer's flash forward again."""
    batch = _batch(2, 24, seed=6)
    calls = []
    forward = FlashAttention.forward

    def counting(ctx, *a):
        calls.append(1)
        return forward(ctx, *a)
    monkeypatch.setattr(FlashAttention, "forward", staticmethod(counting))
    runs = []
    for remat in ("full", "none"):
        tb = build(get_smoke_config("llama3-8b").replace(remat=remat))
        tp = tb.init_params(3, torch.float32, "cpu")
        calls.clear()
        loss, _, grads = _port_grads(tb, tp, batch)
        runs.append((loss, grads, len(calls)))
    (l_full, g_full, n_full), (l_none, g_none, n_none) = runs
    assert torch.equal(l_full, l_none)
    assert all(torch.equal(a, b) for a, b in zip(g_full, g_none))
    assert (n_full, n_none) == (4, 2)   # 2 layers, recomputed under remat


def _train_steps(jb, jp, tb, tp, batches, steps):
    """Three steps of the reference's jitted step and of the port's, from
    the same parameters, with AdamW on a cosine schedule."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as j_make
    from repro.optim.adam import AdamW as JAdamW
    from repro.optim.schedules import get_schedule as j_schedule
    j_opt = JAdamW(j_schedule("cosine", 1e-3, 2, 10))
    j_state = j_opt.init(jp)
    j_step = jax.jit(j_make(jb, j_opt))
    opt = AdamW(get_schedule("cosine", 1e-3, 2, 10))
    state = opt.init(flatten(tp))
    step = make_train_step(tb, opt)
    out = []
    for i in range(steps):
        jp, j_state, j_met = j_step(
            jp, j_state, {k: jnp.asarray(v) for k, v in batches[i].items()})
        tp, state, met = step(
            tp, state, {k: torch.from_numpy(v) for k, v in batches[i].items()})
        out.append((j_met, met))
    return jp, j_state, tp, state, out


@pytest.mark.parametrize("accum,B,n_micro", [(1, 4, 1), (2, 4, 2),
                                             (4, 6, 3)])
def test_train_steps_match_reference(accum, B, n_micro):
    """Three ``make_train_step`` steps against the reference's: grad_accum
    1, 2, and 4 on a batch of 6, which lowers it to 3 micro-batches.
    Parameters, m, v, the step and the metrics (their keys too)."""
    import jax
    jb, jp, tb, tp = _bundles(seed=1, grad_accum=accum)
    batches = [_batch(B, 16, seed=10 + i) for i in range(3)]
    jp, j_state, tp, state, mets = _train_steps(jb, jp, tb, tp, batches, 3)
    keys = ({"loss", "ce", "aux"} if n_micro == 1 else {"loss"}) | {
        "lr", "grad_norm"}
    for j_met, met in mets:
        assert set(met) == set(j_met) == keys
        for key in keys:
            _close(met[key], np.asarray(j_met[key]), MODEL_TOL)
    assert state["step"] == int(j_state["step"]) == 3
    for got, want in zip(flatten(tp), jax.tree.leaves(jp)):
        _close(got, np.asarray(want), MODEL_TOL)
    for name in ("m", "v"):
        for got, want in zip(state[name], jax.tree.leaves(j_state[name])):
            _close(got, np.asarray(want), MODEL_TOL)


def test_accumulation_in_bf16_when_adam_dtype_is_bf16():
    """``adam_dtype="bfloat16"`` accumulates the micro-batches' gradients
    in bf16, as the reference does; fp32 otherwise."""
    seen = []

    class Probe(AdamW):
        def update(self, grads, state, params):
            seen.append({g.dtype for g in grads})
            return super().update(grads, state, params)
    for adam_dtype, want in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
        tb = build(get_smoke_config("llama3-8b").replace(
            grad_accum=2, adam_dtype=adam_dtype))
        tp = tb.init_params(0, torch.float32, "cpu")
        opt = Probe(get_schedule("cosine", 1e-3, 2, 10))
        make_train_step(tb, opt)(tp, opt.init(flatten(tp)), {
            k: torch.from_numpy(v) for k, v in _batch(2, 8).items()})
        assert seen[-1] == {want}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_LAUNCH = ["--device", "cpu", "--batch", "2", "--seq", "32", "--lr", "3e-3"]


def test_launcher_trains_and_its_loss_falls():
    from repro_torch.launch import train
    res = train.main(_LAUNCH + ["--steps", "12"])
    losses = res["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.05
    with pytest.raises(NotImplementedError, match="XLA"):
        train.main(["--dry", "--device", "cpu"])


def test_launcher_resumes_bitwise_the_uninterrupted_run(tmp_path):
    """A run saving every 2 steps loses its step-4 checkpoint; the run
    resumed from step 2 ends with the uninterrupted run's parameters,
    moments and step, bit for bit."""
    import os
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    args = _LAUNCH + ["--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2"]
    full = train.main(args)
    for ext in (".npz", ".json"):
        os.remove(os.path.join(ck, f"ckpt_00000004{ext}"))
    resumed = train.main(args + ["--resume"])
    assert resumed["start"] == 2 and len(resumed["losses"]) == 2
    assert resumed["losses"] == full["losses"][2:]
    for a, b in zip(flatten(full["params"]), flatten(resumed["params"])):
        assert torch.equal(a, b)
    for name in ("m", "v"):
        for a, b in zip(full["opt_state"][name], resumed["opt_state"][name]):
            assert torch.equal(a, b)
    assert full["opt_state"]["step"] == resumed["opt_state"]["step"] == 4


def test_reference_restores_the_launchers_checkpoint(tmp_path):
    """The reference's ``Checkpointer.restore`` reads the port's LM
    checkpoint into its own parameter and AdamW trees: every array equal,
    the step an int32 of 3."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.checkpointing import Checkpointer as JCkpt
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import build as j_build
    from repro.optim.adam import AdamW as JAdamW
    from repro.optim.schedules import get_schedule as j_schedule
    from repro_torch.launch import train
    ck = str(tmp_path / "ck")
    res = train.main(_LAUNCH + ["--steps", "3", "--ckpt-dir", ck,
                                "--ckpt-every", "3"])
    jb = j_build(j_smoke("llama3-8b"))
    like = jb.init_params(jax.random.PRNGKey(7), jnp.float32)
    like_opt = JAdamW(j_schedule("cosine", 1e-3, 2, 10)).init(like)
    got = JCkpt(ck).restore(3, like, like_opt)
    assert got["step"] == 3
    for a, b in zip(jax.tree.leaves(got["params"]), flatten(res["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(got["opt"][name]),
                        res["opt_state"][name]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert got["opt"]["step"].dtype == jnp.int32
    assert int(got["opt"]["step"]) == 3


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b"])
def test_launcher_defaults_to_the_card_and_names_the_cpu_option(arch):
    """Without a card the launcher's default device raises, naming
    ``device='cpu'``."""
    if not torch.cuda.is_available():  # the launcher's default is the card
        from repro_torch.launch import train
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", arch, "--steps", "1"])


def test_train_mode_raises_for_the_vlm_prefix():
    """Train mode takes the VLM prefix since A.14.3 (its positions
    unsupervised: the loss equals the text tokens' cross-entropy of the
    model run on the whole sequence) and raises only for a prefix that
    does not fit the batch and width."""
    tb = build(get_smoke_config("llama3-8b"))
    p = tb.init_params(0, torch.float32, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    prefix = torch.ones(1, 2, 64)
    loss, met = tb.loss_fn(p, {"tokens": toks, "labels": toks,
                               "patch_embeds": prefix})
    x, _, _ = lm.forward(p, tb.cfg, toks, embeds_prefix=prefix,
                         mode="train")
    ce = tL.cross_entropy(tL.logits_fn(p["embed"], x[:, 2:], 256), toks)
    assert torch.equal(met["ce"], ce)
    for bad in (torch.zeros(2, 2, 64), torch.zeros(1, 2, 48)):
        with pytest.raises(ValueError, match="embeds_prefix"):
            tb.loss_fn(p, {"tokens": toks, "labels": toks,
                           "patch_embeds": bad})


# ---------------------------------------------------------------------------
# the backward's wrapper: what the bf16 (wgmma) route refuses before a launch
# ---------------------------------------------------------------------------

class _Launched(Exception):
    pass


@pytest.fixture
def as_if_on_card(monkeypatch):
    """Sends CPU tensors down the wrapper's card path up to the launch,
    where binding the library raises ``_Launched``: what the wrapper
    refuses is refused before any launch."""
    from repro_torch.kernels import flash_attention as fa

    def launch(*_):
        raise _Launched()
    monkeypatch.setattr(fa, "on_card", lambda what, t: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(kbuild, "bind", launch)
    return fa


def _bwd_operands(dtype, D=64, o_row=None, do_offset=0):
    """q, k, v, o, lse, do on the CPU, (1, 8, 2, D) with 1 kv head; ``o``
    cut from rows of ``o_row`` elements (the last dim contiguous, a head
    stride of o_row), ``do`` starting ``do_offset`` elements into its
    storage."""
    q, k, v, do = _t(dtype, *_qkv_do(3, 1, 8, 2, 1, D))
    o = q.clone()
    if o_row is not None:
        o = torch.zeros((1, 8, 2, o_row), dtype=dtype)[..., :D]
    if do_offset:
        flat = torch.zeros(do.numel() + do_offset, dtype=dtype)
        do = flat[do_offset:].view(do.shape)
    return q, k, v, o, torch.zeros((1, 2, 8)), do


@pytest.mark.parametrize("case,what", [
    (dict(o_row=68), "stride"),        # o's head stride 136 bytes
    (dict(do_offset=1), "boundary"),   # do's base 2 bytes into a granule
    (dict(D=12), "head dim"),          # D not a multiple of 8
])
def test_bwd_bf16_refuses_what_tma_cannot_read(as_if_on_card, case, what):
    fa = as_if_on_card
    before = kbuild.launch_counts["flash_attention_bwd"]
    with pytest.raises(ValueError, match=what):
        fa.flash_attention_bwd(*_bwd_operands(torch.bfloat16, **case))
    assert kbuild.launch_counts["flash_attention_bwd"] == before


@pytest.mark.parametrize("dtype,case", [
    (torch.bfloat16, {}),                  # aligned: on to the launch
    (torch.float32, dict(o_row=68)),       # the FMA route takes any strides
    (torch.float32, dict(D=12)),
])
def test_bwd_takes_to_the_launch_what_its_route_reads(as_if_on_card, dtype,
                                                      case):
    with pytest.raises(_Launched):
        as_if_on_card.flash_attention_bwd(*_bwd_operands(dtype, **case))


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions, one step
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,B,S,Sk,H,KH,D", [
    (True, 2, 256, 256, 4, 4, 128),   # G 1, whole tiles
    (True, 1, 200, 200, 4, 2, 64),    # G 2, ragged S, D 64
    (True, 2, 130, 130, 8, 2, 128),   # G 4, ragged S
    (False, 1, 100, 100, 4, 1, 128),  # G 4, non-causal, ragged
    (False, 2, 192, 192, 2, 2, 40),   # G 1, non-causal, D below a tile
    (True, 1, 65, 65, 2, 1, 16),      # one row past a tile, D 16
    (False, 2, 100, 237, 4, 2, 128),  # Sq < Sk, non-causal (cross-attention)
    (False, 1, 300, 90, 2, 1, 64),    # Sq > Sk, non-causal
    (True, 1, 1100, 1100, 8, 2, 128),  # G 4, many k and q tiles, ragged
    (True, 2, 256, 256, 4, 4, 80),    # Zamba2's head dim 80, G 1
    (True, 1, 200, 200, 4, 2, 80),    # head dim 80, G 2, ragged S
    (False, 1, 1500, 1500, 12, 12, 64),  # Whisper's encoder, ragged
    (False, 1, 4096, 1500, 12, 12, 64),  # Whisper's cross-attention
])
def test_flash_bwd_kernel_matches_plain_on_card(causal, B, S, Sk, H, KH, D,
                                                dtype):
    _card()
    dt = getattr(torch, dtype)
    q, k, v, do = (t.cuda() for t in _t(dt, *_qkv_do(7, B, S, H, KH, D,
                                                     Sk)))
    o, lse = flash_attention_fwd(q, k, v, causal, return_lse=True)
    before = kbuild.launch_counts["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert kbuild.launch_counts["flash_attention_bwd"] == before + 2
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    tol = FLASH_TOL if dt == torch.float32 else BF16_TOL
    for g, a, w in zip(got, again, want):
        assert g.dtype == dt and g.shape == w.shape
        assert torch.equal(g, a)           # the same bits, launch to launch
        torch.testing.assert_close(g.float(), w.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,B,Sq,Sk,H,KH,D", [
    (True, 2, 256, 256, 4, 2, 128),
    (True, 1, 200, 200, 4, 1, 64),
    (False, 2, 100, 173, 2, 2, 128),
])
def test_flash_fwd_lse_matches_plain_on_card(causal, B, Sq, Sk, H, KH, D,
                                             dtype):
    """The forward's lse against the plain one (both routes; the wgmma
    route keeps its max in log2 units), and the output bitwise the same
    with and without the lse."""
    _card()
    dt = getattr(torch, dtype)
    q = torch.from_numpy(_normal(0, B, Sq, H, D)).cuda().to(dt)
    k = torch.from_numpy(_normal(1, B, Sk, KH, D)).cuda().to(dt)
    v = torch.from_numpy(_normal(2, B, Sk, KH, D)).cuda().to(dt)
    out, lse = flash_attention_fwd(q, k, v, causal, return_lse=True)
    plain = flash_attention_fwd(q, k, v, causal)
    _, want = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    torch.testing.assert_close(lse, want, **FLASH_TOL)


@pytest.mark.gpu
def test_train_step_on_card_matches_the_cpu():
    """One smoke-config train step (grad_accum 2, remat) on the card in
    fp32 against the same step on the CPU: 4 forward and 2 backward flash
    launches, the metrics and every parameter within MODEL_TOL."""
    _card()
    cfg = get_smoke_config("llama3-8b").replace(grad_accum=2)
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
            counts = dict(kbuild.launch_counts)
            assert counts["flash_attention_fwd"] == 8   # 2 layers x 2 x 2
            assert counts["flash_attention_bwd"] == 4
    (p_cpu, _, m_cpu), (p_card, _, m_card) = out["cpu"], out["cuda"]
    for key in m_cpu:
        _close(m_card[key], m_cpu[key].numpy(), MODEL_TOL)
    for a, b in zip(flatten(p_card), flatten(p_cpu)):
        _close(a, b.numpy(), MODEL_TOL)


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("causal,B,S,H,KH,D", [
    (True, 1, 512, 4, 2, 128),
    (False, 2, 256, 4, 1, 64),
])
def test_flash_bwd_kernel_rounds_where_plain_does_on_card(causal, B, S, H,
                                                          KH, D):
    """bf16: within ROUNDING_LIMIT (relative Frobenius) of the plain
    version, and past it from the plain version without p's rounding (dv)
    or without ds's (dq, dk)."""
    _card()
    q, k, v, do = (t.cuda() for t in _t(torch.bfloat16,
                                        *_qkv_do(11, B, S, H, KH, D)))
    o, lse = flash_attention_fwd(q, k, v, causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    p, ds = flash_attention_bwd_terms(q, k, v, o, lse, do, causal)
    pr, dsr = p.bfloat16().float(), ds.bfloat16().float()
    for pp, dd, bad in ((pr, dsr, ()), (p, dsr, ("dv",)),
                        (pr, ds, ("dq", "dk"))):
        want = flash_attention_bwd_products(pp, dd, q, k, do)
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            err = _rel(g, w.bfloat16())
            if not bad:
                assert err < ROUNDING_LIMIT, (what, err)
            elif what in bad:
                assert err > ROUNDING_LIMIT, (what, err)


@pytest.mark.gpu
def test_bf16_logits_on_card_match_the_cpu():
    """bf16 logits on the card (bf16 products, fp32 sums and result) and
    the cross-entropy's gradients of x and the table (the fp32 cotangent
    split in two bf16 parts) against the CPU's fp32 products."""
    _card()
    x = torch.from_numpy(_normal(50, 3, 64, 128)).bfloat16()
    table = torch.from_numpy(_normal(51, 128, 300, scale=0.1)).bfloat16()
    labels = torch.from_numpy(
        np.random.default_rng(52).integers(0, 290, (3, 64)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        tx, tt = (a.to(dev).requires_grad_() for a in (x, table))
        logits = tL.logits_fn({"unembed": tt}, tx, 290)
        loss = tL.cross_entropy(logits, labels.to(dev))
        out[dev] = (logits, loss, *torch.autograd.grad(loss, [tx, tt]))
    (l_cpu, ce_cpu, gx_cpu, gt_cpu) = out["cpu"]
    (l_card, ce_card, gx_card, gt_card) = out["cuda"]
    assert l_card.dtype == torch.float32
    _close(l_card[..., :290], l_cpu[..., :290].detach().numpy(), BLOCK_TOL)
    _close(ce_card, ce_cpu.detach().numpy(), BLOCK_TOL)
    _close(gx_card, gx_cpu.float().numpy(), BF16_TOL)
    _close(gt_card, gt_cpu.float().numpy(), BF16_TOL)

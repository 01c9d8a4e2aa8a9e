"""The port's Mamba2 block (``repro_torch.nn.mamba2``) against
``repro.nn.mamba2``: the causal conv with and without a state, the chunk
rule, ``ssd_chunked`` at an S that the chunk divides and at ragged ones,
``ssd_step``, ``mamba2_block`` in train, prefill and decode modes, and the
gradient of ``ssd_chunked`` against ``jax.grad``. Then the kept
difference: where a chunk's summed log-decay passes ~88.7 (chunk 256, dt
~0.7, a_log 1) the reference takes ``exp`` of the unmasked upper triangle,
inf in fp32, and its dt gradient turns non-finite; the port masks the
exponent before the ``exp`` and its gradient stays finite and matches a
float64 step-by-step recurrence. Inputs come from numpy seeds, fp32, on the
CPU; JAX is imported only inside the tests (the card has none).

Tolerances, each atol times the largest magnitude of the reference's (or
float64's) result, at least 1, as ``tests/test_torch_lm.py``'s ``_close``:
BLOCK_TOL, rtol 1e-4 / atol 1e-5, for every function, its outputs, states
and gradients (fp32 sums over at most 256 positions taken in another
order: the port forms every chunk's terms in one batched product and
carries only the state from chunk to chunk). One exception: at the large
exponents a_log's gradient is held at MODEL_TOL, rtol 1e-4 / atol 1e-4,
against float64. The chunked form (the reference's too) takes each
exponent as a difference of cumulative sums that reach ~490, each off by
up to ~490 x 2^-24 ~ 3e-5 in fp32, and a_log's gradient sums every pair's
(measured 7.3e-5 of its scale; an fp32 step-by-step recurrence, 4e-7).
The ``gpu`` tests hold the card against the CPU at BLOCK_TOL (cuBLAS's
fp32 products, TF32 off).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import HybridSpec
from repro_torch.nn import mamba2 as tm
from repro_torch.nn.param import PSpec

BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
SPEC = HybridSpec(ssm_state=8, ssm_headdim=8, ssm_expand=2, ssm_chunk=16,
                  shared_attn_period=2)
D = 32


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol=BLOCK_TOL):
    """assert_allclose with atol times the largest magnitude of ``want``
    (at least 1)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _block_params(seed=0):
    """The block's parameters drawn from numpy (a_log, dt_bias, d_skip and
    the norm's scale perturbed from their inits, so each one matters), as
    numpy and as the port's tensors."""
    spec = tm.mamba2_spec(D, SPEC)
    out = {}
    for i, (name, s) in enumerate(sorted(spec.items())):
        assert isinstance(s, PSpec)
        scale = 1 / np.sqrt(s.shape[0]) if len(s.shape) == 2 else 0.3
        base = {"ones": 1.0, "zeros": 0.0}.get(s.init, 0.0)
        out[name] = (base + _normal(seed + i, *s.shape, scale=scale)
                     ).astype(np.float32)
    return out, {k: torch.from_numpy(v) for k, v in out.items()}


def _ssd_inputs(seed, b, S, H, P, N, dt_scale=0.1):
    xh = _normal(seed, b, S, H, P)
    dt = (np.abs(_normal(seed + 1, b, S, H)) * dt_scale).astype(np.float32)
    a_log = _normal(seed + 2, H, scale=0.3)
    Bm = _normal(seed + 3, b, S, N)
    Cm = _normal(seed + 4, b, S, N)
    return xh, dt, a_log, Bm, Cm


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_matches_reference(with_state, S):
    import jax.numpy as jnp
    from repro.nn import mamba2 as jm
    p_np, p = _block_params()
    C = p_np["conv_w"].shape[1]
    u = _normal(3, 2, S, C)
    st = _normal(4, 2, tm.CONV_K - 1, C) if with_state else None
    jy, js = jm._causal_conv({k: jnp.asarray(v) for k, v in p_np.items()},
                             jnp.asarray(u),
                             None if st is None else jnp.asarray(st))
    ty, ts = tm._causal_conv(p, torch.from_numpy(u),
                             None if st is None else torch.from_numpy(st))
    _close(ty, jy)
    assert tuple(ts.shape) == js.shape == (2, tm.CONV_K - 1, C)
    assert np.array_equal(ts.numpy(), np.asarray(js))  # a copy of inputs


@pytest.mark.parametrize("S,chunk,L", [(64, 16, 16), (45, 16, 15),
                                       (1023, 256, 93), (1024, 256, 256),
                                       (7, 256, 7), (13, 4, 1)])
def test_chunk_rule_is_the_references(S, chunk, L):
    assert tm.chunk_len(S, chunk) == L


@pytest.mark.parametrize("b,S,chunk", [(2, 64, 16),   # 4 whole chunks
                                       (2, 45, 16),   # ragged: L 15
                                       (1, 16, 16),   # one chunk
                                       (1, 13, 4)])   # prime S: L 1
def test_ssd_chunked_matches_reference(b, S, chunk):
    import jax.numpy as jnp
    from repro.nn import mamba2 as jm
    args = _ssd_inputs(1, b, S, 3, 4, 5)
    jy, js = jm.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, ts = tm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert ty.dtype == ts.dtype == torch.float32
    _close(ty, jy)
    _close(ts, js)


def test_ssd_step_matches_reference():
    import jax.numpy as jnp
    from repro.nn import mamba2 as jm
    b, H, P, N = 2, 3, 4, 5
    state = _normal(0, b, H, P, N)
    xh, dt = _normal(1, b, H, P), np.abs(_normal(2, b, H))
    a_log = _normal(3, H, scale=0.3)
    Bm, Cm = _normal(4, b, N), _normal(5, b, N)
    args = (state, xh, dt, a_log, Bm, Cm)
    jy, js = jm.ssd_step(*map(jnp.asarray, args))
    ty, ts = tm.ssd_step(*map(torch.from_numpy, args))
    _close(ty, jy)
    _close(ts, js)


def test_ssd_chunked_then_steps_is_the_whole_chunked_run():
    """The state a prefill leaves, stepped on token by token, gives the
    outputs and the state of one chunked run over the whole sequence."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(6, 2, 40, 3, 4, 5)]
    y_all, s_all = tm.ssd_chunked(*args, 16)
    xh, dt, a_log, Bm, Cm = args
    _, state = tm.ssd_chunked(xh[:, :32], dt[:, :32], a_log, Bm[:, :32],
                              Cm[:, :32], 16)
    for t in range(32, 40):
        y, state = tm.ssd_step(state, xh[:, t], dt[:, t], a_log, Bm[:, t],
                               Cm[:, t])
        _close(y, y_all[:, t].numpy())
    _close(state, s_all.numpy())


@pytest.mark.parametrize("mode,S", [("train", 32), ("prefill", 45),
                                    ("decode", 1)])
def test_mamba2_block_matches_reference(mode, S):
    import dataclasses

    import jax.numpy as jnp
    from repro.configs.base import HybridSpec as JHybrid
    from repro.nn import mamba2 as jm
    jspec = JHybrid(**dataclasses.asdict(SPEC))
    p_np, p = _block_params(2)
    x = _normal(7, 2, S, D)
    d_in = SPEC.ssm_expand * D
    H = d_in // SPEC.ssm_headdim
    st_np = None
    if mode == "decode":
        st_np = {"conv": _normal(8, 2, tm.CONV_K - 1, d_in + 2 *
                                 SPEC.ssm_state),
                 "ssm": _normal(9, 2, H, SPEC.ssm_headdim, SPEC.ssm_state)}
    jo, jst = jm.mamba2_block(
        {k: jnp.asarray(v) for k, v in p_np.items()}, jnp.asarray(x), jspec,
        mode=mode, state=None if st_np is None else
        {k: jnp.asarray(v) for k, v in st_np.items()})
    to, tst = tm.mamba2_block(
        p, torch.from_numpy(x), SPEC, mode=mode, state=None if st_np is None
        else {k: torch.from_numpy(v) for k, v in st_np.items()})
    assert tuple(to.shape) == (2, S, D)
    _close(to, jo)
    for name in ("conv", "ssm"):
        assert tuple(tst[name].shape) == jst[name].shape
        _close(tst[name], jst[name])
    assert tst["ssm"].dtype == torch.float32


def test_mamba2_block_bf16_keeps_the_references_dtypes():
    """bf16 in, bf16 out; the conv state in x's dtype, the SSM state in
    fp32; within bf16's rounding of the reference's bf16 run."""
    import dataclasses

    import jax.numpy as jnp
    from repro.configs.base import HybridSpec as JHybrid
    from repro.nn import mamba2 as jm
    jspec = JHybrid(**dataclasses.asdict(SPEC))
    p_np, p = _block_params(3)
    x = _normal(5, 2, 32, D)
    jo, jst = jm.mamba2_block(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p_np.items()},
        jnp.asarray(x, jnp.bfloat16), jspec, mode="prefill")
    to, tst = tm.mamba2_block({k: v.bfloat16() for k, v in p.items()},
                              torch.from_numpy(x).bfloat16(), SPEC,
                              mode="prefill")
    assert to.dtype == tst["conv"].dtype == torch.bfloat16
    assert tst["ssm"].dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2 * float(
                                   np.abs(np.asarray(jo, np.float32)).max()))


def _cotangents(seed, y_shape, s_shape):
    return _normal(seed, *y_shape), _normal(seed + 1, *s_shape)


@pytest.mark.parametrize("S,chunk", [(64, 16), (45, 16)])
def test_ssd_chunked_gradient_matches_jax_grad(S, chunk):
    """Exponents under 88 (dt ~0.1): every input's gradient of a seeded
    projection of y and the final state, against ``jax.grad``."""
    import jax
    import jax.numpy as jnp
    from repro.nn import mamba2 as jm
    b, H, P, N = 2, 3, 4, 5
    args = _ssd_inputs(11, b, S, H, P, N)
    gy, gs = _cotangents(20, (b, S, H, P), (b, H, P, N))

    def j_loss(*a):
        y, s = jm.ssd_chunked(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs)
    j_grads = jax.grad(j_loss, argnums=tuple(range(5)))(
        *map(jnp.asarray, args))
    t_args = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = tm.ssd_chunked(*t_args, chunk)
    loss = (y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()
    grads = torch.autograd.grad(loss, t_args)
    for got, want in zip(grads, j_grads):
        assert np.isfinite(np.asarray(want)).all()
        _close(got, want)


def _recurrence64(xh, dt, a_log, Bm, Cm):
    """The SSM step by step in float64: y_t = C_t . h_t, h_t = exp(dt_t A)
    h_{t-1} + dt_t x_t B_t^T."""
    A = -torch.exp(a_log)
    b, S, H, P = xh.shape
    state = xh.new_zeros((b, H, P, Bm.shape[-1]))
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)
        state = (state * decay[..., None, None]
                 + (xh[:, t] * dt[:, t, :, None])[..., None]
                 * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    return torch.stack(ys, 1), state


def test_kept_difference_large_exponents_keep_a_finite_dt_gradient():
    """Chunk 256, S 256, a_log 1 and dt in [0.6, 0.8]: a chunk's summed
    log-decay reaches ~490. The reference's dt gradient is non-finite
    (0 x inf above the diagonal); the port's is finite, and every gradient
    matches the float64 recurrence, as do y and the state (the reference's
    forward is finite and matches too). a_log's gradient at MODEL_TOL (the
    module's docstring says why)."""
    import jax
    import jax.numpy as jnp
    from repro.nn import mamba2 as jm
    b, S, H, P, N = 1, 256, 2, 4, 4
    xh = _normal(30, b, S, H, P)
    dt = (0.6 + 0.2 * np.random.default_rng(31).random((b, S, H))
          ).astype(np.float32)
    a_log = np.ones(H, np.float32)
    Bm, Cm = _normal(32, b, S, N), _normal(33, b, S, N)
    args = (xh, dt, a_log, Bm, Cm)
    gy, gs = _cotangents(34, (b, S, H, P), (b, H, P, N))

    def j_loss(*a):
        y, s = jm.ssd_chunked(*a, 256)
        return jnp.sum(y * gy) + jnp.sum(s * gs)
    j_args = tuple(map(jnp.asarray, args))
    j_grads = jax.grad(j_loss, argnums=tuple(range(5)))(*j_args)
    assert not np.isfinite(np.asarray(j_grads[1])).all()  # the reference's
    assert np.isfinite(np.asarray(j_grads[0])).all()

    def run(dtype, fn):
        t_args = [torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in args]
        y, s = fn(*t_args)
        loss = ((y * torch.from_numpy(gy).to(dtype)).sum()
                + (s * torch.from_numpy(gs).to(dtype)).sum())
        return y, s, torch.autograd.grad(loss, t_args)
    y, s, grads = run(torch.float32, lambda *a: tm.ssd_chunked(*a, 256))
    y64, s64, grads64 = run(torch.float64, _recurrence64)
    _close(y, y64.detach().numpy())
    _close(s, s64.detach().numpy())
    jy, js = jm.ssd_chunked(*j_args, 256)
    _close(torch.from_numpy(np.array(jy)), y64.detach().numpy())
    for i, (got, want) in enumerate(zip(grads, grads64)):
        assert torch.isfinite(got).all()
        _close(got, want.numpy(), MODEL_TOL if i == 2 else BLOCK_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("b,S,chunk", [(2, 512, 256), (1, 1023, 256),
                                       (2, 45, 16)])
def test_ssd_chunked_on_card_matches_the_cpu(b, S, chunk):
    _card()
    args = [torch.from_numpy(a) for a in _ssd_inputs(40, b, S, 4, 8, 16)]
    y, s = tm.ssd_chunked(*args, chunk)
    yc, sc = tm.ssd_chunked(*[a.cuda() for a in args], chunk)
    _close(yc.cpu(), y.numpy())
    _close(sc.cpu(), s.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("mode,S", [("train", 256), ("prefill", 300),
                                    ("decode", 1)])
def test_mamba2_block_on_card_matches_the_cpu(mode, S):
    _card()
    _, p = _block_params(4)
    x = torch.from_numpy(_normal(41, 2, S, D))
    d_in = SPEC.ssm_expand * D
    st = None
    if mode == "decode":
        st = {"conv": torch.from_numpy(_normal(
            42, 2, tm.CONV_K - 1, d_in + 2 * SPEC.ssm_state)),
            "ssm": torch.from_numpy(_normal(
                43, 2, d_in // SPEC.ssm_headdim, SPEC.ssm_headdim,
                SPEC.ssm_state))}
    out, new = tm.mamba2_block(p, x, SPEC, mode=mode, state=st)
    out_c, new_c = tm.mamba2_block(
        {k: v.cuda() for k, v in p.items()}, x.cuda(), SPEC, mode=mode,
        state=None if st is None else {k: v.cuda() for k, v in st.items()})
    _close(out_c.cpu(), out.numpy())
    for name in ("conv", "ssm"):
        _close(new_c[name].cpu(), new[name].numpy())

"""The port's RWKV-6 (RWKV-6-3B's ``smoke()`` config) against ``repro``:
``timemix`` and ``channelmix`` (outputs and states, from no state and from
a given one), ``wkv6_recurrent``, and the whole model's ``prefill_fn`` and
``decode_fn`` (logits, and the token-shift and WKV states), on the same
numpy-seeded inputs and bridged parameters, in fp32 on the CPU. Prefill
runs the plain version of the ``wkv6_chunk`` kernel; decode the plain
recurrence.

Tolerance: rtol 1e-4 / atol 1e-5 for the blocks and rtol 1e-4 / atol 1e-4
for whole-model logits and states, each atol times the largest magnitude
of the reference's result (at least 1): fp32 products taken in another
order, and WKV sums over up to 24 tokens in chunks against the
reference's chunks, or token by token, whose states reach magnitudes of
about 50 here. JAX is imported only inside the tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.registry import build, sample_inputs
from repro_torch.nn import rwkv6 as trw
from repro_torch.nn.param import params_from_numpy

BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol):
    """assert_allclose with atol times the largest magnitude of ``want``
    (at least 1): an element that cancels towards zero keeps the absolute
    error of its terms' size."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _block_params(spec_fn, *args, seed=0):
    """Parameters for a block spec: every leaf drawn (zeros- and
    ones-initialised leaves too, so that every path carries weight)."""
    spec = spec_fn(*args)
    return {k: _normal(seed + i, *s.shape, scale=0.3)
            for i, (k, s) in enumerate(sorted(spec.items()))}


def _j(p):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


@pytest.mark.parametrize("S,with_state", [(24, False), (19, True),
                                          (1, True)])
def test_timemix_matches_reference(S, with_state):
    import jax.numpy as jnp
    from repro.configs.base import RWKVSpec as JSpec
    from repro.nn import rwkv6 as jrw
    spec = get_smoke_config("rwkv6-3b").rwkv
    jspec = JSpec(**spec.__dict__)
    d, hs = 64, spec.head_size
    p = _block_params(jrw.timemix_spec, d, jspec)
    p["w_base"] = p["w_base"] - 1.0   # decays well inside (0, 1)
    x = _normal(50, 2, S, d)
    st = ({"shift": _normal(51, 2, d),
           "wkv": _normal(52, 2, d // hs, hs, hs, scale=0.3)}
          if with_state else None)
    want, wst = jrw.timemix(_j(p), jnp.asarray(x), jspec,
                            state=None if st is None else _j(st))
    got, gst = trw.timemix(_t(p), torch.from_numpy(x), spec,
                           state=None if st is None else _t(st))
    _close(got, want, BLOCK_TOL)
    _close(gst["shift"], wst["shift"], BLOCK_TOL)
    _close(gst["wkv"], wst["wkv"], BLOCK_TOL)


@pytest.mark.parametrize("S,with_state", [(24, False), (7, True),
                                          (1, True)])
def test_channelmix_matches_reference(S, with_state):
    import jax.numpy as jnp
    from repro.nn import rwkv6 as jrw
    p = _block_params(jrw.channelmix_spec, 64, 128, seed=10)
    x = _normal(60, 2, S, 64)
    st = {"shift": _normal(61, 2, 64)} if with_state else None
    want, wst = jrw.channelmix(_j(p), jnp.asarray(x),
                               state=None if st is None else _j(st))
    got, gst = trw.channelmix(_t(p), torch.from_numpy(x),
                              state=None if st is None else _t(st))
    _close(got, want, BLOCK_TOL)
    _close(gst["shift"], wst["shift"], BLOCK_TOL)


@pytest.mark.parametrize("S", [1, 9])
def test_wkv6_recurrent_matches_reference(S):
    import jax.numpy as jnp
    from repro.nn.rwkv6 import wkv6_recurrent
    B, H, K = 2, 3, 16
    r, k, v = (_normal(i, B, S, H, K, scale=0.5) for i in range(3))
    lw = -np.exp(_normal(3, B, S, H, K))
    u, s0 = _normal(4, H, K, scale=0.5), _normal(5, B, H, K, K)
    y_j, st_j = wkv6_recurrent(*map(jnp.asarray, (r, k, v, lw, u, s0)))
    y, st = trw.wkv6_recurrent(*map(torch.from_numpy, (r, k, v, lw, u, s0)))
    _close(y, y_j, BLOCK_TOL)
    _close(st, st_j, BLOCK_TOL)


@pytest.mark.parametrize("B,S", [(2, 24), (1, 13)])
def test_rwkv_prefill_and_decode_match_reference(B, S):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as JShape
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import build as j_build
    from repro.models.registry import sample_inputs as j_sample
    jb = j_build(j_smoke("rwkv6-3b"))
    jp = jb.init_params(jax.random.PRNGKey(2), jnp.float32)
    # the init leaves u, mu and the decay base at zero; give them weight
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: (x + 0.2 * jax.random.normal(
            jax.random.PRNGKey(len(str(path))), x.shape)
            if any(getattr(k, "key", None) in ("u", "mu_base", "mu_k",
                                               "mu_r") for k in path)
            else x), jp)
    tb = build(get_smoke_config("rwkv6-3b"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    shape = JShape("t", S, B, "prefill")
    jbatch = j_sample(jb.cfg, shape, np.random.default_rng(5))
    tbatch = sample_inputs(tb.cfg, shape, np.random.default_rng(5), "cpu")
    jl, js = jb.prefill_fn(jp, jbatch)
    tl, ts = make_prefill_step(tb)(tp, tbatch)
    assert tl.shape == (B, 1, tb.cfg.vocab_size)
    _close(tl, jl, MODEL_TOL)
    spec = tb.cache_spec(B, S)
    for name in ("tm_shift", "wkv", "cm_shift"):
        assert tuple(ts[name].shape) == spec[name].shape
        _close(ts[name], js[name], MODEL_TOL)
    decode = make_decode_step(tb)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
        np.int32)
    for i in range(3):
        jl, js = jb.decode_fn(jp, js, {"tokens": jnp.asarray(tok),
                                       "pos": jnp.asarray(S + i)})
        tl, ts = decode(tp, ts, {"tokens": torch.from_numpy(tok),
                                 "pos": S + i})
        _close(tl, jl, MODEL_TOL)
        for name in ("tm_shift", "wkv", "cm_shift"):
            _close(ts[name], js[name], MODEL_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)

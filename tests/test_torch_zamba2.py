"""The port's hybrid family (``repro_torch.models.zamba2``, Zamba2-2.7B's
``smoke()`` config: 4 Mamba2 layers in 2 groups of 2, the shared attention
block called after each group) against ``repro.models.zamba2``: the
config, the parameter and state specs, the weight bridge in pytree order
over the doubly stacked backbone, the init's laws, prefill logits with
all four state leaves, decode steps after the prefill, ``loss_fn`` and
every gradient leaf, one ``make_train_step`` step, and the launcher.
Inputs come from numpy seeds, the reference's parameters are carried
across by ``nn.param.params_from_numpy``, fp32 on the CPU; JAX is imported
only inside the tests (the card has none).

Tolerances, as ``tests/test_torch_lm.py``'s (each atol times the largest
magnitude of the reference's result, at least 1): MODEL_TOL, rtol 1e-4 /
atol 1e-4, for the whole model's logits, states, loss, gradients and the
parameters, moments and metrics after a step (four Mamba2 layers and two
calls of the shared block, fp32 sums taken in another order; the
backbone's gradients are the worst conditioned: the port's and the
reference's both sit ~5e-5 of their scale from a float64 run of the port).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointing import flatten_with_paths
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import zamba2
from repro_torch.models.registry import build, sample_inputs
from repro_torch.nn.param import flatten, params_from_numpy, unflatten
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedules import get_schedule

ARCH = "zamba2-2.7b"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol=MODEL_TOL):
    """assert_allclose with atol times the largest magnitude of ``want``
    (at least 1)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _bundles(seed=0, **cfg_kw):
    """The reference's bundle and fp32 parameters for the smoke config,
    and the port's bundle with them bridged."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import build as j_build
    jb = j_build(j_smoke(ARCH).replace(**cfg_kw))
    jp = jb.init_params(jax.random.PRNGKey(seed), jnp.float32)
    tb = build(get_smoke_config(ARCH).replace(**cfg_kw))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jb, jp, tb, tp


# ---------------------------------------------------------------------------
# config, specs, bridge, init
# ---------------------------------------------------------------------------

def test_config_and_specs_are_the_references():
    from repro.configs.registry import get_config as j_config
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models import zamba2 as jz
    from repro.nn.param import PSpec as JPSpec
    import jax
    for mine, theirs in ((get_config(ARCH), j_config(ARCH)),
                         (get_smoke_config(ARCH), j_smoke(ARCH))):
        assert dataclasses.asdict(mine.hybrid) == dataclasses.asdict(
            theirs.hybrid)
        assert mine.param_count() == theirs.param_count()
        for fn_mine, fn_theirs in (
                (zamba2.param_spec(mine), jz.param_spec(theirs)),
                (zamba2.state_spec(mine, 3, 40),
                 jz.state_spec(theirs, 3, 40))):
            leaves = jax.tree.leaves(
                fn_theirs, is_leaf=lambda s: isinstance(s, JPSpec))
            got = flatten(fn_mine)
            assert [(s.shape, s.init, s.scale) for s in got] == [
                (s.shape, s.init, s.scale) for s in leaves]
    cfg = get_config(ARCH)
    assert cfg.hybrid.ssm_chunk == 256
    assert zamba2._groups(cfg) == (9, 6)
    assert cfg.resolved_head_dim == 80   # the shared block's head dim
    with pytest.raises(AssertionError):
        zamba2._groups(cfg.replace(n_layers=8))


@pytest.mark.parametrize("seed", [0, 5])
def test_bridge_carries_the_nested_tree_in_pytree_order(seed):
    """Leaves in ``jax.tree.leaves`` order: backbone (ln, then mamba's
    leaves, each (G, period, ...)), embed, ln_f, shared; bitwise there and
    back."""
    import jax
    _, jp, _, tp = _bundles(seed)
    names = list(flatten_with_paths(tp))
    assert [n.split("/")[0] for n in names] == sorted(
        n.split("/")[0] for n in names)
    assert names[0] == "backbone/ln/scale" and names[-1] == "shared/mlp/wo"
    j_paths = ["/".join(str(getattr(k, "key", k)) for k in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == j_paths
    for a, b in zip(flatten(tp), jax.tree.leaves(jp)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    G, period = zamba2._groups(get_smoke_config(ARCH))
    assert tuple(tp["backbone"]["mamba"]["w_in"].shape[:2]) == (G, period)


def test_init_draws_the_doubly_stacked_leaves_by_the_references_law():
    """The reference's law: a leaf of 3 or more dims takes the product of
    its middle dims as its fan-in, so period x d for (G, period, d, X)
    leaves (period x 4 for the conv's (G, period, 4, C)), and the shared
    block's (d, H, 80) query its H heads, its (H, 80, d) output 80; a
    matrix its first dim. Each drawn leaf's std within 10% of the law's,
    at Zamba2's published widths cut to 2 groups."""
    cfg = get_config(ARCH).replace(n_layers=12, vocab_size=512)
    tb = build(cfg)
    p = tb.init_params(0, torch.float32, "cpu")
    period, d = cfg.hybrid.shared_attn_period, cfg.d_model
    laws = {"backbone/mamba/w_in": 1 / np.sqrt(period * d),
            "backbone/mamba/w_out": 1 / np.sqrt(period * 2 * d),
            "backbone/mamba/conv_w": 1 / np.sqrt(period * 4),
            "shared/mlp/wi_gate": 1 / np.sqrt(d),
            "shared/attn/wq": 1 / np.sqrt(cfg.n_heads),
            "shared/attn/wo": 1 / np.sqrt(cfg.resolved_head_dim)}
    leaves = flatten_with_paths(p)
    for name, want in laws.items():
        got = float(leaves[name].std())
        assert abs(got / want - 1) < 0.1, (name, got, want)
    for name in ("backbone/mamba/a_log", "backbone/mamba/d_skip"):
        assert torch.equal(leaves[name], torch.ones_like(leaves[name]))
    assert torch.equal(leaves["backbone/mamba/dt_bias"],
                       torch.zeros_like(leaves["backbone/mamba/dt_bias"]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _grow(state, extra):
    """k and v grown by ``extra`` slots along their sequence (dim 2); the
    conv and SSM states need none."""
    return {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra))
                if k in ("k", "v") else v) for k, v in state.items()}


@pytest.mark.parametrize("B,S", [(2, 64), (1, 45), (2, 16)])
def test_prefill_and_decode_match_reference(B, S):
    """Prefill logits and all four state leaves, then three greedy decode
    steps from the grown state. S 64 is two whole chunks of the smoke's 32,
    45 chunks in 15s (the reference's rule), 16 one short chunk."""
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as JShape
    from repro.models.registry import sample_inputs as j_sample
    jb, jp, tb, tp = _bundles(seed=1)
    cfg = tb.cfg
    shape = JShape("t", S, B, "prefill")
    jbatch = j_sample(jb.cfg, shape, np.random.default_rng(4))
    tbatch = sample_inputs(cfg, shape, np.random.default_rng(4), "cpu")
    assert np.array_equal(tbatch["tokens"].numpy(),
                          np.asarray(jbatch["tokens"]))
    jl, jc = jb.prefill_fn(jp, jbatch)
    tl, tc = make_prefill_step(tb)(tp, tbatch)
    assert tl.shape == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    assert set(tc) == set(jc) == {"conv", "ssm", "k", "v"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    assert tc["ssm"].dtype == torch.float32
    extra = 3
    jc = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
              if k in ("k", "v") else v) for k, v in jc.items()}
    tc = _grow(tc, extra)
    decode = make_decode_step(tb)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
        np.int32)
    for i in range(extra):
        jl, jc = jb.decode_fn(jp, jc, {"tokens": jnp.asarray(tok),
                                       "pos": jnp.asarray(S + i, jnp.int32)})
        tl, tc = decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                 "pos": S + i})
        _close(tl, jl)
        for name in tc:
            _close(tc[name], jc[name])
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)


def test_decode_writes_k_and_v_in_place_and_returns_new_mamba_states():
    tb = build(get_smoke_config(ARCH))
    p = tb.init_params(0, torch.float32, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, tb.cfg.vocab_size, (2, 6)).astype(np.int32))
    _, state = tb.prefill_fn(p, {"tokens": tokens})
    state = _grow(state, 2)
    before = {k: v.clone() for k, v in state.items()}
    _, after = tb.decode_fn(p, state, {"tokens": tokens[:, :1], "pos": 6})
    for name in ("k", "v"):
        t = state[name]
        assert after[name] is t
        assert torch.equal(t[:, :, :6], before[name][:, :, :6])
        assert not torch.equal(t[:, :, 6], before[name][:, :, 6])
    for name in ("conv", "ssm"):
        assert after[name] is not state[name]
        assert torch.equal(state[name], before[name])
        assert not torch.equal(after[name], before[name])


def test_cache_spec_is_the_state_a_prefill_returns():
    tb = build(get_smoke_config(ARCH))
    p = tb.init_params(0, torch.float32, "cpu")
    _, state = tb.prefill_fn(p, {"tokens": torch.zeros((3, 10),
                                                       dtype=torch.int32)})
    spec = tb.cache_spec(3, 10)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: s.shape for k, s in spec.items()}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(B, S, seed=5, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_fn_and_every_gradient_leaf_match_reference(remat):
    import jax
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles(remat=remat)
    batch = _batch(2, 32)
    (j_loss, j_met), j_grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.clone().requires_grad_() for t in flatten(tp)]
    loss, met = tb.loss_fn(unflatten(tp, leaves),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert set(met) == set(j_met) == {"loss", "ce"}
    for key in met:
        _close(met[key], np.asarray(j_met[key]))
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for got, want in zip(grads, j_leaves):
        assert tuple(got.shape) == want.shape
        _close(got, np.asarray(want))


def test_remat_recomputes_only_the_mamba_layers(monkeypatch):
    """Under remat "full" each Mamba2 layer runs twice (its forward and
    the backward's recompute) and the shared block once a group; the
    gradients are bitwise remat "none"'s."""
    calls = {"mamba": 0, "shared": 0}
    mamba, shared = zamba2._mamba_layer, zamba2._shared_block

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(zamba2, "_mamba_layer", counting("mamba", mamba))
    monkeypatch.setattr(zamba2, "_shared_block", counting("shared", shared))
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 16).items()}
    runs = []
    for remat in ("full", "none"):
        tb = build(get_smoke_config(ARCH).replace(remat=remat))
        tp = tb.init_params(3, torch.float32, "cpu")
        leaves = [t.clone().requires_grad_() for t in flatten(tp)]
        for k in calls:
            calls[k] = 0
        loss, _ = tb.loss_fn(unflatten(tp, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        runs.append((loss, grads, dict(calls)))
    (l_full, g_full, c_full), (l_none, g_none, c_none) = runs
    assert torch.equal(l_full, l_none)
    assert all(torch.equal(a, b) for a, b in zip(g_full, g_none))
    assert c_full == {"mamba": 8, "shared": 2}
    assert c_none == {"mamba": 4, "shared": 2}


def test_train_step_matches_reference():
    """One ``make_train_step`` step (grad_accum 2 over a batch of 4)
    against the reference's jitted step, from the same parameters, with
    AdamW on a cosine schedule: the parameters, m, v and the metrics. At
    16 positions no chunk's summed log-decay reaches 88, so the reference's
    gradient is finite; at 32 some seeded batches pass it and the
    reference's gradient norm is NaN (the kept difference,
    ``tests/test_torch_mamba2.py``)."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as j_make
    from repro.optim.adam import AdamW as JAdamW
    from repro.optim.schedules import get_schedule as j_schedule
    jb, jp, tb, tp = _bundles(seed=2, grad_accum=2)
    batch = _batch(4, 16, seed=9)
    j_opt = JAdamW(j_schedule("cosine", 1e-3, 2, 10))
    j_state = j_opt.init(jp)
    jp, j_state, j_met = jax.jit(j_make(jb, j_opt))(
        jp, j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    opt = AdamW(get_schedule("cosine", 1e-3, 2, 10))
    tp, state, met = make_train_step(tb, opt)(
        tp, opt.init(flatten(tp)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(met) == set(j_met) == {"loss", "lr", "grad_norm"}
    for key in met:
        _close(met[key], np.asarray(j_met[key]))
    assert state["step"] == int(j_state["step"]) == 1
    for got, want in zip(flatten(tp), jax.tree.leaves(jp)):
        _close(got, np.asarray(want))
    for name in ("m", "v"):
        for got, want in zip(state[name], jax.tree.leaves(j_state[name])):
            _close(got, np.asarray(want))


def test_launcher_trains_zamba2_and_its_loss_falls():
    from repro_torch.launch import train
    res = train.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                      "--seq", "32", "--lr", "3e-3", "--steps", "10"])
    losses = res["losses"]
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.05


def test_sample_inputs_for_the_hybrid_are_tokens_and_labels():
    cfg = get_smoke_config(ARCH)
    batch = sample_inputs(cfg, ShapeSpec("t", 32, 2, "train"),
                          np.random.default_rng(0), "cpu")
    assert set(batch) == {"tokens", "labels"}
    assert batch["tokens"].dtype == torch.int32

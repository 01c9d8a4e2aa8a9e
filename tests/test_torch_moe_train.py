"""The port's MoE family (OLMoE-1B-7B's and Grok-1's smoke configs)
against ``repro``: ``loss_fn`` (loss, ce and aux) with every gradient
leaf, in fp32 and bf16; remat "full" against "none" bitwise; three
``make_train_step`` steps with gradient accumulation; and the launcher on
olmoe-smoke. The reference's parameters are carried across by
``nn.param.params_from_numpy``, tokens come from numpy seeds, and JAX is
imported only inside the tests (the card has none).

Tolerances, each atol times the largest magnitude of the reference's
result (at least 1), as ``tests/test_torch_lm_train.py``'s:
* MODEL_TOL, rtol 1e-4 / atol 1e-4: the loss, ce, aux and every gradient
  leaf in fp32, and the parameters, moments and metrics after three AdamW
  steps (two layers of fp32 sums taken in another order, then AdamW's
  m / sqrt(v));
* BF16_TOL, rtol 2e-2 / atol 2e-2, and BF16_LOSS_TOL, rtol 1e-3 / atol
  1e-3 for the loss and aux: the bf16 smoke models (the dense model's
  bf16 tolerances: bf16 activations round in other places on the two
  sides).
A comparison holds only while both sides route alike, so the fp32 test
first requires every layer's expert choices to be the reference's: a
near-tie that flipped fails by name, not by a tolerance.
The ``gpu`` test holds an olmoe-smoke step on the card against the CPU
(skipped here), fp32 with TF32 off, at MODEL_TOL.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build, sample_inputs
from repro_torch.nn import moe as tmoe
from repro_torch.nn.param import (flatten, params_from_numpy,
                                  params_to_numpy, unflatten)
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedules import get_schedule

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
MOE_ARCHS = ("olmoe-1b-7b", "grok-1-314b")


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _bundles(arch, seed=0, **cfg_kw):
    """The reference's and the port's bundles of ``arch``'s smoke config
    (with ``cfg_kw`` replaced) and the reference's fp32 parameters,
    bridged."""
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


def _layer_experts(tb, tp, tokens):
    """Each layer's chosen experts in the port's train-mode forward
    (recorded from ``nn.moe.route``)."""
    seen = []
    route = tmoe.route

    def recording(*a):
        out = route(*a)
        seen.append(out[1].clone())
        return out
    tmoe.route = recording
    try:
        with torch.no_grad():
            tb.loss_fn(tp, {"tokens": torch.from_numpy(tokens),
                            "labels": torch.from_numpy(tokens)})
    finally:
        tmoe.route = route
    return seen


def _reference_layer_experts(jb, jp, tokens):
    """The same from the reference: its layers applied one by one under
    ``jax.jit``, ``repro.nn.moe.route`` wrapped while the function is
    traced, so that each layer's experts are outputs of the jitted
    function."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as j_lm
    from repro.nn import moe as j_moe
    route = j_moe.route

    def layers(jp, tokens):
        seen = []

        def recording(*a):
            out = route(*a)
            seen.append(out[1])
            return out
        j_moe.route = recording
        try:
            x = j_lm.L.embed_tokens(jp["embed"], tokens)
            positions = jnp.arange(tokens.shape[1])[None, :]
            for l in range(jb.cfg.n_layers):
                p_l = jax.tree.map(lambda a, l=l: a[l], jp["layers"])
                x, _, _ = j_lm._layer_apply(jb.cfg, p_l, x, positions,
                                            "train", None, "seq_kv")
        finally:
            j_moe.route = route
        return seen
    return [np.asarray(e) for e in jax.jit(layers)(jp, jnp.asarray(tokens))]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_fn_and_every_gradient_leaf_match_reference(arch):
    """Under remat "full" (the configs' own; "none" gives the same bits,
    below), after the expert choices of every layer were found equal."""
    import jax
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles(arch)
    batch = _batch(2, 32)
    for got, want in zip(_layer_experts(tb, tp, batch["tokens"]),
                         _reference_layer_experts(jb, jp, batch["tokens"])):
        assert np.array_equal(got.numpy(), want)
    (j_loss, j_met), j_grads = jax.jit(jax.value_and_grad(
        jb.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads = _port_grads(tb, tp, batch)
    assert set(met) == set(j_met) == {"loss", "ce", "aux"}
    assert float(met["aux"].detach()) > 0
    for key in met:
        _close(met[key], np.asarray(j_met[key]), MODEL_TOL)
    _close(loss, np.asarray(j_loss), MODEL_TOL)
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for got, want in zip(grads, j_leaves):
        assert tuple(got.shape) == want.shape
        _close(got, np.asarray(want), MODEL_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_loss_and_every_gradient_leaf_match_reference(arch):
    import jax
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles(arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = unflatten(tp, [t.bfloat16() for t in flatten(tp)])
    batch = _batch(2, 32)
    (j_loss, j_met), j_grads = jax.jit(jax.value_and_grad(
        jb.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, met, grads = _port_grads(tb, tp, batch)
    assert loss.dtype == torch.float32
    _close(loss, np.asarray(j_loss), BF16_LOSS_TOL)
    _close(met["aux"], np.asarray(j_met["aux"]), BF16_LOSS_TOL)
    for got, want in zip(grads, jax.tree.leaves(j_grads)):
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_full_and_none_give_bitwise_equal_gradients(arch):
    """Remat recomputes each layer, routing included, from the same
    inputs: on the CPU the same bits."""
    batch = _batch(2, 24, seed=6)
    runs = []
    for remat in ("full", "none"):
        tb = build(get_smoke_config(arch).replace(remat=remat))
        tp = tb.init_params(3, torch.float32, "cpu")
        runs.append(_port_grads(tb, tp, batch))
    (l_full, m_full, g_full), (l_none, m_none, g_none) = runs
    assert torch.equal(l_full, l_none)
    assert torch.equal(m_full["aux"], m_none["aux"])
    assert all(torch.equal(a, b) for a, b in zip(g_full, g_none))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_steps_match_reference(arch):
    """Three ``make_train_step`` steps against the reference's, grad_accum
    2 over a batch of 4: parameters, m, v, the step and the metrics."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as j_make
    from repro.optim.adam import AdamW as JAdamW
    from repro.optim.schedules import get_schedule as j_schedule
    jb, jp, tb, tp = _bundles(arch, seed=1, grad_accum=2)
    batches = [_batch(4, 16, seed=10 + i) for i in range(3)]
    j_opt = JAdamW(j_schedule("cosine", 1e-3, 2, 10))
    j_state = j_opt.init(jp)
    j_step = jax.jit(j_make(jb, j_opt))
    opt = AdamW(get_schedule("cosine", 1e-3, 2, 10))
    state = opt.init(flatten(tp))
    step = make_train_step(tb, opt)
    for b in batches:
        jp, j_state, j_met = j_step(
            jp, j_state, {k: jnp.asarray(v) for k, v in b.items()})
        tp, state, met = step(
            tp, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(met) == set(j_met) == {"loss", "lr", "grad_norm"}
        for key in met:
            _close(met[key], np.asarray(j_met[key]), MODEL_TOL)
    assert state["step"] == int(j_state["step"]) == 3
    for got, want in zip(flatten(tp), jax.tree.leaves(jp)):
        _close(got, np.asarray(want), MODEL_TOL)
    for name in ("m", "v"):
        for got, want in zip(state[name], jax.tree.leaves(j_state[name])):
            _close(got, np.asarray(want), MODEL_TOL)


def test_grok_trains_with_bf16_moments_as_the_reference():
    """Grok-1's smoke config with its published ``adam_dtype="bfloat16"``
    (micro-batch gradients summed in bf16, AdamW's m and v in bf16) and
    bf16 parameters (the reference's accumulation carries the
    parameters' dtype), as it trains on the CPU: three steps against the
    reference's with the same settings. The loss at BF16_LOSS_TOL, the
    parameters, m and v at BF16_TOL (bf16 values round in other places on
    the two sides)."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as j_make
    from repro.optim.adam import AdamW as JAdamW
    from repro.optim.schedules import get_schedule as j_schedule
    jb, jp, tb, tp = _bundles("grok-1-314b", seed=2, grad_accum=2,
                              adam_dtype="bfloat16")
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = unflatten(tp, [t.bfloat16() for t in flatten(tp)])
    batches = [_batch(4, 16, seed=20 + i) for i in range(3)]
    j_opt = JAdamW(j_schedule("cosine", 1e-3, 2, 10),
                   moment_dtype="bfloat16")
    j_state = j_opt.init(jp)
    j_step = jax.jit(j_make(jb, j_opt))
    opt = AdamW(get_schedule("cosine", 1e-3, 2, 10),
                moment_dtype=tb.cfg.adam_dtype)
    state = opt.init(flatten(tp))
    step = make_train_step(tb, opt)
    for b in batches:
        jp, j_state, j_met = j_step(
            jp, j_state, {k: jnp.asarray(v) for k, v in b.items()})
        tp, state, met = step(
            tp, state, {k: torch.from_numpy(v) for k, v in b.items()})
        _close(met["loss"], np.asarray(j_met["loss"]), BF16_LOSS_TOL)
    for got, want in zip(flatten(tp), jax.tree.leaves(jp)):
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)
    for name in ("m", "v"):
        for got, want in zip(state[name], jax.tree.leaves(j_state[name])):
            assert got.dtype == torch.bfloat16
            _close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_drops_the_reference_drops(arch):
    """``tests/moe_routing_compare.py`` at the smoke config, 2 rows of 64
    tokens at capacity_factor 0.5: in every layer the port's ``rank``
    drops as many pairs as the reference's experts imply, and the experts
    are the reference's."""
    from moe_routing_compare import compare
    rows = compare(arch, 2, 64, batch=2, capacity_factor=0.5, smoke=True)
    assert len(rows) == 2
    for row in rows:
        assert row["tokens_whose_experts_differ"] == 0
        assert row["dropped_port"] == row["dropped_port_from_experts"] \
            == row["dropped_reference"] > 0


def test_launcher_trains_olmoe_smoke_and_its_loss_falls():
    """30 steps of fresh random batches: the loss falls towards the
    uniform labels' ln(256) (the mean of the last 5 steps at least 0.1
    under the first 5's)."""
    from repro_torch.launch import train
    res = train.main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--batch",
                      "4", "--seq", "32", "--lr", "3e-3", "--steps", "30"])
    losses = res["losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


# ---------------------------------------------------------------------------
# on the card (skipped here)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_olmoe_train_step_on_card_matches_the_cpu():
    """One olmoe-smoke train step (grad_accum 2, remat) on the card in fp32
    against the same step on the CPU: 4 forward and 2 backward flash
    launches, the metrics and every parameter within MODEL_TOL."""
    from repro_torch.kernels import build as kbuild
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config("olmoe-1b-7b").replace(grad_accum=2)
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

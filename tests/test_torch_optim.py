"""The port's hand-written AdamW, SGDM and the cosine and WSD schedules
against ``repro.optim`` over 10 steps of a fixed gradient sequence (the
schedules over their whole range), at rtol 1e-6: float32 math in
the same order, but the global gradient norm is summed in another order and
XLA may fuse a multiply-add, so the clip scale and a moment can differ in
the last bit. An entry that comes out of a cancellation (a moment near zero)
keeps the absolute error of its terms, so each array is also allowed 1e-6
of its largest entry as absolute error."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adam import SGDM as JSGDM
from repro.optim.adam import AdamW as JAdamW
from repro.optim.schedules import get_schedule as j_get_schedule
from repro.optim.schedules import wsd as j_wsd

from repro_torch.nn.param import flatten
from repro_torch.optim.adam import SGDM as TSGDM
from repro_torch.optim.adam import AdamW as TAdamW
from repro_torch.optim.schedules import cosine as t_cosine
from repro_torch.optim.schedules import get_schedule as t_get_schedule
from repro_torch.optim.schedules import wsd as t_wsd

RTOL = 1e-6


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=RTOL,
                               atol=RTOL * float(np.abs(b).max()))


def test_cosine_schedule_matches():
    j = j_get_schedule("cosine", 1e-2, 10, 100_000)
    t = t_cosine(1e-2, 10, 100_000)
    short_j = j_get_schedule("cosine", 3e-3, 4, 20)
    short_t = t_cosine(3e-3, 4, 20)
    for step in list(range(0, 30)) + [5_000, 99_999, 100_000, 200_000]:
        np.testing.assert_allclose(float(t(step)), float(j(step)), rtol=RTOL)
        np.testing.assert_allclose(float(short_t(step)), float(short_j(step)),
                                   rtol=RTOL)


@pytest.mark.parametrize("name,warmup,total", [("wsd", 10, 100),
                                                ("wsd", 3, 40),
                                                ("wsd", 0, 7),
                                                ("cosine", 10, 100)])
def test_get_schedule_matches(name, warmup, total):
    """``get_schedule`` (and ``wsd`` with its decay knobs) at every step
    from 0 to total + 5: warmup, the plateau, the exponential decay and
    the floor after it."""
    cases = [(j_get_schedule(name, 1e-2, warmup, total),
              t_get_schedule(name, 1e-2, warmup, total))]
    if name == "wsd":
        cases.append((j_wsd(3e-3, warmup, total, 0.25, 0.05),
                      t_wsd(3e-3, warmup, total, 0.25, 0.05)))
    for j, t in cases:
        for step in range(total + 6):
            np.testing.assert_allclose(float(t(step)), float(j(step)),
                                       rtol=RTOL)


def _tree_and_grads(rng):
    tree = {"layers": [{"w_self": rng.standard_normal((6, 4)),
                        "w_neigh": rng.standard_normal((6, 4)),
                        "b": np.zeros(4)},
                       {"w": rng.standard_normal((4, 3)), "b": np.zeros(3)}]}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a, s=s: (rng.standard_normal(a.shape)
                                          * 0.05 * s).astype(np.float32),
                          tree) for s in range(1, 11)]
    return tree, grads


@pytest.mark.parametrize("momentum", [0.9, 0.5])
def test_sgdm_ten_steps_match(momentum):
    """SGDM: an fp32 momentum and ``p - lr * m``, no clip and no weight
    decay; its info is ``{"lr"}`` alone, as the reference's."""
    tree, grads = _tree_and_grads(np.random.default_rng(1))
    jopt = JSGDM(j_get_schedule("cosine", 1e-2, 3, 50), momentum=momentum)
    topt = TSGDM(t_cosine(1e-2, 3, 50), momentum=momentum)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in flatten(tree)]
    ts = topt.init(tp)
    assert set(ts) == set(js) and ts["step"] == 0
    for g in grads:
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = topt.update([torch.from_numpy(a) for a in flatten(g)],
                                 ts, tp)
        assert set(tm) == set(jm) == {"lr"}
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        for a, b in zip(tp, jax.tree.leaves(jp)):
            _close(a.numpy(), b)
        for a, b in zip(ts["m"], jax.tree.leaves(js["m"])):
            assert a.dtype == torch.float32
            _close(a.numpy(), b)
        assert ts["step"] == int(js["step"])


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_ten_steps_match(weight_decay):
    rng = np.random.default_rng(0)
    tree = {"layers": [{"w_self": rng.standard_normal((6, 4)),
                        "w_neigh": rng.standard_normal((6, 4)),
                        "b": np.zeros(4)},
                       {"w": rng.standard_normal((4, 3)), "b": np.zeros(3)}]}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    # gradients of growing size: the later ones are clipped to norm 1
    grads = [jax.tree.map(lambda a, s=s: (rng.standard_normal(a.shape)
                                          * 0.05 * s).astype(np.float32),
                          tree) for s in range(1, 11)]

    jopt = JAdamW(j_get_schedule("cosine", 1e-2, 3, 50),
                  weight_decay=weight_decay)
    topt = TAdamW(t_cosine(1e-2, 3, 50),
                  weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in flatten(tree)]
    ts = topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = topt.update([torch.from_numpy(a) for a in flatten(g)],
                                 ts, tp)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        for a, b in zip(tp, jax.tree.leaves(jp)):
            _close(a.numpy(), b)
        for key in ("m", "v"):
            for a, b in zip(ts[key], jax.tree.leaves(js[key])):
                _close(a.numpy(), b)
        assert ts["step"] == int(js["step"])


# ---------------------------------------------------------------------------
# bf16 moments (``moment_dtype="bfloat16"``)
# ---------------------------------------------------------------------------

# m and v are rounded to bf16 after every step on both sides, from fp32
# values that may differ in their last bit (the fp32 tolerance above):
# such a difference moves a rounding by one bf16 ulp (2^-8 of the value)
# at a tie, after which the two runs carry different moments. Moments are
# held within two bf16 ulps (rtol 2^-7, and 2^-7 of the array's largest
# entry as absolute error); the parameters, which move by lr x m / sqrt(v),
# within 2^-7 x lr x the step count of 10 as absolute error. (Measured on
# the CPU: every moment and parameter bitwise the reference's.)
BF16_MOMENT_RTOL = 2.0 ** -7


def test_adamw_bf16_moments_keep_their_dtype():
    """The reference's ``test_adam_bf16_moments``: bf16 parameters and
    gradients, m and v bf16 at init and after a step, the parameters
    bf16."""
    opt = TAdamW(lambda s: 0.1, moment_dtype="bfloat16")
    p = [torch.ones(8, dtype=torch.bfloat16)]
    st = opt.init(p)
    assert st["m"][0].dtype == st["v"][0].dtype == torch.bfloat16
    newp, st, _ = opt.update([torch.full((8,), 0.1, dtype=torch.bfloat16)],
                             st, p)
    assert st["m"][0].dtype == st["v"][0].dtype == torch.bfloat16
    assert newp[0].dtype == torch.bfloat16
    f32 = TAdamW(lambda s: 0.1).init(p)
    assert f32["m"][0].dtype == torch.float32


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_bf16_moments_ten_steps_match(param_dtype):
    """Ten steps with bf16 moments against the reference's, from the same
    parameters (fp32, or rounded to bf16 on both sides) and gradients."""
    rng = np.random.default_rng(2)
    tree, grads = _tree_and_grads(rng)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, param_dtype)
    lr = 1e-2
    jopt = JAdamW(j_get_schedule("cosine", lr, 3, 50),
                  moment_dtype="bfloat16")
    topt = TAdamW(t_cosine(lr, 3, 50), moment_dtype="bfloat16")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    js = jopt.init(jp)
    tp = [torch.from_numpy(a.copy()).to(tdt) for a in flatten(tree)]
    ts = topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = topt.update([torch.from_numpy(a) for a in flatten(g)],
                                 ts, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
    for key in ("m", "v"):
        for a, b in zip(ts[key], jax.tree.leaves(js[key])):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            b = np.asarray(b.astype(jnp.float32))
            np.testing.assert_allclose(
                a.float().numpy(), b, rtol=BF16_MOMENT_RTOL,
                atol=BF16_MOMENT_RTOL * float(np.abs(b).max()))
    for a, b in zip(tp, jax.tree.leaves(jp)):
        assert a.dtype == tdt
        b = np.asarray(b.astype(jnp.float32))
        # a bf16 parameter may also round one ulp apart
        atol = BF16_MOMENT_RTOL * lr * 10 + (
            BF16_MOMENT_RTOL * float(np.abs(b).max())
            if param_dtype == "bfloat16" else 0.0)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=atol)
    assert ts["step"] == int(js["step"]) == 10


def _bf16_state(seed):
    """A parameter tree and a bf16-moment AdamW state after 3 steps, on the
    port's side (a list of leaves) and as the reference's trees."""
    rng = np.random.default_rng(seed)
    tree, grads = _tree_and_grads(rng)
    topt = TAdamW(t_cosine(1e-2, 3, 50), moment_dtype="bfloat16")
    tp = [torch.from_numpy(a.copy()) for a in flatten(tree)]
    ts = topt.init(tp)
    for g in grads[:3]:
        tp, ts, _ = topt.update([torch.from_numpy(a) for a in flatten(g)],
                                ts, tp)
    return tree, tp, ts


def _tree_of(tree, leaves):
    from repro_torch.nn.param import unflatten
    return unflatten(tree, leaves)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_bf16_moments_checkpoint_across_the_packages(tmp_path, direction):
    """bf16 moments saved by one package's ``Checkpointer`` restore into
    the other's bf16 state bitwise (numpy has no bf16: both keep them as
    float32 on disk and cast back to the ``like`` tree's dtype)."""
    from repro.checkpoint.checkpointing import Checkpointer as JCkpt

    from repro_torch.checkpoint.checkpointing import Checkpointer
    tree, tp, ts = _bf16_state(4)
    params = _tree_of(tree, tp)
    opt = {"m": _tree_of(tree, ts["m"]), "v": _tree_of(tree, ts["v"]),
           "step": ts["step"]}
    jopt = JAdamW(lambda s: 0.0, moment_dtype="bfloat16")
    j_like = jax.tree.map(jnp.asarray, tree)
    j_like_opt = jopt.init(j_like)
    if direction == "port_to_reference":
        Checkpointer(str(tmp_path)).save(3, params, opt, blocking=True)
        got = JCkpt(str(tmp_path)).restore(3, j_like, j_like_opt)
        for name in ("m", "v"):
            leaves = jax.tree.leaves(got["opt"][name])
            assert all(a.dtype == jnp.bfloat16 for a in leaves)
            for a, b in zip(leaves, ts[name]):
                np.testing.assert_array_equal(
                    np.asarray(a.astype(jnp.float32)), b.float().numpy())
        assert int(got["opt"]["step"]) == 3
    else:
        j_params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
        j_opt = {name: jax.tree.map(
            lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16),
            opt[name]) for name in ("m", "v")}
        j_opt["step"] = jnp.asarray(3, jnp.int32)
        JCkpt(str(tmp_path)).save(3, j_params, j_opt, blocking=True)
        like_opt = {"m": _tree_of(tree, [torch.zeros_like(t) for t in
                                         ts["m"]]),
                    "v": _tree_of(tree, [torch.zeros_like(t) for t in
                                         ts["v"]]),
                    "step": 0}
        got = Checkpointer(str(tmp_path)).restore(3, params, like_opt)
        for name in ("m", "v"):
            for a, b in zip(flatten(got["opt"][name]), ts[name]):
                assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert got["opt"]["step"] == 3


@pytest.mark.gpu
def test_adamw_bf16_moments_on_card_match_the_cpu():
    """Ten bf16-moment steps on the card against the same steps on the
    CPU: the same fp32 arithmetic elementwise, so the moments within one
    bf16 ulp's tolerance and the parameters as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    tree, grads = _tree_and_grads(rng)
    out = {}
    for dev in ("cpu", "cuda"):
        opt = TAdamW(t_cosine(1e-2, 3, 50), moment_dtype="bfloat16")
        tp = [torch.from_numpy(a.copy()).to(dev) for a in flatten(tree)]
        ts = opt.init(tp)
        for g in grads:
            tp, ts, _ = opt.update(
                [torch.from_numpy(a).to(dev) for a in flatten(g)], ts, tp)
        out[dev] = (tp, ts)
    (p_cpu, s_cpu), (p_card, s_card) = out["cpu"], out["cuda"]
    for name in ("m", "v"):
        for a, b in zip(s_card[name], s_cpu[name]):
            assert a.dtype == torch.bfloat16
            b = b.float().numpy()
            np.testing.assert_allclose(
                a.float().cpu().numpy(), b, rtol=BF16_MOMENT_RTOL,
                atol=BF16_MOMENT_RTOL * float(np.abs(b).max()))
    for a, b in zip(p_card, p_cpu):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=BF16_MOMENT_RTOL * 1e-2 * 10)

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

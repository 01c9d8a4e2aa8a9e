"""The port's gradient compression (``repro_torch.distributed.compression``)
against ``repro.distributed.compression``: int8 quantization with error
feedback, on the same seeded numpy inputs, bit for bit (both divide in
fp32 and round half to even); the reference's own properties (the bounded
round trip, the unbiased long run, the payload's size); and a
``grad_compression=True`` trainer at p = 1 and 2 against the reference's,
held as ``test_torch_trainer`` holds the trainers without it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn import GNNModelConfig as JCfg
from repro.core.trainer import SyncGNNTrainer as JTrainer
from repro.distributed import compression as jc
from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.distributed import compression as tc
from test_torch_trainer import G, SMALL, _check_three_iterations


def _inputs(seed, n):
    """Gradient-like vectors over eleven decades; a quarter of the entries
    lie at half-integer multiples of max|g| / 127, next to the rounding's
    ties."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 3)).astype(
        np.float32)
    s = np.abs(g).max() / np.float32(127.0)
    k = rng.integers(-100, 100, n // 4) + np.float32(0.5)
    g[:n // 4] = (k * s).astype(np.float32)
    return g


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("n", [1, 7, 1000, 65_536])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_matches_reference_bitwise(seed, n):
    g = _inputs(seed, n)
    jq, js = jc.compress(jnp.asarray(g))
    tq, ts = tc.compress(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(
        _bits(tc.decompress(tq, ts).numpy()),
        _bits(jc.decompress(jq, js)))


def test_compress_of_zeros_matches_reference():
    g = np.zeros(16, np.float32)
    jq, js = jc.compress(jnp.asarray(g))
    tq, ts = tc.compress(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_tree_with_feedback_matches_reference(seed):
    """Five steps of a dict tree and of the trainer's list form: payload,
    error and decompressed tree bit for bit, and the payload's bytes."""
    shapes = {"w": (33, 17), "b": (17,), "eps": ()}
    rng = np.random.default_rng(seed)
    jerr = terr = lerr = None
    for _ in range(5):
        g = {k: np.asarray(rng.standard_normal(s) * 1e-3, np.float32)
             for k, s in shapes.items()}
        jp, jerr = jc.compress_tree({k: jnp.asarray(v) for k, v in g.items()},
                                    jerr)
        tp, terr = tc.compress_tree({k: torch.from_numpy(v)
                                     for k, v in g.items()}, terr)
        lp, lerr = tc.compress_tree([torch.from_numpy(g[k]) for k in shapes],
                                    lerr)
        for i, k in enumerate(shapes):
            for got in (tp[k], lp[i]):
                np.testing.assert_array_equal(got[0].numpy(),
                                              np.asarray(jp[k][0]))
                np.testing.assert_array_equal(_bits(got[1].numpy()),
                                              _bits(jp[k][1]))
            for got in (terr[k], lerr[i]):
                np.testing.assert_array_equal(_bits(got.numpy()),
                                              _bits(jerr[k]))
        jd, td = jc.decompress_tree(jp), tc.decompress_tree(tp)
        for k in shapes:
            np.testing.assert_array_equal(_bits(td[k].numpy()),
                                          _bits(jd[k]))
        assert tc.payload_bytes(tp) == jc.payload_bytes(jp)
        assert tc.payload_bytes(lp) == jc.payload_bytes(jp)


def test_compression_roundtrip_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    q, s = tc.compress(g)
    assert q.dtype == torch.int8
    assert float((tc.decompress(q, s) - g).abs().max()) <= float(s) * 0.51


def test_error_feedback_unbiased_longrun():
    """With a constant gradient, error feedback makes the cumulative
    applied update converge to the true cumulative gradient."""
    g = torch.tensor([0.003, -0.7, 0.11])
    err, applied = None, torch.zeros(3)
    for _ in range(200):
        payload, err = tc.compress_tree({"w": g}, err)
        applied = applied + tc.decompress_tree(payload)["w"]
    np.testing.assert_allclose((applied / 200).numpy(), g.numpy(),
                               atol=1e-3)


def test_payload_is_4x_smaller():
    payload, _ = tc.compress_tree({"w": torch.zeros(256, 256)}, None)
    assert tc.payload_bytes(payload) < 256 * 256 * 4 / 3.9


@pytest.mark.parametrize("p", [1, 2])
def test_trainer_with_compression_matches_reference(p):
    jt = JTrainer(G, JCfg("graphsage", aggregate_backend="pallas_edges",
                          **SMALL), num_devices=p, algorithm="distdgl",
                  pipeline=False, grad_compression=True)
    tt = TTrainer(G, TCfg("graphsage", aggregate_backend="pallas_edges",
                          **SMALL), num_devices=p, algorithm="distdgl",
                  device="cpu", grad_compression=True,
                  params=jax.tree.map(np.asarray, jt.params))
    _check_three_iterations(jt, tt)
    # the error feedback carries one fp32 tensor a parameter
    assert [e.shape for e in tt._err] == [q.shape for q in
                                          jax.tree.leaves(jt.params)]

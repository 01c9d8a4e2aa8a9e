"""The port's checkpoints (``repro_torch.checkpoint.checkpointing``) and its
mid-epoch resume (``SyncGNNTrainer(checkpointer=, checkpoint_every=)``,
``restore_checkpoint``, ``run_epoch(resume=True)``) against the
reference's ``repro.checkpoint.checkpointing`` and trainer, on the CPU.

Held here:

* the format: a round trip is bitwise (a bfloat16 leaf is kept as float32
  and comes back as bfloat16, the optimizer's step as a 0-d int32), the
  names are the reference's key paths, ``keep`` retention, a ``latest``
  pointer that never moves backwards, a truncated npz, a flipped array
  byte and an edited manifest each falling back to the previous step, the
  error when none verifies, and a rank's own manifest beside rank 0's
  arrays;
* across the packages, both ways: a reference ``Checkpointer`` holding an
  ``AdamW`` (or ``SGDM``) state restores into the port bitwise, and a port
  checkpoint into the reference, under the same names;
* a reference trainer and a port trainer from one seed with
  ``checkpoint_every=1`` write the same ``extra`` at every step, the
  cache's counter, resident sets, generation and pending ranking
  included;
* a port trainer resumed from a reference trainer's mid-epoch checkpoint
  ends within rtol 1e-5 / atol 1e-6 of the reference's own resumed run;
* a killed-and-resumed port run is bitwise its uninterrupted run, at 0
  and 2 sampler workers, sequential and pipelined, without the cache and
  with it refreshed at epoch boundaries (K = 0) and every 2 iterations
  (K = 2), for DistDGL on ``"pallas_fused"`` and ``"reference"`` and for
  P3, and resident; a restore into a trainer whose pool is live reaches
  the pool's shared segment.

The "kill" is a fresh trainer that sees only what is on disk: it restores
the checkpoint taken at the second iteration of epoch 2 (as the
reference's ``tests/test_fault_tolerance.py`` does) and finishes the
epoch. The reference is imported inside the tests that use it.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointing import (Checkpointer,
                                                   flatten_with_paths)
from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.data.graphs import synthetic_graph
from repro_torch.nn.param import flatten, params_from_numpy, unflatten
from repro_torch.optim.adam import SGDM as TSGDM
from repro_torch.optim.adam import AdamW as TAdamW
from repro_torch.optim.schedules import get_schedule as t_get_schedule
from torch_mesh_jobs import kill_and_resume, mid_epoch_step

G = synthetic_graph(scale=8, edge_factor=5, feat_dim=8, num_classes=4)
GRAPH = dict(scale=8, edge_factor=5, feat_dim=8, num_classes=4)
SMALL = dict(num_layers=2, hidden=8, fanouts=(3, 2), batch_targets=4)
RTOL, ATOL = 1e-5, 1e-6
# the cache over the 256 vertices at p = 2, a refresh every K iterations
CACHE = {"none": {}, "k0": dict(cache_capacity=24, cache_refresh_every=0),
         "k2": dict(cache_capacity=24, cache_refresh_every=2)}


def _same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(a, b)) and len(a) == len(b)


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

def _state(seed: int = 0):
    """A GNN-shaped parameter tree (GIN's 0-d eps and a bfloat16 leaf
    among them) and an AdamW state as the reference's tree."""
    g = torch.Generator().manual_seed(seed)
    params = {"layers": [
        {"eps": torch.randn((), generator=g),
         "w1": torch.randn(6, 4, generator=g),
         "b1": torch.randn(4, generator=g).to(torch.bfloat16)},
        {"w": torch.randn(4, 3, generator=g), "b": torch.zeros(3)}]}
    leaves = flatten(params)
    opt = {"m": unflatten(params, [torch.randn(p.shape, generator=g)
                                   for p in leaves]),  # float32 moments
           "v": unflatten(params, [torch.rand(p.shape, generator=g)
                                   for p in leaves]),
           "step": np.int32(3 + seed)}
    return params, opt


def _like(params, opt):
    def zeros(tree):
        return unflatten(tree, [torch.zeros_like(p) for p in flatten(tree)])
    return zeros(params), {"m": zeros(opt["m"]), "v": zeros(opt["v"]),
                           "step": 0}


def test_round_trip_bitwise_under_the_reference_names(tmp_path):
    params, opt = _state()
    ck = Checkpointer(str(tmp_path))
    extra = {"iter_no": 7, "samplers": [{"epoch": 1, "cursor": 8}]}
    ck.save(7, params, opt, extra=extra, blocking=True)
    out = ck.restore(7, *_like(params, opt))
    assert out["step"] == 7 and out["extra"] == extra
    assert _same(flatten(out["params"]), flatten(params))
    assert _same(flatten(out["opt"]["m"]), flatten(opt["m"]))
    assert _same(flatten(out["opt"]["v"]), flatten(opt["v"]))
    assert out["opt"]["step"] == 3 and type(out["opt"]["step"]) is int
    with np.load(tmp_path / "ckpt_00000007.npz") as z:
        names = set(z.files)
        assert z["opt/step"].dtype == np.int32 and z["opt/step"].shape == ()
        assert z["params/layers/0/b1"].dtype == np.float32
    assert "params/layers/0/eps" in names and "opt/v/layers/1/w" in names
    assert names == set(flatten_with_paths({"params": params, "opt": opt}))
    rec = ck.saves[0]
    assert rec["bytes"] == (os.path.getsize(tmp_path / "ckpt_00000007.npz")
                            + os.path.getsize(tmp_path / "ckpt_00000007.json"))
    assert rec["snapshot_s"] >= 0 and rec["write_s"] >= 0


def test_retention_and_a_latest_pointer_that_never_moves_back(tmp_path):
    params, _ = _state()
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in (1, 2, 5, 3):  # a slow older save lands last
        ck.save(step, params, blocking=True)
    with open(tmp_path / "latest.json") as f:
        assert json.load(f)["step"] == 5
    assert ck.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000003.json", "ckpt_00000003.npz", "ckpt_00000005.json",
        "ckpt_00000005.npz", "latest.json"]


def _tear(path, how):
    npz, meta = path + ".npz", path + ".json"
    if how == "truncated":
        with open(npz, "r+b") as fh:
            fh.truncate(os.path.getsize(npz) // 2)
    elif how == "flipped":
        data = dict(np.load(npz))
        data["params/layers/1/w"] = data["params/layers/1/w"] + 1.0
        np.savez(npz, **data)
    else:
        with open(meta) as fh:
            m = json.load(fh)
        m["extra"]["iter_no"] = 99
        with open(meta, "w") as fh:
            json.dump(m, fh)


@pytest.mark.parametrize("how", ["truncated", "flipped", "manifest"])
def test_a_torn_newest_checkpoint_falls_back(tmp_path, how):
    p1, o1 = _state(1)
    p2, o2 = _state(2)
    ck = Checkpointer(str(tmp_path), keep=10)
    ck.save(1, p1, o1, extra={"iter_no": 1}, blocking=True)
    ck.save(2, p2, o2, extra={"iter_no": 2}, blocking=True)
    assert ck.latest_step() == 2
    _tear(str(tmp_path / "ckpt_00000002"), how)
    assert ck.latest_step() == 1
    out = ck.restore(2, *_like(p1, o1))
    assert out["step"] == 1 and out["extra"] == {"iter_no": 1}
    assert _same(flatten(out["params"]), flatten(p1))


def test_restore_raises_when_no_checkpoint_verifies(tmp_path):
    params, _ = _state()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, params, blocking=True)
    with open(tmp_path / "ckpt_00000001.npz", "r+b") as fh:
        fh.truncate(10)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(1, params)


def test_rank_manifests_beside_rank_zero_arrays(tmp_path):
    """Rank 1 writes only its manifest: it restores rank 0's arrays with
    its own ``extra``; a rank whose copy of the arrays differs does not
    verify; the reference's step listing ignores the rank files; retention
    removes them with their step."""
    from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
    params, opt = _state()
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(4, params, opt, extra={"rank": 0}, blocking=True)
    ck.save(4, params, opt, extra={"rank": 1}, blocking=True, rank=1)
    assert os.listdir(tmp_path).count("ckpt_00000004.rank1.json") == 1
    assert not os.path.exists(tmp_path / "ckpt_00000004.rank1.npz")
    out = ck.restore(4, *_like(params, opt), rank=1)
    assert out["extra"] == {"rank": 1}
    assert _same(flatten(out["params"]), flatten(params))
    assert ck.latest_step(rank=1) == 4
    other, _ = _state(5)
    ck.save(4, other, opt, extra={"rank": 2}, blocking=True, rank=2)
    assert ck.latest_step(rank=2) is None
    assert JCheckpointer(str(tmp_path))._candidate_steps() == [4]
    ck.save(6, params, opt, blocking=True)
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000006.json", "ckpt_00000006.npz", "latest.json"]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _reference_state(opt_name, steps=3):
    """GIN's reference parameters after ``steps`` updates of AdamW or
    SGDM from random gradients, and the optimizer."""
    import jax
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.gnn import models as jm
    from repro.nn.param import materialize
    from repro.optim.adam import SGDM, AdamW
    from repro.optim.schedules import get_schedule
    spec = jm.param_spec(JCfg("gin", **SMALL), 8, 4)
    jp = materialize(spec, jax.random.PRNGKey(3))
    schedule = get_schedule("cosine", 1e-2, 10, 100_000)
    opt = (AdamW(schedule, weight_decay=0.0) if opt_name == "adam"
           else SGDM(schedule))
    js = opt.init(jp)
    rng = np.random.default_rng(4)
    for _ in range(steps):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), jp)
        jp, js, _ = opt.update(g, js, jp)
    return jp, js, opt


def _port_like(jp, opt_name):
    """The port's trees of the reference's shapes: parameters, and the
    optimizer state in the reference's tree form (what the trainer
    saves)."""
    import jax
    tp = params_from_numpy(jax.tree.map(np.zeros_like, jp), "cpu")
    opt = (TAdamW(t_get_schedule("cosine", 1e-2, 10, 100_000))
           if opt_name == "adam"
           else TSGDM(t_get_schedule("cosine", 1e-2, 10, 100_000)))
    state = opt.init(flatten(tp))
    tree = {k: unflatten(tp, v) for k, v in state.items() if k != "step"}
    tree["step"] = state["step"]
    return tp, tree, opt


@pytest.mark.parametrize("opt_name", ["adam", "sgdm"])
def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path,
                                                             opt_name):
    import jax
    from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
    jp, js, _ = _reference_state(opt_name)
    JCheckpointer(str(tmp_path)).save(3, jp, js, extra={"iter_no": 3},
                                      blocking=True)
    tp, tree, _ = _port_like(jp, opt_name)
    out = Checkpointer(str(tmp_path)).restore(3, tp, tree)
    assert out["step"] == 3 and out["extra"] == {"iter_no": 3}
    got = flatten(out["params"])
    for a, b in zip(got, jax.tree.leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b).view(np.uint32))
    assert out["opt"]["step"] == int(js["step"]) == 3
    for k in ("m", "v") if opt_name == "adam" else ("m",):
        for a, b in zip(flatten(out["opt"][k]), jax.tree.leaves(js[k])):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          np.asarray(b).view(np.uint32))
    # the port's optimizer takes the restored state as its own
    opt = _port_like(jp, opt_name)[2]
    state = {k: (v if k == "step" else flatten(v))
             for k, v in out["opt"].items()}
    opt.update([torch.ones_like(p) for p in got], state, got)


@pytest.mark.parametrize("opt_name", ["adam", "sgdm"])
def test_port_checkpoint_restores_into_the_reference_bitwise(tmp_path,
                                                             opt_name):
    import jax
    from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
    jp, js, _ = _reference_state(opt_name, steps=0)
    tp, _, opt = _port_like(jp, opt_name)
    g = torch.Generator().manual_seed(5)
    leaves = [torch.randn(p.shape, generator=g) for p in flatten(tp)]
    state = opt.init(leaves)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g) for p in leaves]
        leaves, state, _ = opt.update(grads, state, leaves)
    tp = unflatten(tp, leaves)
    tree = {k: unflatten(tp, v) for k, v in state.items() if k != "step"}
    tree["step"] = np.int32(state["step"])
    Checkpointer(str(tmp_path / "port")).save(3, tp, tree, blocking=True)
    out = JCheckpointer(str(tmp_path / "port")).restore(3, jp, js)
    assert out["step"] == 3 and int(out["opt"]["step"]) == 3
    assert out["opt"]["step"].dtype == np.int32
    for a, b in zip(jax.tree.leaves(out["params"]), leaves):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      b.numpy().view(np.uint32))
    for k in ("m", "v") if opt_name == "adam" else ("m",):
        for a, b in zip(jax.tree.leaves(out["opt"][k]), state[k]):
            np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                          b.numpy().view(np.uint32))
    # the reference writes the same names for the same trees
    JCheckpointer(str(tmp_path / "ref")).save(3, jp, js, blocking=True)
    with np.load(tmp_path / "port" / "ckpt_00000003.npz") as a, \
            np.load(tmp_path / "ref" / "ckpt_00000003.npz") as b:
        assert set(a.files) == set(b.files)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

def _manifests(directory):
    out = {}
    for f in sorted(os.listdir(directory)):
        if f.startswith("ckpt_") and f.endswith(".json") and "rank" not in f:
            with open(os.path.join(directory, f)) as fh:
                meta = json.load(fh)
            out[meta["step"]] = meta["extra"]
    return out


def _reference_trainer(directory, cache="none", **kw):
    from repro.checkpoint.checkpointing import Checkpointer as JCheckpointer
    from repro.configs.gnn import GNNModelConfig as JCfg
    from repro.core.trainer import SyncGNNTrainer as JTrainer
    from repro.data.graphs import synthetic_graph as j_graph
    return JTrainer(j_graph(**GRAPH),
                    JCfg("graphsage", aggregate_backend="reference",
                         **SMALL),
                    num_devices=2, seed=11, pipeline=False,
                    checkpointer=JCheckpointer(directory, keep=1000),
                    **CACHE[cache], **kw)


def _port_trainer(directory, cache="none", backend="reference", **kw):
    return TTrainer(G, TCfg("graphsage", aggregate_backend=backend, **SMALL),
                    num_devices=2, seed=11, device="cpu",
                    checkpointer=Checkpointer(directory, keep=1000),
                    **CACHE[cache], **kw)


def test_reference_and_port_trainers_write_the_same_extra(tmp_path):
    """Two epochs with the cache refreshed every 2 iterations, a
    checkpoint every iteration: every step's ``extra`` is equal (the
    port's initial parameters are its own; the host state does not depend
    on them)."""
    with _reference_trainer(str(tmp_path / "ref"), "k2",
                            checkpoint_every=1) as jt:
        jt.train(2)
        jt.checkpointer.wait()
    with _port_trainer(str(tmp_path / "port"), "k2",
                       checkpoint_every=1, pipeline=False) as tt:
        ms = tt.train(2)
        tt.checkpointer.wait()
    want, got = (_manifests(str(tmp_path / d)) for d in ("ref", "port"))
    assert len(got) == sum(m["iterations"] for m in ms) and got == want
    assert any(e["cache"]["pending"] is not None for e in got.values())
    assert got[max(got)]["cache"]["generation"] > 0


@pytest.mark.parametrize("cache", ["none", "k2"])
def test_port_resumes_a_reference_midepoch_checkpoint(tmp_path, cache):
    """The reference checkpoints every iteration over two epochs; from its
    epoch-2 second-iteration checkpoint the reference and the port each
    finish the epoch: the port restores the reference's arrays bitwise and
    ends within rtol 1e-5 / atol 1e-6 of the reference."""
    import jax
    d = str(tmp_path)
    with _reference_trainer(d, cache, checkpoint_every=1) as jt:
        m1 = jt.run_epoch()
        jt.run_epoch()
        jt.checkpointer.wait()
    step = mid_epoch_step(d, m1["iterations"])
    with _reference_trainer(d, cache) as jr:
        jr.restore_checkpoint(step)
        restored = [np.asarray(a) for a in jax.tree.leaves(jr.params)]
        jr.run_epoch(resume=True)
        want = [np.asarray(a) for a in jax.tree.leaves(jr.params)]
    with _port_trainer(d, cache) as tr:
        assert tr.restore_checkpoint(step) == step == tr.step_no
        assert tr._epoch_iter == 2
        for a, b in zip(flatten(tr.params), restored):
            np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                          b.view(np.uint32))
        tr.run_epoch(resume=True)
        for a, b in zip(flatten(tr.params), want):
            np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
        if cache != "none":
            assert tr.cache.generation == jr.cache.generation
            np.testing.assert_array_equal(tr.cache.freq, jr.cache.freq)


def _kill_and_resume(tmp_path, workers, cache, backend, algo, **kw):
    """``kill_and_resume``: the (uninterrupted, resumed) trainers."""
    d = str(tmp_path)
    kw = dict(kw, algorithm=algo, num_sampler_workers=workers)
    if workers and cache == "k2":
        kw["gather_in_workers"] = True
    r = kill_and_resume(
        lambda **extra: _port_trainer(d, cache, backend, **kw, **extra), d,
        lambda tr: tr)
    return r["twin"], r["resumed"]


def _cache_state(tr):
    c = tr.cache
    return (c.freq.tolist(), c.generation, c.refreshes,
            [c.core.resident_ids(d).tolist()
             for d in range(c.core.num_devices)])


# (workers, pipeline, cache, backend, algorithm, extra trainer keywords)
RESUME_CASES = [
    (w, pipe, cache, backend, "distdgl", {})
    for w in (0, 2)
    for backend in ("pallas_fused", "reference")
    for cache in ("none", "k0", "k2")
    for pipe in (False, True)
] + [(w, pipe, "none", "pallas_fused", "p3", {})
     for w in (0, 2) for pipe in (False, True)] + [
    (0, True, "k0", "pallas_fused", "distdgl", dict(data_parallel=True)),
    (0, False, "none", "pallas_fused", "p3", dict(data_parallel=True)),
    (0, True, "none", "reference", "distdgl", dict(optimizer_name="sgdm")),
]


@pytest.mark.parametrize(
    "workers,pipeline,cache,backend,algo,kw", RESUME_CASES,
    ids=[f"w{w}-{'pipe' if p else 'seq'}-{c}-{b}-{a}"
         + "".join(f"-{k}" for k in kw)
         for w, p, c, b, a, kw in RESUME_CASES])
def test_killed_run_resumes_bitwise(tmp_path, workers, pipeline, cache,
                                    backend, algo, kw):
    full, resumed = _kill_and_resume(tmp_path, workers, cache, backend,
                                     algo, pipeline=pipeline, **kw)
    assert _same(flatten(resumed.params), flatten(full.params))
    for k in full.opt_state:
        if k == "step":
            assert resumed.opt_state[k] == full.opt_state[k]
        else:
            assert _same(resumed.opt_state[k], full.opt_state[k])
    assert resumed.step_no == full.step_no
    assert resumed._iter_no == full._iter_no
    if full.cache is not None:
        assert _cache_state(resumed) == _cache_state(full)
        if cache == "k2":
            assert full.cache.generation > 1


def test_restore_reaches_a_live_pools_shared_segment(tmp_path):
    """A trainer whose pool already runs (one epoch at generation 0)
    restores a checkpoint of generation 1 taken mid-epoch 2: the generation
    and the resident sets reach the pool's shared segment before any task
    of the resumed epoch is submitted, and the run ends bitwise the
    uninterrupted one."""
    d = str(tmp_path)
    kw = dict(num_sampler_workers=2, gather_in_workers=True)
    with _port_trainer(d, "k0", "pallas_fused", checkpoint_every=1) as full:
        m1 = full.run_epoch()
        full.run_epoch()
        full.checkpointer.wait()
    step = mid_epoch_step(d, m1["iterations"])
    with _port_trainer(d, "k0", "pallas_fused", **kw) as tr:
        tr.run_epoch()
        mirror = tr.store.core._shared_mirror
        assert mirror is not None and int(mirror._meta[0]) == 0
        tr.restore_checkpoint(step)
        assert int(mirror._meta[0]) == tr.cache.generation == 1
        for dev in range(2):
            ids = tr.store.core.resident_ids(dev)
            lo = mirror._offsets[dev]
            assert int(mirror._meta[1 + dev]) == len(ids)
            np.testing.assert_array_equal(mirror._cat[lo:lo + len(ids)], ids)
        tr.run_epoch(resume=True)
        assert _same(flatten(tr.params), flatten(full.params))
        assert _cache_state(tr) == _cache_state(full)


@pytest.mark.gpu
def test_snapshot_of_card_tensors_follows_the_queued_step(tmp_path):
    """On the card: ``save`` returns at once while the step that produces
    the tensors is still queued, and the checkpoint holds that step's
    values (the copies are queued on the same stream, behind it), bitwise;
    the restore puts them back on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4096, 4096, device="cuda", generator=g)
    params = {"layers": [{"w": x}]}
    for _ in range(8):  # a few ms of queued work that rewrites w
        params = {"layers": [{"w": (params["layers"][0]["w"] @ x)
                              .div_(4096 ** 0.5)}]}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, params, {"step": np.int32(1)})
    want = params["layers"][0]["w"].cpu()
    out = ck.restore(1, params, {"step": 0})
    got = out["params"]["layers"][0]["w"]
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert ck.saves[0]["snapshot_s"] < ck.saves[0]["write_s"]

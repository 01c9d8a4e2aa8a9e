"""The port's data parallelism over ranks (``SyncGNNTrainer(mesh=...)``)
against its one-process ``data_parallel=True`` trainer and against the
reference's mesh step, on the CPU with gloo.

Ranks are spawned processes (``spawn_data_parallel(devices=["cpu"] *
p)``, a file rendezvous under ``tmp_path``), one launch at each p running
every configuration in turn (``torch_mesh_jobs.rank_jobs``); the test
process runs the same jobs on one device, both with one intra-op thread,
so their float sums split alike. Held here:

* the mesh helpers raise as the reference's do;
* at p = 2 and 4, for DistDGL, PaGraph and P3 on ``"reference"``,
  ``"pallas_edges"`` and ``"pallas_fused"`` (their plain versions here),
  three iterations' losses and the final parameters equal the one-process
  run's bit for bit on every rank; each rank holds only its own shard (P3:
  its slice), samples only its slot's batch and runs only its slot's step;
* a sequential, a pipelined and a ``"load"`` epoch equal the one-process
  epoch in every key that holds no time (``beta`` and the miss accounting
  among them) and in the parameters, and pipelined equals sequential; so
  do epochs whose idle slots run weight-0 fills; at p = 2, 2 sampler
  workers a rank (sampling, and gathering) equal 0;
* at p = 2 two DistDGL epochs with the feature cache (refresh at the
  epoch boundary) equal the one-process run's, the cache's keys, its
  counter (each rank counts its own slot, the ranks sum at the epoch's
  end), resident sets and generation included; the same epochs
  checkpointed every iteration and resumed mid-epoch 2 are bitwise the
  uninterrupted run on every rank, rank 1 from a manifest of its own,
  and with rank 1's newest manifest torn the ranks agree on the step
  before it;
* ``p3_all_to_all_feats`` equals ``assemble_p3_feats`` and
  ``FeatureStore.gather_p3_full`` bit for bit;
* at p = 2 the mesh run stays within rtol 1e-5 (losses) of the
  reference's own mesh step (``data_parallel=True`` on two forced host
  devices, in a subprocess) over three iterations from its initial
  parameters, the parameters held as ``test_torch_resident`` holds them.
"""
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.gnn import GNNModelConfig as TCfg
from repro_torch.core.trainer import SyncGNNTrainer as TTrainer
from repro_torch.distributed.launch import spawn_data_parallel
from repro_torch.distributed.sharding import (all_gather_flat,
                                              make_data_mesh,
                                              require_data_axis)
from torch_mesh_jobs import GRAPH, SMALL, graph, rank_jobs, run_job

ROOT = os.path.join(os.path.dirname(__file__), "..")
ALGOS = ("distdgl", "pagraph", "p3")
BACKENDS = ("reference", "pallas_edges", "pallas_fused")
ITERATIONS = 3
RTOL = 1e-5
# the cache of the mesh's cached run: a quarter of a device's static share
# at p = 2, refreshed at the epoch boundary
CACHE_KW = dict(cache_capacity=256, cache_refresh_every=0)
# the epoch keys every run reports alike, with or without sampler workers
ACCOUNTING = ("loss", "acc", "beta", "miss_bytes", "miss_bytes_per_iter",
              "cache_hit_rate", "vertices_traversed", "iterations",
              "fill_slots")


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    """This process as the one rank of a gloo group."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_without_a_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="spawn_data_parallel"):
        make_data_mesh(2, "cpu")


def test_mesh_larger_than_the_group_raises(world_of_one):
    with pytest.raises(ValueError, match="default process group has 1"):
        make_data_mesh(2, "cpu")


def test_mesh_axis_extent_mismatch_raises(world_of_one):
    mesh = make_data_mesh(1, "cpu")
    with pytest.raises(ValueError, match="does not match"):
        TTrainer(graph(), TCfg("graphsage", **SMALL), num_devices=2,
                 mesh=mesh, device="cpu")


def test_mesh_without_data_axis_raises(world_of_one):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    with pytest.raises(ValueError, match="'data' axis"):
        TTrainer(graph(), TCfg("graphsage", **SMALL), num_devices=1,
                 mesh=mesh, device="cpu")


def test_require_data_axis_ok(world_of_one):
    require_data_axis(make_data_mesh(1, "cpu"), 1)


def test_mesh_device_of_another_type_raises(world_of_one):
    with pytest.raises(ValueError, match="device type"):
        TTrainer(graph(), TCfg("graphsage", **SMALL), num_devices=1,
                 mesh=make_data_mesh(1, "cuda"), device="cpu")


@pytest.mark.parametrize("name", ["all_gather_single",
                                  "all_gather_into_tensor"])
def test_all_gather_flat_takes_the_installed_name(world_of_one, monkeypatch,
                                                  name):
    """``all_gather_single`` where PyTorch has it (2.13 on), else its older
    name ``all_gather_into_tensor``."""
    calls = []
    real = dist.all_gather_into_tensor
    monkeypatch.setattr(dist, name, lambda out, inp, group=None: (
        calls.append(name), real(out, inp, group=group)))
    if name == "all_gather_into_tensor":
        monkeypatch.delattr(dist, "all_gather_single", raising=False)
    inp = torch.arange(5, dtype=torch.float32)
    out = torch.full((5,), -1.0)
    all_gather_flat(out, inp)
    assert calls == [name] and torch.equal(out, inp)


def test_mesh_implies_the_resident_path(world_of_one):
    with TTrainer(graph(), TCfg("graphsage", **SMALL), num_devices=1,
                  mesh=make_data_mesh(1, "cpu"), device="cpu") as tr:
        assert tr.data_parallel and tr._rank == 0
        assert tr.run_epoch()["mesh_devices"] == 1


def test_launcher_refuses_what_it_cannot_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="devices="):
        spawn_data_parallel(rank_jobs, 2)
    with pytest.raises(ValueError, match="nccl"):
        spawn_data_parallel(rank_jobs, 2, backend="nccl",
                            devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="all be cuda or all cpu"):
        spawn_data_parallel(rank_jobs, 2, devices=["cpu", "cuda:0"])


def _fail_on_rank_one(rank, mesh, device):
    if rank == 1:
        raise RuntimeError("rank one fails")
    time.sleep(300)  # left running: the launch must end it
    return rank


def test_a_rank_exception_fails_the_launch(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank one fails"):
        spawn_data_parallel(_fail_on_rank_one, 2, devices=["cpu"] * 2,
                            init_file=str(tmp_path / "rdv"), timeout_s=60)
    assert time.monotonic() - t0 < 120


# ---------------------------------------------------------------------------
# the reference's mesh step, in a subprocess with two host devices
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import json, sys
import jax
import numpy as np
from repro.configs.gnn import GNNModelConfig
from repro.core import scheduler as sched
from repro.core.trainer import SyncGNNTrainer
from repro.data.graphs import synthetic_graph

out, small, graph = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
small["fanouts"] = tuple(small["fanouts"])
for algo in ("distdgl", "p3"):
    jt = SyncGNNTrainer(synthetic_graph(**graph),
                        GNNModelConfig("graphsage",
                                       aggregate_backend="pallas_edges",
                                       **small),
                        num_devices=2, algorithm=algo, pipeline=False,
                        data_parallel=True)
    assert jt.mesh is not None and jt.mesh.shape["data"] == 2
    arrays = {f"init/{l}/{k}": np.asarray(v)
              for l, layer in enumerate(jt.params["layers"])
              for k, v in layer.items()}
    groups = list(sched.iterations(jt.epoch_schedule()))[:3]
    steps = [jt.run_iteration(g) for g in groups]
    arrays["losses"] = np.array([m["loss"] for m in steps], np.float64)
    arrays["lrs"] = np.array([m["lr"] for m in steps], np.float64)
    for i, leaf in enumerate(jax.tree.leaves(jt.params)):
        arrays[f"final/{i}"] = np.asarray(leaf)
    np.savez(f"{out}/{algo}.npz", **arrays)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{algo: the reference's initial parameters (the port's nested form),
    three losses and learning rates and its final parameter leaves}."""
    out = tmp_path_factory.mktemp("reference_mesh")
    env = dict(os.environ,
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(out), json.dumps(SMALL),
         json.dumps(GRAPH)], env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    refs = {}
    for algo in ("distdgl", "p3"):
        z = np.load(out / f"{algo}.npz")
        layers = {}
        for k in z.files:
            if k.startswith("init/"):
                _, l, name = k.split("/")
                layers.setdefault(int(l), {})[name] = z[k]
        refs[algo] = {
            "params": {"layers": [layers[l] for l in sorted(layers)]},
            "losses": z["losses"], "lrs": z["lrs"],
            "final": [z[f"final/{i}"] for i in range(sum(
                k.startswith("final/") for k in z.files))]}
    return refs


# ---------------------------------------------------------------------------
# the ranks against the one-process run
# ---------------------------------------------------------------------------

def _jobs(p, reference=None):
    jobs = {}
    for algo in ALGOS:
        for backend in BACKENDS:
            jobs[f"iterations/{algo}/{backend}"] = dict(
                algo=algo, backend=backend, p=p, kind="iterations",
                n=ITERATIONS)
        for mode, kw in (("sequential", dict(pipeline=False)),
                         ("pipelined", {}),
                         ("load", dict(balance_policy="load"))):
            jobs[f"{mode}/{algo}"] = dict(algo=algo, backend="reference",
                                          p=p, kind="epoch", kw=kw)
    # small batches, no workload balancing: idle slots run weight-0 fills
    for algo in ("distdgl", "p3"):
        jobs[f"fills/{algo}"] = dict(
            algo=algo, backend="reference", p=p, kind="epoch",
            cfg=dict(batch_targets=4), kw=dict(workload_balancing=False))
    jobs["p3_exchange"] = dict(algo="p3", backend="reference", p=p,
                               kind="p3_exchange", n=2)
    if p == 2:
        for algo in ("distdgl", "p3"):
            jobs[f"workers/{algo}"] = dict(
                algo=algo, backend="reference", p=p, kind="epoch",
                kw=dict(num_sampler_workers=2))
        jobs["workers_gather/distdgl"] = dict(
            algo="distdgl", backend="reference", p=p, kind="epoch",
            kw=dict(num_sampler_workers=2, gather_in_workers=True))
        jobs["cache/distdgl"] = dict(algo="distdgl", backend="reference",
                                     p=p, kind="epoch", epochs=2,
                                     kw=CACHE_KW)
        jobs["checkpoint/distdgl"] = dict(algo="distdgl",
                                          backend="reference", p=p,
                                          kind="checkpoint", kw=CACHE_KW)
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory, reference):
    """runs(p) -> (one-process results, each rank's results), each launch
    made once."""
    cache = {}

    def get(p):
        if p not in cache:
            jobs = _jobs(p)
            ckpt_dir = str(tmp_path_factory.mktemp(f"checkpoints_p{p}"))
            for job in jobs.values():
                if job["kind"] == "checkpoint":
                    job["dir"] = ckpt_dir
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                one = {k: run_job(j) for k, j in jobs.items()
                       if not k.startswith("workers")}
            finally:
                torch.set_num_threads(threads)
            if p == 2:
                for algo, ref in reference.items():
                    jobs[f"against_reference/{algo}"] = dict(
                        algo=algo, backend="pallas_edges", p=p,
                        kind="iterations", n=ITERATIONS,
                        params=ref["params"])
            rdv = tmp_path_factory.mktemp(f"rendezvous_p{p}") / "file"
            ranks = spawn_data_parallel(
                functools.partial(rank_jobs, jobs=jobs), p,
                devices=["cpu"] * p, init_file=str(rdv))
            cache[p] = (one, ranks)
        return cache[p]
    return get


def _same_bits(a, b) -> bool:
    return all(x.shape == y.shape and np.array_equal(
        x.view(np.uint32), y.view(np.uint32)) for x, y in zip(a, b))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("p", [2, 4])
def test_iterations_bitwise_the_one_process_run(runs, p, algo, backend):
    one, ranks = runs(p)
    key = f"iterations/{algo}/{backend}"
    want = one[key]
    for rank, res in enumerate(ranks):
        got = res[key]
        assert got["losses"] == want["losses"], (rank, got["losses"])
        assert _same_bits(got["params"], want["params"]), rank
        # each rank: its own shard only, its slot's batch, its slot's step
        assert got["shard_shape"] == want["shard_shape"][1:]
        assert got["shard_is_own_row"]
        n = len(want["groups"])
        assert got["calls"] == {"sampled": n, "slot_steps": n}
    assert want["calls"] == {"sampled": sum(want["groups"]),
                             "slot_steps": p * len(want["groups"])}


@pytest.mark.parametrize("mode", ["sequential", "pipelined", "load"])
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("p", [2, 4])
def test_epoch_bitwise_the_one_process_run(runs, p, algo, mode):
    one, ranks = runs(p)
    key = f"{mode}/{algo}"
    want = one[key]
    assert want["epoch"]["mesh_devices"] == p
    for rank, res in enumerate(ranks):
        got = res[key]
        assert got["epoch"] == want["epoch"], rank
        assert got["stats"] == want["stats"], rank
        assert _same_bits(got["params"], want["params"]), rank
        if mode == "pipelined":
            seq = res[f"sequential/{algo}"]
            assert got["epoch"] == seq["epoch"]
            assert _same_bits(got["params"], seq["params"])
    if algo != "p3":
        assert want["epoch"]["beta"] < 1.0


@pytest.mark.parametrize("algo", ["distdgl", "p3"])
@pytest.mark.parametrize("p", [2, 4])
def test_fill_slots_bitwise_the_one_process_run(runs, p, algo):
    """A rank whose slot is empty runs the group's last batch at weight 0,
    assembled against its own shard, and accounts nothing for it."""
    one, ranks = runs(p)
    want = one[f"fills/{algo}"]
    if (p, algo) != (2, "distdgl"):  # its partitions split evenly
        assert want["epoch"]["fill_slots"] > 0
    for res in ranks:
        got = res[f"fills/{algo}"]
        assert got["epoch"] == want["epoch"]
        assert got["stats"] == want["stats"]
        assert _same_bits(got["params"], want["params"])


@pytest.mark.parametrize("key", ["workers/distdgl", "workers/p3",
                                 "workers_gather/distdgl"])
def test_sampler_workers_equal_none(runs, key):
    _, ranks = runs(2)
    algo = key.split("/")[1]
    for res in ranks:
        got, want = res[key], res[f"pipelined/{algo}"]
        for k in ACCOUNTING:
            assert got["epoch"][k] == want["epoch"][k], k
        assert got["stats"] == want["stats"]
        assert _same_bits(got["params"], want["params"])
        assert got["epoch"]["ring_bytes"] > 0


def test_cache_epochs_bitwise_the_one_process_run(runs):
    """Every rank's two cached epochs, parameters, counter, resident sets
    and generation are the one-process run's; the second epoch ran on the
    admitted set (admissions, a new generation)."""
    one, ranks = runs(2)
    want = one["cache/distdgl"]
    assert want["epochs"][1]["cache_admissions"] > 0
    assert want["cache"]["generation"] == 1
    assert want["epochs"][0]["cache_enabled"]
    for rank, res in enumerate(ranks):
        got = res["cache/distdgl"]
        assert got["epochs"] == want["epochs"], rank
        assert got["stats"] == want["stats"], rank
        assert _same_bits(got["params"], want["params"]), rank
        np.testing.assert_array_equal(got["cache"]["freq"],
                                      want["cache"]["freq"])
        assert got["cache"]["generation"] == want["cache"]["generation"]
        for a, b in zip(got["cache"]["resident"], want["cache"]["resident"]):
            np.testing.assert_array_equal(a, b)


def test_checkpoint_resume_bitwise_the_one_process_run(runs):
    """Two cached epochs checkpointed every iteration, killed and resumed
    from epoch 2's second iteration: on every rank the resumed run is
    bitwise its uninterrupted run and the one-process run (parameters,
    counter, resident sets, generation). Rank 1's host state differs from
    rank 0's (its slot's balancer loads and counts), so it resumes from a
    manifest of its own. With rank 1's newest manifest torn, the ranks
    agree on the step before it."""
    one, ranks = runs(2)
    want = one["checkpoint/distdgl"]
    assert _same_bits(want["resumed"], want["full"])
    for rank, res in enumerate(ranks):
        got = res["checkpoint/distdgl"]
        assert got["step"] == want["step"], rank
        for run in ("full", "resumed"):
            assert _same_bits(got[run], want["full"]), (rank, run)
            c, w = got[f"{run}_cache"], want["full_cache"]
            np.testing.assert_array_equal(c["freq"], w["freq"])
            assert c["generation"] == w["generation"] == 1
            for a, b in zip(c["resident"], w["resident"]):
                np.testing.assert_array_equal(a, b)
        assert got["own_manifest_differs"] is (rank > 0)
        # rank 1's newest manifest torn: every rank resumes from the step
        # before it, and finishes bitwise the uninterrupted run
        assert got["latest_step"] == got["newest_step"] - 1, rank
        assert _same_bits(got["latest"], want["full"]), rank


@pytest.mark.gpu
def test_cached_resident_epochs_on_card_pipelined_bitwise_sequential():
    """On the card: two resident epochs with the cache at p = 2 on
    ``"pallas_fused"`` (the second on the admitted set, its shards
    re-uploaded), pipelined bitwise sequential in every epoch key and the
    parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    job = dict(algo="distdgl", backend="pallas_fused", p=2, kind="epoch",
               epochs=2)
    seq = run_job(dict(job, kw=dict(CACHE_KW, pipeline=False)), "cuda:0")
    pipe = run_job(dict(job, kw=CACHE_KW), "cuda:0")
    assert seq["epochs"] == pipe["epochs"]
    assert seq["epochs"][1]["cache_admissions"] > 0
    assert _same_bits(seq["params"], pipe["params"])
    np.testing.assert_array_equal(seq["cache"]["freq"],
                                  pipe["cache"]["freq"])


@pytest.mark.parametrize("p", [2, 4])
def test_p3_exchange_equals_the_index(runs, p):
    one, ranks = runs(p)
    slots = one["p3_exchange"]["blocks"]
    n = len(slots) // p
    for rank, res in enumerate(ranks):
        blocks = res["p3_exchange"]["blocks"]
        assert len(blocks) == n
        for i, (got, want, gathered) in enumerate(blocks):
            assert got.dtype == np.float32 and got.shape == want.shape
            for other in (want, gathered, slots[i * p + rank][1]):
                np.testing.assert_array_equal(got.view(np.uint32),
                                              other.view(np.uint32))


@pytest.mark.parametrize("algo", ["distdgl", "p3"])
def test_matches_the_reference_mesh_step(runs, reference, algo):
    _, ranks = runs(2)
    ref = reference[algo]
    bound = 2 * float(ref["lrs"].sum())
    for res in ranks:
        got = res[f"against_reference/{algo}"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)
        np.testing.assert_allclose(got["lrs"], ref["lrs"], rtol=1e-6)
        for a, b in zip(got["params"], ref["final"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=bound)
            close = np.isclose(a, b, rtol=1e-4, atol=1e-5)
            assert close.mean() > 0.99, close.mean()

"""The port's ``HitGNN`` facade (paper Table 2 / Listing 1 flow,
``repro_torch.core.abstraction``) on the CPU: the reference's two API tests
run on the port with ``device="cpu"``; the design's FPGA entry and
``PlatformConfig.to_metadata()`` against the reference's; ``Start_training``
from the reference trainer's seeded initial parameters against the
reference's ``HitGNN`` on the same graph (the schedule and vertices
traversed equal, the losses within the trainer tests' rtol); the facade's
epoch bitwise a directly built trainer's; ``Save_model``'s npz with the
reference's keys and shapes and the trainer's parameters; and the device
rule. The reference is imported inside the tests that use it."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointing import (Checkpointer,
                                                  flatten_with_paths)
from repro_torch.configs.gnn import DATASETS, PlatformConfig
from repro_torch.core.abstraction import HitGNN
from repro_torch.core.dse import H100_SLABS
from repro_torch.core.trainer import SyncGNNTrainer
from repro_torch.data.graphs import synthetic_graph
from repro_torch.nn.param import flatten

G = synthetic_graph(scale=11, edge_factor=6, feat_dim=16, num_classes=4)
RTOL, ATOL = 1e-5, 1e-6     # tests/test_torch_trainer.py's
LR = 5e-3
# keys of an epoch's metrics that time the host (they differ run to run)
TIMED = ("epoch_time_s", "nvtps", "host_produce_s", "host_wait_s",
         "host_gather_s", "host_issue_s", "host_fetch_s", "pool_recovery_s")


def _listing1(cls, p=2):
    hit = cls()
    hit.Graph_Partition("metis_like", p=p)
    hit.Feature_Storing("distdgl")
    hit.GNN_Computation("graphsage")
    hit.GNN_Parameters(L=2, hidden=[16], fanouts=(4, 3), batch_targets=32)
    hit.Platform_Metadata(num_devices=p)
    return hit


def _reference_params(p=2):
    """The reference ``HitGNN``'s trainer's seeded initial parameters, as
    numpy (an epoch-less ``Start_training`` builds the trainer)."""
    import jax
    from repro.core.abstraction import HitGNN as JHitGNN
    from repro.data.graphs import synthetic_graph as jsynthetic
    jhit = _listing1(JHitGNN, p)
    jhit.LoadInputGraph(jsynthetic(scale=11, edge_factor=6, feat_dim=16,
                                   num_classes=4))
    assert jhit.Start_training(epochs=0) == []
    return jhit, jax.tree.map(np.asarray, jhit._trainer.params)


def test_listing1_flow(tmp_path):
    hit = HitGNN()
    hit.Graph_Partition("metis_like", p=2)
    hit.Feature_Storing("distdgl")
    hit.GNN_Computation("graphsage")
    hit.GNN_Parameters(L=2, hidden=[32], fanouts=(4, 4), batch_targets=32)
    hit.Platform_Metadata(num_devices=2)
    design = hit.Generate_Design(DATASETS["reddit"], beta=0.8)
    assert design["fpga"]["throughput"] > 0
    assert design["h100"]["slab"] in H100_SLABS
    assert design["h100"]["smem"] <= 232_448

    g = synthetic_graph(scale=9, edge_factor=6, feat_dim=16, num_classes=4)
    hit.LoadInputGraph(g)
    history = hit.Start_training(epochs=2, lr=LR, device="cpu",
                                 checkpoint_dir=str(tmp_path / "ck"))
    assert len(history) == 2
    assert np.isfinite(history[-1]["loss"])
    assert (Checkpointer(str(tmp_path / "ck")).latest_step()
            == hit._trainer.step_no > 0)
    out = hit.Save_model(str(tmp_path / "model.npz"))
    assert os.path.exists(out)


def test_gnn_model_config_roundtrip():
    hit = HitGNN().GNN_Computation("gcn").GNN_Parameters(
        L=3, hidden=[64], fanouts=(5, 5, 5), batch_targets=64)
    cfg = hit.GNN_Model()
    assert cfg.name == "gcn"
    assert cfg.num_layers == 3
    assert cfg.fanouts == (5, 5, 5)


@pytest.mark.parametrize("stats", ["reddit", "ogbn-products", "graph"])
def test_generate_design_fpga_equals_reference(stats):
    """The design's FPGA entry is the reference's, from Table 4's stats or
    (``"graph"``) from the loaded graph's."""
    from repro.configs.gnn import DATASETS as JDATASETS
    from repro.core.abstraction import HitGNN as JHitGNN
    got, want = _listing1(HitGNN, 4), _listing1(JHitGNN, 4)
    if stats == "graph":
        got.LoadInputGraph(G)
        want.LoadInputGraph(G)
        a, b = got.Generate_Design(), want.Generate_Design()
    else:
        a = got.Generate_Design(DATASETS[stats], beta=0.6)
        b = want.Generate_Design(JDATASETS[stats], beta=0.6)
    assert a["fpga"] == b["fpga"]
    assert set(a) == {"fpga", "h100"}
    assert set(a["h100"]) == {"slab", "cluster", "t_agg", "smem"}


def test_start_training_matches_reference(tmp_path):
    """Two epochs through the port's facade from the reference trainer's
    initial parameters against the reference's ``HitGNN``: the same
    schedule and vertices traversed, losses within rtol 1e-5; both
    ``Save_model`` files hold the same keys and shapes, the port's the
    trainer's parameters exactly."""
    jhit, params0 = _reference_params()
    want = jhit.Start_training(epochs=2, lr=LR)
    hit = _listing1(HitGNN).LoadInputGraph(G)
    got = hit.Start_training(epochs=2, lr=LR, device="cpu", params=params0)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("iterations", "batches", "fill_slots", "utilization",
                  "vertices_traversed", "beta"):
            assert g[k] == w[k], k
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL,
                                   atol=ATOL)
    ours = np.load(hit.Save_model(str(tmp_path / "port.npz")))
    theirs = np.load(jhit.Save_model(str(tmp_path / "ref.npz")))
    assert sorted(ours.files) == sorted(theirs.files) == [
        str(i) for i in range(6)]
    assert {k: ours[k].shape for k in ours.files} == {
        k: theirs[k].shape for k in theirs.files}
    leaves = list(flatten_with_paths(hit._trainer.params).values())
    assert len(leaves) == len(ours.files)
    for i, leaf in enumerate(leaves):
        assert np.array_equal(ours[str(i)], leaf.detach().numpy())


def test_facade_epoch_bitwise_a_direct_trainer():
    """``Start_training`` builds the trainer a user would: its epoch and
    final parameters equal those of ``SyncGNNTrainer`` built directly with
    the same arguments, bit for bit."""
    hit = _listing1(HitGNN).LoadInputGraph(G)
    direct = SyncGNNTrainer(G, hit.GNN_Model(), 2, algorithm="distdgl",
                            lr=LR, device="cpu")
    want = direct.run_epoch()
    got = hit.Start_training(epochs=1, lr=LR, device="cpu")[0]
    assert set(got) == set(want)
    for k in got:
        if k not in TIMED:
            assert got[k] == want[k], k
    for a, b in zip(flatten(hit._trainer.params), flatten(direct.params)):
        assert torch.equal(a, b)


def test_start_training_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hit = _listing1(HitGNN).LoadInputGraph(G)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hit.Start_training(epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hit.Start_training(epochs=1, device="cuda")


def test_platform_config_to_metadata_matches_reference():
    from repro.configs.gnn import PlatformConfig as JPlatform
    for kw in ({}, {"num_devices": 8, "pcie_bw": 32e9, "host_bw": 400e9}):
        got, want = (PlatformConfig(**kw).to_metadata(),
                     JPlatform(**kw).to_metadata())
        assert type(got).__module__ == "repro_torch.core.dse"
        assert dataclasses.asdict(got) == dataclasses.asdict(want)

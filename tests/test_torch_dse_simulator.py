"""The port's DSE engine (``repro_torch.core.dse``) and platform simulator
(``repro_torch.core.simulator``): the paper-claim contracts of
``tests/test_dse_simulator.py`` (Table 5, Fig. 8, Table 7's ablation) and
``tests/test_fused.py``'s backend ranking, run on the port; ``FPGADSE``,
``minibatch_shape`` and every simulator entry point bit for bit against
``repro.core`` (Python floats compared with ``==``) over each group of
``SimConfig``'s knobs; and the H100 instantiation under the card's shared
memory, whose formula the ``gpu`` case holds against the built kernel.
The reference is imported inside the tests that use it: the card has no
JAX."""
import numpy as np
import pytest
import torch

from repro_torch.configs.gnn import DATASETS, GCN, GNN_MODELS, GRAPHSAGE
from repro_torch.core.dse import (FPGADSE, H100_MAX_CLUSTER, H100_SLABS,
                                  H100DSE, H100Metadata, minibatch_shape)
from repro_torch.core.simulator import (SimConfig, rank_aggregate_backends,
                                        scaling_curve, simulate_epoch)


def _avg_throughput(dse, n, m, beta=0.8):
    mbs = [minibatch_shape(GRAPHSAGE, ds) for ds in DATASETS.values()]
    return float(np.mean([dse.throughput(n, m, mb, beta) for mb in mbs]))


# -- the paper-claim contracts, on the port ------------------------------------

def test_table5_utilization_calibration():
    dse = FPGADSE()
    u1 = dse.utilization(8, 2048)
    u2 = dse.utilization(16, 1024)
    assert abs(u1["dsp"] - 0.90) < 0.02 and abs(u1["lut"] - 0.72) < 0.03
    assert abs(u2["dsp"] - 0.56) < 0.02 and abs(u2["lut"] - 0.65) < 0.03


def test_table5_counterintuitive_choice():
    """(8, 2048) out-throughputs (16, 1024): the optimized aggregation
    shifts the bottleneck to the update."""
    dse = FPGADSE()
    assert _avg_throughput(dse, 8, 2048) > _avg_throughput(dse, 16, 1024)


def test_dse_search_respects_resources():
    dse = FPGADSE()
    mb = minibatch_shape(GRAPHSAGE, DATASETS["reddit"])
    best = dse.search(mb, beta=0.8)
    assert dse.resources_ok(best["n"], best["m"])
    assert best["throughput"] > 0


def test_h100_dse_respects_smem():
    """The H100 counterpart of the reference's VMEM case: the design fits
    a thread block's shared memory, and its slab and cluster are ones
    ``aggregate_fused`` is built for."""
    dse = H100DSE()
    mb = minibatch_shape(GRAPHSAGE, DATASETS["ogbn-products"])
    best = dse.search(mb)
    assert best["smem"] == dse.smem_bytes(best["slab"])
    assert best["smem"] <= dse.meta.smem_bytes == 232_448
    assert best["slab"] in (32, 128, 160)
    assert 1 <= best["cluster"] <= 8
    assert best["t_agg"] > 0 and np.isfinite(best["t_agg"])


def test_fig8_near_linear_then_knee():
    curve = scaling_curve(GRAPHSAGE, DATASETS["ogbn-products"], beta=0.8,
                          sim=SimConfig(), max_p=16)
    sp = {r["p"]: r["speedup"] for r in curve}
    assert sp[8] > 6.4
    assert sp[12] > 9.0
    assert sp[16] > 12.0
    t = {p: simulate_epoch(GRAPHSAGE, DATASETS["ogbn-products"], p, 0.8,
                           SimConfig(), imbalance=0.0)["t_parallel"]
         for p in (8, 16, 20)}
    assert t[16] >= t[8]
    assert t[20] > t[8]


def test_ablation_ordering_base_wb_wbdc():
    """Table 7's shape: base < +WB < +WB+DC (with a miss-heavy beta)."""
    ds = DATASETS["ogbn-products"]
    kw = dict(imbalance=0.35, seed=1)
    base = simulate_epoch(GRAPHSAGE, ds, 4, 0.5,
                          SimConfig(workload_balancing=False,
                                    host_direct_fetch=False), **kw)
    wb = simulate_epoch(GRAPHSAGE, ds, 4, 0.5,
                        SimConfig(workload_balancing=True,
                                  host_direct_fetch=False), **kw)
    wbdc = simulate_epoch(GRAPHSAGE, ds, 4, 0.5, SimConfig(), **kw)
    assert base["nvtps"] < wb["nvtps"] < wbdc["nvtps"]


def test_throughput_monotone_in_beta():
    dse = FPGADSE()
    mb = minibatch_shape(GCN, DATASETS["reddit"])
    t = [dse.throughput(8, 2048, mb, b) for b in (0.2, 0.5, 0.8, 1.0)]
    assert all(a <= b * 1.0001 for a, b in zip(t, t[1:]))


def test_simulator_ranks_fused_fastest():
    sim = SimConfig(densified_hbm_bytes=8e6, h2d_layout_bytes=4e6)
    r = rank_aggregate_backends(GRAPHSAGE, DATASETS["ogbn-products"], 4, 0.8,
                                sim, h2d_edges_bytes=2e6,
                                agg_intermediate_bytes=2e6,
                                update_dispatches=64.0,
                                t_update_dispatch=30e-6)
    t = {k: v["epoch_time_s"] for k, v in r.items()}
    assert t["pallas_fused"] < t["pallas_edges"] < t["pallas"]
    assert r["pallas_fused"]["agg_intermediate_bytes"] == 0
    assert r["pallas_edges"]["agg_intermediate_bytes"] > 0


# -- bit for bit against the reference -----------------------------------------

@pytest.mark.parametrize("model", sorted(GNN_MODELS))
@pytest.mark.parametrize("ds", sorted(DATASETS))
def test_minibatch_shape_bitwise_reference(ds, model):
    from repro.core.dse import minibatch_shape as jshape
    from repro.configs import gnn as jgnn
    got = minibatch_shape(GNN_MODELS[model], DATASETS[ds])
    want = jshape(jgnn.GNN_MODELS[model], jgnn.DATASETS[ds])
    assert (got.v, got.a, got.f) == (want.v, want.a, want.f)
    part = minibatch_shape(GNN_MODELS[model], DATASETS[ds], 50_000)
    jpart = jshape(jgnn.GNN_MODELS[model], jgnn.DATASETS[ds], 50_000)
    assert (part.v, part.a, part.f) == (jpart.v, jpart.a, jpart.f)


@pytest.mark.parametrize("ds", sorted(DATASETS))
def test_fpga_search_bitwise_reference(ds):
    """Algorithm 4's sweep, every grid point's throughput and the choice,
    at the default platform and at 2 devices, a 32 GB/s link and the U250
    clocked at 250 MHz."""
    from repro.core import dse as jdse
    from repro.configs import gnn as jgnn
    from repro_torch.core import dse as tdse
    for kw, fpga in (({}, {}),
                     ({"num_devices": 2, "pcie_bw": 32e9}, {"freq": 250e6})):
        got = tdse.FPGADSE(tdse.PlatformMetadata(
            **kw, fpga=tdse.FPGAMetadata(**fpga)))
        want = jdse.FPGADSE(jdse.PlatformMetadata(
            **kw, fpga=jdse.FPGAMetadata(**fpga)))
        for beta in (0.5, 0.8):
            a = got.search(minibatch_shape(GRAPHSAGE, DATASETS[ds]), beta)
            b = want.search(jdse.minibatch_shape(jgnn.GRAPHSAGE,
                                                 jgnn.DATASETS[ds]), beta)
            for k in ("n", "m", "throughput", "dsp", "lut"):
                assert a[k] == b[k], k
            assert a["grid"] == b["grid"]
            assert len(a["grid"]) > 500


def _platform(mod, kind):
    """The simulator's platform: the default one, or a faster host link
    with a slower host and a 250 MHz FPGA."""
    if kind == "default":
        return mod.PlatformMetadata()
    return mod.PlatformMetadata(pcie_bw=32e9, host_bw=100e9,
                                fpga=mod.FPGAMetadata(freq=250e6))


# one case per group of SimConfig's knobs (the platform is built by each
# package from its own dataclasses)
SIM_CASES = {
    "default": {},
    "platform_and_pes": dict(platform="fast_link", n_agg_pe=16,
                             m_update_pe=1024),
    "no_wb_no_dc_no_overlap": dict(workload_balancing=False,
                                   host_direct_fetch=False,
                                   sampling_overlap=False),
    "host_stages": dict(t_sampling=5e-3, t_gather=2e-3, t_layout=1.5e-3,
                        h2d_layout_bytes=3e6),
    "workers_with_ipc": dict(num_sampler_workers=4, t_ipc=7e-4,
                             t_sampling=9e-3, t_layout=2e-3, t_gather=1e-3),
    "gather_in_workers": dict(num_sampler_workers=3, gather_in_workers=True,
                              t_gather_worker=4e-3, t_placement=5e-4,
                              ring_bytes=2e7, t_ipc=2e-4, t_sampling=6e-3),
    "cache": dict(cache_hit_rate=0.6, calibrated_hit_rate=0.3,
                  cache_refresh_bytes=1e6, t_gather=3e-3,
                  num_sampler_workers=2, gather_in_workers=True,
                  t_gather_worker=2e-3, ring_bytes=1e7),
    "faults": dict(num_sampler_workers=2, faults_per_epoch=2.0,
                   t_respawn=0.5, resubmit_batches=8.0, t_sampling=4e-3),
    "densify": dict(densified_hbm_bytes=8e6, h2d_layout_bytes=4e6),
    "intermediate": dict(agg_intermediate_bytes=2e6, update_dispatches=64.0,
                         t_update_dispatch=30e-6),
}


def _sim(sim_mod, dse_mod, case):
    kw = dict(SIM_CASES[case])
    kind = kw.pop("platform", "default")
    return sim_mod.SimConfig(platform=_platform(dse_mod, kind), **kw)


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulator_bitwise_reference(case):
    """``simulate_epoch`` at p = 1, 4 and 13, ``scaling_curve``,
    ``sampler_worker_curve``, ``pipeline_speedup`` and
    ``rank_aggregate_backends`` return the reference's dicts exactly."""
    import repro.core.dse as jdse
    import repro.core.simulator as jsim
    import repro_torch.core.dse as tdse
    import repro_torch.core.simulator as tsim
    from repro.configs import gnn as jgnn
    got_sim, want_sim = _sim(tsim, tdse, case), _sim(jsim, jdse, case)
    for model, ds, beta in (("graphsage", "ogbn-products", 0.8),
                            ("gcn", "reddit", 0.5)):
        tm, jm = GNN_MODELS[model], jgnn.GNN_MODELS[model]
        td, jd = DATASETS[ds], jgnn.DATASETS[ds]
        for p in (1, 4, 13):
            assert (tsim.simulate_epoch(tm, td, p, beta, got_sim, 0.3, 2)
                    == jsim.simulate_epoch(jm, jd, p, beta, want_sim, 0.3,
                                           2))
        assert (tsim.scaling_curve(tm, td, beta, got_sim, max_p=6)
                == jsim.scaling_curve(jm, jd, beta, want_sim, max_p=6))
        assert (tsim.sampler_worker_curve(tm, td, 4, beta, got_sim)
                == jsim.sampler_worker_curve(jm, jd, 4, beta, want_sim))
        assert (tsim.pipeline_speedup(tm, td, 4, beta, got_sim)
                == jsim.pipeline_speedup(jm, jd, 4, beta, want_sim))
        kw = dict(h2d_edges_bytes=2e6, agg_intermediate_bytes=2e6,
                  update_dispatches=2.0, t_update_dispatch=5e-6)
        assert (tsim.rank_aggregate_backends(tm, td, 4, beta, got_sim, **kw)
                == jsim.rank_aggregate_backends(jm, jd, 4, beta, want_sim,
                                                **kw))


@pytest.mark.parametrize("imbalance,seed", [(0.0, 0), (0.25, 0), (0.5, 7)])
def test_partition_batch_counts_bitwise_reference(imbalance, seed):
    from repro.core.simulator import partition_batch_counts as jcounts
    from repro_torch.core.simulator import partition_batch_counts
    for p in (1, 4, 16):
        assert (partition_batch_counts(244_902, p, 1024, imbalance, seed)
                == jcounts(244_902, p, 1024, imbalance, seed))


# -- the H100 instantiation ----------------------------------------------------

def test_h100_smem_formula():
    """``smem_bytes`` is ``csrc/aggregate_fused.cu``'s: the walk's carve
    for the wide slabs, the partial (128 x 136 floats) for 32."""
    dse = H100DSE()
    assert [dse.smem_bytes(s) for s in H100_SLABS] == [69_632, 168_964,
                                                       202_756]


def test_h100_search_sweeps_what_fits():
    """A budget below the widest slab's shared memory drops it, and the
    choice is the least modelled time over every (slab, cluster) that
    fits."""
    mb = minibatch_shape(GRAPHSAGE, DATASETS["reddit"])
    for budget in (232_448, 200_000, 100_000):
        dse = H100DSE(H100Metadata(smem_bytes=budget))
        best = dse.search(mb, beta=1.0)
        fits = [s for s in H100_SLABS if dse.smem_bytes(s) <= budget]
        assert best["slab"] in fits and best["smem"] <= budget
        times = {(s, c): sum(dse.agg_layer_time(
                     s, c, mb.v[l], mb.v[l + 1], mb.a[l], mb.f[l],
                     mb.f[l + 1], 1.0) for l in range(len(mb.a)))
                 for s in fits for c in range(1, H100_MAX_CLUSTER + 1)}
        assert best["t_agg"] == min(times.values())
        assert times[(best["slab"], best["cluster"])] == best["t_agg"]


def test_h100_layer_time_monotone_in_beta():
    """Misses cross the host link, 52x slower than HBM: a layer's time
    cannot fall as beta falls."""
    dse = H100DSE()
    mb = minibatch_shape(GRAPHSAGE, DATASETS["reddit"])
    for slab in H100_SLABS:
        t = [dse.agg_layer_time(slab, 4, mb.v[0], mb.v[1], mb.a[0], mb.f[0],
                                mb.f[1], b) for b in (0.2, 0.5, 0.8, 1.0)]
        assert all(a >= b for a, b in zip(t, t[1:]))


@pytest.mark.gpu
def test_h100_smem_formula_matches_built_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds only there")
    from repro_torch.kernels import aggregate as agg
    dse = H100DSE()
    for slab in (32, 128, 160):
        assert dse.smem_bytes(slab) == agg.aggregate_fused_smem_bytes(slab)

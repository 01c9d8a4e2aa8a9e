"""CPU+Multi-accelerator platform simulator (paper §7.6, Fig. 8), a copy of
``repro.core.simulator`` over the port's own ``core/dse.py`` and
``core/scheduler.py``: the same inputs give the reference's floats.

Discrete-rate model of one training epoch on p devices. Captures the three
effects the paper studies:

* workload balance — per-partition batch counts -> iteration count, naive vs
  two-stage scheduling (epoch time = iterations x t_parallel);
* data communication — feature misses are host fetches; WITHOUT the DC
  optimization a miss bounces accelerator->host->accelerator (two PCIe
  crossings, paper §5.2 / [26]);
* host-bandwidth saturation — the host memory serves p concurrent miss
  streams: effective per-device host bandwidth = min(pcie, host_bw / p).
  With the paper's constants (205 GB/s host, 16 GB/s PCIe) the knee lands at
  205/16 ~ 12.8 devices, reproducing Fig. 8's scaling limit.

Its device model is the paper's FPGA model (``FPGADSE``'s constants), as in
the reference; ``chip_smoke.py`` calibrates the host terms from the card's
runs and prints the model beside what the card measured.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs.gnn import GNNModelConfig, GraphDatasetConfig
from repro_torch.core.dse import (FPGADSE, PlatformMetadata, minibatch_shape)
from repro_torch.core import scheduler as sched


@dataclass
class SimConfig:
    platform: PlatformMetadata = field(default_factory=PlatformMetadata)
    n_agg_pe: int = 8             # DSE-chosen accelerator config
    m_update_pe: int = 2048
    workload_balancing: bool = True
    host_direct_fetch: bool = True   # DC optimization
    t_sampling: float = 2e-3         # host sampling time per batch (calibratable)
    t_gather: float = 0.0            # host feature-gather time per batch
    # stage-2b: block-CSR layout build per batch (pallas aggregate backend;
    # the compact edge-centric builder — calibrated by bench_pipeline)
    t_layout: float = 0.0
    # per-batch host->device payload for the aggregate-path layout (compact:
    # ~20 B/edge incl. the transpose; the dense pre-compact path shipped
    # 64 KB per block slot).
    # Crosses PCIe as part of step dispatch, i.e. on the DEVICE side of the
    # pipeline overlap.
    h2d_layout_bytes: float = 0.0
    # per-batch DEVICE-DRAM bytes of densified adjacency tiles
    # (aggregate_backend="pallas": the jit'd step scatter-adds the full
    # (Nd, max_blk, 128, 128) A + A^T tensors in HBM, which the SpMM then
    # reads back — two DDR crossings of the whole footprint). The
    # edge-streaming backend ("pallas_edges") densifies per-tile in VMEM,
    # so it sets this to 0 and the term vanishes.
    densified_hbm_bytes: float = 0.0
    # Fused-datapath model (aggregate_backend="pallas_fused"): the UNFUSED
    # backends run densify -> SpMM -> update MLP as separate dispatches, so
    # the aggregated intermediate (sum over layers of Nd*128 x f_in fp32)
    # round-trips device DRAM between the SpMM and the update matmul — one
    # write + one read — and each layer pays an extra kernel-dispatch
    # latency for the update. The fused grid applies the update on the
    # final k-step with the weights VMEM-resident, so both terms vanish:
    # model a backend by setting agg_intermediate_bytes (per-batch
    # footprint; 0 under "pallas_fused") and update_dispatches (per-batch
    # fused-away launches, each costing t_update_dispatch on the device
    # side of the overlap). All default 0.0 => pre-fusion model unchanged.
    agg_intermediate_bytes: float = 0.0
    update_dispatches: float = 0.0
    t_update_dispatch: float = 0.0
    sampling_overlap: bool = True    # pipelined host (prefetch executor)
    # Sampling service (core/sampler_pool.py): the sample + layout-build
    # stages parallelize over this many worker processes; gather stays on
    # the consumer thread unless gather_in_workers moves it. t_ipc is the
    # per-batch marshalling cost the parent pays to receive a worker result
    # (pickle + queue crossing) — zero when sampling in-process
    # (num_sampler_workers <= 1 models the single-stream host, matching the
    # in-process path when t_ipc = 0).
    num_sampler_workers: int = 1
    t_ipc: float = 0.0
    # Stage-2 offload: with gather_in_workers the per-batch feature gather
    # (t_gather_worker) parallelizes over the workers like sampling, the
    # consumer keeps only the placement tail (t_placement: resident-row HBM
    # reads + the shipped-rows memcpy), and the shipped miss rows cost
    # ring_bytes per batch of host-memory bandwidth to cross the
    # shared-memory ring. All default 0.0 => the model is unchanged when
    # the offload is off.
    gather_in_workers: bool = False
    t_gather_worker: float = 0.0
    t_placement: float = 0.0
    ring_bytes: float = 0.0
    # Feature-cache model (core/feature_cache.py): the per-batch gather and
    # ring terms above are CALIBRATED from a run whose epoch hit rate was
    # calibrated_hit_rate; setting cache_hit_rate rescales their
    # miss-driven cost by (1 - hit) / (1 - calibrated) — a higher hit rate
    # means fewer rows cross the host bus / the ring per batch. None (the
    # default) leaves the model untouched. cache_refresh_bytes is the
    # per-batch host->device refresh stream (admitted rows installed
    # between iterations); it rides the device side of the overlap like
    # the layout H2D payload.
    cache_hit_rate: "Optional[float]" = None
    calibrated_hit_rate: float = 0.0
    cache_refresh_bytes: float = 0.0
    # Recovery-overhead model (the supervised sampling service,
    # core/sampler_pool.py): faults_per_epoch worker deaths per epoch, each
    # costing t_respawn (process spawn + shared-segment re-attach) plus the
    # re-execution of resubmit_batches in-flight batches at the host's
    # per-batch rate. Stragglers/CRC retries fold into resubmit_batches.
    # All default 0 => fault-free model unchanged.
    faults_per_epoch: float = 0.0
    t_respawn: float = 0.0
    resubmit_batches: float = 0.0


def partition_batch_counts(train_vertices: int, p: int,
                           batch_targets: int, imbalance: float = 0.25,
                           seed: int = 0) -> List[int]:
    """Per-partition batch counts with a controllable imbalance factor
    (METIS-style partitions are vertex-imbalanced; paper Challenge 2)."""
    rng = np.random.default_rng(seed)
    shares = 1.0 + imbalance * (2 * rng.random(p) - 1)
    shares = shares / shares.sum()
    counts = np.maximum(1, np.round(
        shares * train_vertices / batch_targets)).astype(int)
    return counts.tolist()


def simulate_epoch(model: GNNModelConfig, ds: GraphDatasetConfig,
                   p: int, beta: float, sim: SimConfig,
                   imbalance: float = 0.25, seed: int = 0) -> dict:
    """Returns epoch time, throughput (NVTPS) and the component times."""
    pf = PlatformMetadata(num_devices=p, pcie_bw=sim.platform.pcie_bw,
                          host_bw=sim.platform.host_bw, fpga=sim.platform.fpga)
    dse = FPGADSE(pf)
    # constant per-batch work across p (sampling population is the whole
    # graph locality; per-partition dedup differences are second-order)
    mb = minibatch_shape(model, ds)

    # --- bandwidth contention at the host -----------------------------------
    host_share = min(pf.pcie_bw, pf.host_bw / p)
    if not sim.host_direct_fetch:
        # miss bounces through host shared memory: two crossings + the
        # destination device's PCIe is also occupied -> half bandwidth
        host_share = min(pf.pcie_bw / 2, pf.host_bw / (2 * p))

    # effective per-device GNN time with the contended miss bandwidth:
    # replace the PCIe term of Eq. (7) by host_share
    def gnn_time() -> float:
        t = 0.0
        for l in range(len(mb.a)):
            f_in, f_out = mb.f[l], mb.f[l + 1]
            t_load = (mb.v[l] * beta * f_in * 4 / pf.fpga.ddr_bw
                      + mb.v[l] * (1 - beta) * f_in * 4 / host_share)
            t_comp = mb.a[l] * f_in / (sim.n_agg_pe * pf.fpga.simd * pf.fpga.freq)
            t_upd = mb.v[l] * f_in * f_out / (sim.m_update_pe * pf.fpga.freq)
            t += max(t_load, t_comp, t_upd)
        t_lc = mb.v[-1] * mb.f[-1] / (sim.m_update_pe * pf.fpga.freq)
        return 3.0 * t + t_lc  # fwd + ~2x bwd

    # Eq. 5-6: the prefetch executor runs the host stages one iteration
    # ahead of the device step, so the iteration rate is set by
    # max(host, device + H2D), not their sum. The layout H2D payload rides
    # the step dispatch, so it lands on the device side of the overlap.
    # Sampling + layout build parallelize over the sampling service's
    # worker processes (each result paying t_ipc to cross back); the
    # feature gather serializes on the consumer thread UNLESS the stage-2
    # offload moves it into the workers too — then only the placement tail
    # stays serial and each batch's shipped rows pay one host-bandwidth
    # crossing of the shared-memory ring.
    w = max(1, sim.num_sampler_workers)
    # feature-cache model: gather time and ring traffic are driven by the
    # MISS rows of a batch, so both scale with the miss fraction relative
    # to the hit rate the calibration run measured. Ring bytes are exactly
    # miss rows x row bytes (the ring carries only true misses); the
    # gather terms are dominated by the same fancy-indexed row reads, so
    # the shared scale is applied to them too.
    miss_scale = 1.0
    if sim.cache_hit_rate is not None:
        miss_scale = (max(0.0, 1.0 - sim.cache_hit_rate)
                      / max(1e-9, 1.0 - sim.calibrated_hit_rate))
    t_gather = sim.t_gather * miss_scale
    t_gather_worker = sim.t_gather_worker * miss_scale
    ring_bytes = sim.ring_bytes * miss_scale
    # densified-tile HBM traffic (scatter write + SpMM read-back) rides the
    # device side of the overlap, like the layout H2D payload — and so does
    # the cache-refresh stream installing admitted rows between iterations
    t_densify = 2 * sim.densified_hbm_bytes / pf.fpga.ddr_bw
    # unfused aggregate->update handoff: the intermediate crosses device
    # DRAM twice (SpMM write + update read) and each fused-away update
    # launch pays its dispatch latency — both zero under "pallas_fused"
    t_agg_intermediate = (2 * sim.agg_intermediate_bytes / pf.fpga.ddr_bw
                          + sim.update_dispatches * sim.t_update_dispatch)
    t_gnn = (gnn_time()
             + (sim.h2d_layout_bytes + sim.cache_refresh_bytes) / host_share
             + t_densify + t_agg_intermediate)
    t_ipc = sim.t_ipc if sim.num_sampler_workers > 1 else 0.0
    if sim.gather_in_workers:
        t_host = (sim.t_placement
                  + (sim.t_sampling + sim.t_layout + t_gather_worker) / w
                  + t_ipc + ring_bytes / pf.host_bw)
    else:
        t_host = (t_gather + (sim.t_sampling + sim.t_layout) / w
                  + t_ipc)
    t_exec = max(t_host, t_gnn) if sim.sampling_overlap else t_host + t_gnn
    grad_bytes = 4 * (ds.feat_dim * model.hidden
                      + (model.num_layers - 1) * model.hidden * model.hidden
                      + model.hidden * ds.num_classes) * 2
    t_sync = 2 * grad_bytes / pf.pcie_bw + 20e-6 * np.log2(max(p, 2))
    t_parallel = t_exec + t_sync                            # Eq. (4)

    counts = partition_batch_counts(
        int(ds.num_vertices * 0.1), p, model.batch_targets, imbalance, seed)
    schedule = (sched.two_stage_schedule(counts) if sim.workload_balancing
                else sched.naive_schedule(counts))
    stats = sched.schedule_stats(schedule, p)
    # recovery overhead: each fault pays the respawn latency plus the
    # re-execution of its in-flight batches ON the host path (re-sampled
    # work, not device work) — additive because recovery serializes the
    # consumer until the resubmitted head-of-line batch lands
    t_recovery = sim.faults_per_epoch * (
        sim.t_respawn + sim.resubmit_batches
        * (sim.t_sampling + sim.t_layout + t_gather_worker) / w)
    epoch_time = stats["iterations"] * t_parallel + t_recovery
    vertices = sum(mb.v) * stats["batches"]
    return {
        "p": p, "epoch_time_s": epoch_time,
        "t_recovery": t_recovery,
        "nvtps": vertices / epoch_time,
        "iterations": stats["iterations"],
        "utilization": stats["utilization"],
        "t_gnn": t_gnn, "t_sync": t_sync, "t_parallel": t_parallel,
        "t_sampling": sim.t_sampling, "t_gather": t_gather,
        "t_layout": sim.t_layout, "t_host": t_host,
        "num_sampler_workers": sim.num_sampler_workers,
        "gather_in_workers": sim.gather_in_workers,
        "t_gather_worker": t_gather_worker,
        "ring_bytes": ring_bytes,
        "cache_hit_rate": sim.cache_hit_rate,
        "miss_scale": miss_scale,
        "cache_refresh_bytes": sim.cache_refresh_bytes,
        "h2d_layout_bytes": sim.h2d_layout_bytes,
        "densified_hbm_bytes": sim.densified_hbm_bytes,
        "t_densify": t_densify,
        "agg_intermediate_bytes": sim.agg_intermediate_bytes,
        "t_agg_intermediate": t_agg_intermediate,
        "host_share_gbs": host_share / 1e9,
        "beta": beta,
    }


def sampler_worker_curve(model: GNNModelConfig, ds: GraphDatasetConfig,
                         p: int, beta: float, sim: SimConfig,
                         worker_counts: Sequence[int] = (1, 2, 4, 8),
                         imbalance: float = 0.25, seed: int = 0
                         ) -> List[dict]:
    """Modelled epoch throughput vs sampling-service worker count: the
    host's sample + layout stages (and, with ``gather_in_workers``, the
    feature gather) shrink by 1/w (plus the per-batch IPC toll) until the
    device step or the serial consumer tail dominates Eq. 5's max — the
    knee tells how many sampler processes the platform can use."""
    from dataclasses import replace
    out = []
    for w in worker_counts:
        r = simulate_epoch(model, ds, p, beta,
                           replace(sim, num_sampler_workers=w),
                           imbalance, seed)
        r["workers"] = w
        out.append(r)
    base = out[0]["nvtps"]
    for r in out:
        r["speedup_vs_1"] = r["nvtps"] / base if base > 0 else 1.0
    return out


def pipeline_speedup(model: GNNModelConfig, ds: GraphDatasetConfig,
                     p: int, beta: float, sim: SimConfig,
                     imbalance: float = 0.25, seed: int = 0) -> dict:
    """Modelled benefit of the prefetching host pipeline: the same platform
    with host work serialized against the device (epoch ~= host + compute)
    vs overlapped (epoch ~= max(host, compute), Eq. 5-6)."""
    from dataclasses import replace
    seq = simulate_epoch(model, ds, p, beta,
                         replace(sim, sampling_overlap=False),
                         imbalance, seed)
    pipe = simulate_epoch(model, ds, p, beta,
                          replace(sim, sampling_overlap=True),
                          imbalance, seed)
    return {"sequential": seq, "pipelined": pipe,
            "speedup": seq["epoch_time_s"] / pipe["epoch_time_s"]}


def rank_aggregate_backends(model: GNNModelConfig, ds: GraphDatasetConfig,
                            p: int, beta: float, sim: SimConfig,
                            h2d_edges_bytes: float,
                            agg_intermediate_bytes: float,
                            update_dispatches: float,
                            t_update_dispatch: float,
                            imbalance: float = 0.25, seed: int = 0) -> dict:
    """Modelled epoch time for the three Pallas aggregation datapaths.

    ``sim`` describes the HBM-densify platform ("pallas":
    ``densified_hbm_bytes`` set, compact H2D payload). "pallas_edges" drops
    the densified-tile DRAM term (tiles live in one VMEM scratch per grid
    step) and ships the leaner edge-stream layout, but still round-trips
    the aggregated intermediate and dispatches the update separately.
    "pallas_fused" additionally zeroes the intermediate + dispatch terms —
    the single-pass datapath. The simulator therefore ranks the backends;
    bench_pipeline asserts the SIGN of each streaming backend's modelled
    delta vs "pallas" matches the measured one."""
    from dataclasses import replace
    unfused = dict(agg_intermediate_bytes=agg_intermediate_bytes,
                   update_dispatches=update_dispatches,
                   t_update_dispatch=t_update_dispatch)
    cfgs = {
        "pallas": replace(sim, **unfused),
        "pallas_edges": replace(sim, densified_hbm_bytes=0.0,
                                h2d_layout_bytes=h2d_edges_bytes, **unfused),
        "pallas_fused": replace(sim, densified_hbm_bytes=0.0,
                                h2d_layout_bytes=h2d_edges_bytes,
                                agg_intermediate_bytes=0.0,
                                update_dispatches=0.0),
    }
    return {name: simulate_epoch(model, ds, p, beta, c, imbalance, seed)
            for name, c in cfgs.items()}


def scaling_curve(model: GNNModelConfig, ds: GraphDatasetConfig,
                  beta: float, sim: SimConfig, max_p: int = 16) -> List[dict]:
    """Speedup vs single device (paper Fig. 8)."""
    base = simulate_epoch(model, ds, 1, beta, sim)
    out = []
    for p in range(1, max_p + 1):
        r = simulate_epoch(model, ds, p, beta, sim)
        r["speedup"] = r["nvtps"] / base["nvtps"]
        out.append(r)
    return out

"""Hardware Design Space Exploration (paper §6, Algorithm 4), counterpart of
``repro.core.dse``.

Two instantiations of the same methodology (analytic resource + throughput
models, exhaustive sweep):

1. ``FPGADSE`` — the paper's model verbatim, a copy of the reference's:
   resource constraints Eqs. (1)-(2) over (n scatter-gather PEs, m update
   PEs), throughput Eqs. (3)-(9) in NVTPS, with the coefficients calibrated
   to the published Table 5 utilization points ((8,2048)->90% DSP/72% LUT,
   (16,1024)->56%/65% on a U250). The same inputs give the reference's
   floats bit for bit.

2. ``H100DSE`` — the H100 instantiation, in the place of the reference's
   TPU one: the reconfigurable-fabric knobs (n, m) become the shape of the
   kernel the main path runs, ``aggregate_fused`` (``kernels/aggregate.py
   aggregate_fused_shape``): the slab of z columns a thread block walks
   the edges for, and the thread-block cluster that splits a destination
   block's slabs, under the card's shared-memory budget, with the same
   pipelined max(load, compute) structure (Eq. 6) against the card's HBM
   and host-link rates. Its choice is reported, not wired into the
   kernels: their shapes stay as ``aggregate_fused_shape`` picks them.

The module is plain Python (no torch), so the DSE runs where no card is.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.gnn import GNNModelConfig, GraphDatasetConfig


# ---------------------------------------------------------------------------
# Platform metadata (paper Table 3 / API Platform_Metadata())
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FPGAMetadata:
    """Xilinx Alveo U250 (paper Listing 1: 4 SLRs)."""

    n_dsp: int = 12_288
    n_lut: int = 1_692_000
    dies: int = 4
    freq: float = 300e6
    ddr_bw: float = 77e9          # bytes/s
    simd: int = 16                # 512-bit / fp32


@dataclass(frozen=True)
class PlatformMetadata:
    num_devices: int = 4
    pcie_bw: float = 16e9         # bytes/s per device link
    host_bw: float = 205e9        # CPU memory bandwidth (EPYC 7763)
    fpga: FPGAMetadata = field(default_factory=FPGAMetadata)


# Calibrated resource coefficients (Eqs. 1-2), fit to paper Table 5.
LAMBDA_UPDATE = 4.96      # DSPs per update PE (lambda_1 * m)
LAMBDA_AGG = 112.6        # DSPs per scatter-gather PE (lambda_2 * n)
RHO_UPDATE = 461.0        # LUTs per update PE
RHO_AGG = 19_223.0        # LUTs per scatter-gather PE
RHO_ROUTE = 5_000.0       # LUTs per n*log2(n) routing-network unit


@dataclass
class MiniBatchShape:
    """|V^l| and |A^l| per layer (paper §6 input)."""

    v: List[int]   # len L+1, deepest first
    a: List[int]   # len L, edges into layer l+1
    f: List[int]   # feature dims, len L+1


def expected_unique(draws: int, population: int) -> int:
    """E[#unique] when sampling ``draws`` with replacement from population."""
    if population <= 0:
        return 0
    return int(population * (1.0 - (1.0 - 1.0 / population) ** draws))


def minibatch_shape(model: GNNModelConfig, ds: GraphDatasetConfig,
                    partition_vertices: Optional[int] = None) -> MiniBatchShape:
    pop = partition_vertices or ds.num_vertices
    v = [model.batch_targets]
    a = []
    for fan in model.fanouts:
        a.append(v[-1] * fan)
        v.append(expected_unique(v[-1] * fan, pop) + v[-1])
    v = v[::-1]
    a = a[::-1]
    f = [ds.feat_dim] + [model.hidden] * (model.num_layers - 1) + [ds.num_classes]
    return MiniBatchShape(v, a, f)


# ---------------------------------------------------------------------------
# 1) Faithful FPGA DSE (paper Eqs. 1-9, Algorithm 4)
# ---------------------------------------------------------------------------

class FPGADSE:
    def __init__(self, platform: PlatformMetadata = PlatformMetadata()):
        self.pf = platform

    # Eq. (1)-(2)
    def resources_ok(self, n: int, m: int) -> bool:
        fpga = self.pf.fpga
        dsp = LAMBDA_UPDATE * m + LAMBDA_AGG * n
        lut = (RHO_UPDATE * m + RHO_AGG * n
               + RHO_ROUTE * n * max(math.log2(max(n, 2)), 1.0))
        return dsp <= fpga.n_dsp and lut <= fpga.n_lut

    def utilization(self, n: int, m: int) -> Dict[str, float]:
        fpga = self.pf.fpga
        dsp = LAMBDA_UPDATE * m + LAMBDA_AGG * n
        lut = (RHO_UPDATE * m + RHO_AGG * n
               + RHO_ROUTE * n * max(math.log2(max(n, 2)), 1.0))
        return {"dsp": dsp / fpga.n_dsp, "lut": lut / fpga.n_lut}

    # Eq. (6)-(9)
    def layer_time(self, n: int, m: int, v_in: int, a: int, f_in: int,
                   f_out: int, beta: float, s_feat: int = 4) -> Tuple[float, float]:
        fpga = self.pf.fpga
        t_load = (v_in * beta * f_in * s_feat / fpga.ddr_bw
                  + v_in * (1 - beta) * f_in * s_feat / self.pf.pcie_bw)
        t_compute = a * f_in / (n * fpga.simd * fpga.freq)
        t_agg = max(t_load, t_compute)                       # Eq. (6)
        t_update = v_in * f_in * f_out / (m * fpga.freq)     # Eq. (9) (v_out~v_in pipelined)
        return t_agg, t_update

    def gnn_time(self, n: int, m: int, mb: MiniBatchShape, beta: float) -> float:
        t_fp = 0.0
        for l in range(len(mb.a)):
            t_agg, t_upd = self.layer_time(
                n, m, mb.v[l], mb.a[l], mb.f[l], mb.f[l + 1], beta)
            t_fp += max(t_agg, t_upd)                        # pipelined stages
        t_lc = mb.v[-1] * mb.f[-1] / (m * self.pf.fpga.freq)
        t_bp = 2.0 * t_fp                                    # fwd-like passes
        return t_fp + t_lc + t_bp                            # Eq. (5)

    # Eq. (3)-(4)
    def throughput(self, n: int, m: int, mb: MiniBatchShape, beta: float,
                   t_sampling: float = 0.0, grad_bytes: int = 4 * 300_000
                   ) -> float:
        p = self.pf.num_devices
        t_exec = max(t_sampling, self.gnn_time(n, m, mb, beta))
        t_sync = 2 * grad_bytes / self.pf.pcie_bw
        t_parallel = t_exec + t_sync
        vertices = sum(mb.v) * p
        return vertices / t_parallel

    # Algorithm 4
    def search(self, mb: MiniBatchShape, beta: float = 0.8,
               n_step: int = 1, m_step: int = 64) -> dict:
        fpga = self.pf.fpga
        n_max = int(fpga.n_dsp / LAMBDA_AGG)
        m_max = int(fpga.n_dsp / LAMBDA_UPDATE)
        best = {"n": 0, "m": 0, "throughput": 0.0}
        grid = []
        for n in range(n_step, n_max + 1, n_step):
            for m in range(m_step, m_max + 1, m_step):
                if not self.resources_ok(n, m):
                    continue
                thr = self.throughput(n, m, mb, beta)
                grid.append((n, m, thr))
                if thr > best["throughput"]:
                    best = {"n": n, "m": m, "throughput": thr,
                            **self.utilization(n, m)}
        best["grid"] = grid
        return best


# ---------------------------------------------------------------------------
# 2) H100 DSE: the fused kernel's slab and cluster under the smem budget
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class H100Metadata:
    """NVIDIA H100 SXM, published rates."""

    fp32_flops: float = 67e12
    tf32_flops: float = 495e12     # tensor cores, dense
    hbm_bw: float = 3.35e12        # bytes/s
    sms: int = 132
    smem_bytes: int = 232_448      # dynamic shared memory a thread block
    host_bw: float = 64e9          # host link: PCIe Gen5 x16


# aggregate_fused (csrc/aggregate_fused.cu, csrc/fused_walk.cuh): the slabs
# it is built for, the portable cluster size, a destination block's rows
# (BLK) and a thread block's output columns (NB), and the walk's constants
H100_SLABS = (32, 128, 160)
H100_MAX_CLUSTER = 8
_BLK = 128
_NB = 128
_LDW = _NB + 8      # the w slab's row stride
_LDP = _NB + 8      # the partial's row stride
_THREADS = 512
_WARPS = _THREADS // 32
_CHUNK = 2048


class H100DSE:
    """Pick (slab, cluster) of ``aggregate_fused`` so the pipelined
    max(load, compute) time of the aggregation layers (Eq. 6 analogue) is
    minimized under the card's shared memory a thread block."""

    def __init__(self, meta: H100Metadata = H100Metadata()):
        self.meta = meta

    def smem_bytes(self, slab: int) -> int:
        """Dynamic shared memory of one ``aggregate_fused`` thread block
        for a slab of ``slab`` z columns: ``smem_bytes`` of
        ``csrc/aggregate_fused.cu`` (the larger of the walk's carve — the
        z tile, the w slab, the chunk's edges and the row counts — and the
        partial a cluster rank hands on)."""
        walk = (4 * (_BLK * (slab + 4) + slab * _LDW)
                + (4 + 4) * _CHUNK                       # src, weight
                + 4 * (2 * _BLK + 1 + _WARPS * _BLK)     # row counts
                + (2 + 1) * _CHUNK)                      # order, row
        part = 4 * _BLK * _LDP
        return max(walk, part)

    def agg_layer_time(self, slab: int, cluster: int, v_in: int, v_out: int,
                       a: int, f_in: int, f_out: int, beta: float) -> float:
        m = self.meta
        # input rows: the resident fraction beta at HBM rate, the misses
        # over the host link
        t_load = (v_in * f_in * 4) * (beta / m.hbm_bw + (1 - beta) / m.host_bw)
        # grid: (cluster, destination blocks, output tiles), one thread
        # block an SM; a rank with no slab idles, and the card holds only
        # whole clusters
        n_dstb = -(-v_out // _BLK)
        n_tiles = -(-f_out // _NB)
        slabs = -(-f_in // slab)
        busy = min(min(cluster, slabs) * n_dstb * n_tiles,
                   (m.sms // cluster) * cluster)
        # each edge is walked once a slab and an output tile (its slab of
        # h, its source and weight); z_slab @ w_slab runs 3xTF32
        walk = a * slabs * (slab * 4 + 8) * n_tiles
        update = 2 * n_dstb * _BLK * slabs * slab * f_out
        t_compute = ((walk / m.hbm_bw + 3 * update / m.tf32_flops)
                     * m.sms / busy)
        return max(t_load, t_compute)

    def search(self, mb: MiniBatchShape, beta: float = 0.8) -> dict:
        best = None
        for slab in H100_SLABS:
            if self.smem_bytes(slab) > self.meta.smem_bytes:
                continue
            for cluster in range(1, H100_MAX_CLUSTER + 1):
                t = sum(self.agg_layer_time(slab, cluster, mb.v[l],
                                            mb.v[l + 1], mb.a[l], mb.f[l],
                                            mb.f[l + 1], beta)
                        for l in range(len(mb.a)))
                if best is None or t < best["t_agg"]:
                    best = {"slab": slab, "cluster": cluster, "t_agg": t,
                            "smem": self.smem_bytes(slab)}
        return best

"""Device profile of one GNN training iteration.

    PYTHONPATH=src python -m repro_torch.launch.profile_gnn [--models gat graphsage]
        [--backend reference] [--scale 18] [--rows 12] [--device cuda]

For each model, builds the paper-width trainer (2 layers, hidden 128,
fanouts (25, 10), 1024 targets, DistDGL, p = 1, the resident feature
path) on ``scaled_dataset("reddit", scale)``, runs two iterations to warm
up (fewer on a graph with fewer iterations an epoch), then traces the
next with ``torch.profiler`` (device activity only on the card) and
prints its ``rows`` costliest kernels by device time and the total.
``--device cpu`` traces the CPU's operators instead.
"""
from __future__ import annotations

import argparse

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.trainer import SyncGNNTrainer
from repro_torch.data.graphs import scaled_dataset


def profile_iteration(graph, model: str, backend: str, device: str,
                      rows: int) -> str:
    """The profiler's table of one steady iteration of ``model``."""
    cfg = GNNModelConfig(model, num_layers=2, hidden=128, fanouts=(25, 10),
                         batch_targets=1024, aggregate_backend=backend)
    tr = SyncGNNTrainer(graph, cfg, num_devices=1, device=device,
                        data_parallel=True)
    *warm, traced = list(sched.iterations(tr.epoch_schedule()))[:3]
    for group in warm:
        tr.run_iteration(group)
    cuda = tr.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        tr.run_iteration(traced)
        if cuda:
            torch.cuda.synchronize()
    key = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    return prof.key_averages().table(sort_by=key, row_limit=rows,
                                     max_name_column_width=70)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=["gat", "graphsage"])
    ap.add_argument("--backend", default="reference")
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--rows", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    graph = scaled_dataset("reddit", scale=args.scale, seed=0)
    for model in args.models:
        print(f"{model} on {args.backend!r}, one iteration", flush=True)
        print(profile_iteration(graph, model, args.backend, args.device,
                                args.rows), flush=True)


if __name__ == "__main__":
    main()

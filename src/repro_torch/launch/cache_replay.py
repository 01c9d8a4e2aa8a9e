"""Host-only replay of the feature cache over an epoch schedule.

    PYTHONPATH=src python -m repro_torch.launch.cache_replay [--scale 17]
        [--devices 4] [--capacity-share 4] [--refresh-every 0] [--epochs 3]

Builds the paper-width GraphSAGE configuration (fanouts (25, 10), 1024
targets) on ``scaled_dataset("reddit", scale)`` under DistDGL with
``devices`` devices, a ``FeatureCache`` of a ``capacity-share``-th of the
smallest static share, and feeds it each epoch's batches in the
trainer's order (round-robin: each batch on its scheduled device), with
no training and no card. Prints one JSON line an epoch: the hit rate and
miss rows an iteration the trainer's ``cache_hit_rate`` and
``miss_bytes_per_iter`` (/ f x 4) would report, the largest miss count
of a batch, the admissions and the generation. Numpy only.
"""
from __future__ import annotations

import argparse
import json
from typing import List

import numpy as np

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core import scheduler as sched
from repro_torch.core.feature_cache import FeatureCache
from repro_torch.core.feature_store import FeatureStore
from repro_torch.core.partition import get_partitioner
from repro_torch.core.sampler import NeighborSampler
from repro_torch.data.graphs import Graph, scaled_dataset


def replay(graph: Graph, cfg: GNNModelConfig, devices: int, capacity: int,
           refresh_every: int = 0, epochs: int = 3,
           seed: int = 0) -> List[dict]:
    """Per-epoch cache accounting of a host-gather, round-robin DistDGL
    run with this cache, as ``SyncGNNTrainer`` counts it."""
    part = get_partitioner("metis_like")(graph, devices, seed)
    store = FeatureStore(graph, part, "distdgl")
    cache = FeatureCache(store.core, graph.out_degree(), capacity,
                         refresh_every)

    def train_ids(i):
        ids = graph.train_ids[part.assignment[graph.train_ids] == i]
        return ids if len(ids) else graph.train_ids[:1]
    samplers = [NeighborSampler(graph, cfg, train_ids(i), i, seed)
                for i in range(devices)]
    groups = list(sched.iterations(sched.two_stage_schedule(
        [s.epoch_batches() for s in samplers])))
    out, it = [], 0
    try:
        for epoch in range(epochs):
            for s in samplers:
                s.reset_epoch()  # the trainer's epoch starts with a reset
            cache.start_epoch()
            hits = rows = most = 0
            for group in groups:
                batches = [samplers[a.partition].batch_at(
                    samplers[a.partition].epoch, a.batch_index)
                    for a in group]
                for a, mb in zip(group, batches):
                    valid = np.asarray(mb.node_mask[0], bool)
                    miss = store.core.miss_count(
                        a.device, np.asarray(mb.nodes[0]), valid)
                    rows += int(valid.sum())
                    hits += int(valid.sum()) - miss
                    most = max(most, miss)
                for mb in batches:
                    cache.observe(mb.nodes[0], mb.node_mask[0])
                cache.end_iteration(it)
                it += 1
            out.append({"epoch": epoch,
                        "hit_rate": hits / rows if rows else 1.0,
                        "miss_rows_per_iter": (rows - hits) / len(groups),
                        "max_miss_rows": most,
                        "admissions": cache.admissions_epoch,
                        "generation": cache.generation})
    finally:
        cache.close()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=17)
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--capacity-share", type=int, default=4)
    ap.add_argument("--refresh-every", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()
    graph = scaled_dataset("reddit", scale=args.scale, seed=0)
    cfg = GNNModelConfig("graphsage", num_layers=2, hidden=128,
                         fanouts=(25, 10), batch_targets=1024)
    part = get_partitioner("metis_like")(graph, args.devices, 0)
    shares = [int((part.assignment == d).sum()) for d in range(args.devices)]
    capacity = min(shares) // args.capacity_share
    print(json.dumps({"scale": args.scale, "devices": args.devices,
                      "static_shares": shares, "capacity": capacity}))
    for row in replay(graph, cfg, args.devices, capacity,
                      args.refresh_every, args.epochs):
        print(json.dumps(row))


if __name__ == "__main__":
    main()

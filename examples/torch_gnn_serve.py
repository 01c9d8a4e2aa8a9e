"""Train a GNN with the PyTorch port, then serve target-node inference
requests through the same fault-tolerant host substrate: requests coalesce
into SLO-bounded micro-batches on the supervised sampler pool, and each
bucket of the ladder runs one CUDA graph on the card, captured at warm-up,
so steady-state serving builds nothing new whatever sizes arrive.

  PYTHONPATH=src python examples/torch_gnn_serve.py [--workers 2] [--slo-ms 50]
  PYTHONPATH=src python examples/torch_gnn_serve.py --device cpu --workers 0

The counterpart of ``examples/gnn_serve.py``; ``--device`` defaults to the
card (``cuda``), and ``cpu`` runs the eager forward on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs.gnn import GNNModelConfig, PlatformConfig
from repro_torch.core.serving import closed_loop_load
from repro_torch.data.graphs import synthetic_graph
from repro_torch.gnn import serve, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=11)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--workers", type=int, default=2,
                    help="sampler-pool workers for serving (0 = in-process)")
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=25,
                    help="requests per client in the load loop")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    graph = synthetic_graph(scale=args.scale, feat_dim=32, num_classes=8,
                            seed=0)
    cfg = GNNModelConfig("graphsage", fanouts=(5, 5), batch_targets=128)
    platform = PlatformConfig(num_devices=2)

    print(f"# training {cfg.name} on {graph.name} "
          f"({graph.num_vertices} vertices) on {args.device} ...")
    with train(cfg, platform, graph=graph, epochs=args.epochs,
               device=args.device) as result:
        print(f"# trained: loss={result.final.get('loss', 0):.4f} "
              f"acc={result.final.get('acc', 0):.3f}")
        with serve(cfg, graph=graph, params=result.params,
                   slo_ms=args.slo_ms, num_workers=args.workers,
                   device=args.device) as server:
            print(f"# serving: buckets={server.buckets} "
                  f"warmup_builds={server.forward_compiles}")

            # one synchronous request
            ids = np.asarray(graph.train_ids[:3], np.int32)
            logits = server.predict(ids)
            print(f"# predict({ids.tolist()}) -> "
                  f"classes {np.argmax(logits, axis=1).tolist()}")

            # a few concurrent requests through the coalescing frontend
            futs = [server.submit([int(v)]) for v in graph.train_ids[:8]]
            for f in futs:
                f.result(timeout=60)

            # closed-loop load: N clients submit back-to-back
            point = closed_loop_load(server, graph.train_ids,
                                     clients=args.clients,
                                     requests_per_client=args.requests)
            print(f"# load: {point['offered_rps']:.0f} req/s  "
                  f"p50={point['p50_ms']:.1f}ms p99={point['p99_ms']:.1f}ms "
                  f"slo_miss={point['slo_miss_rate']:.1%}")
            stats = server.stats()
            print(f"# builds after load: {stats['forward_compiles']} "
                  f"(steady-state builds: "
                  f"{stats['forward_compiles'] - len(server.buckets)})")


if __name__ == "__main__":
    main()

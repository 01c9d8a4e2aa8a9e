"""Paper Listing-1 workflow through the port's HitGNN high-level APIs: state
the algorithm, the model and the platform, run the DSE engine (the paper's
FPGA model and its H100 instantiation), train on the card, save the model,
then project scalability to 16 accelerators with the simulator (paper
Fig. 8).

  PYTHONPATH=src python examples/torch_dse_and_simulate.py
  PYTHONPATH=src python examples/torch_dse_and_simulate.py --device cpu

The counterpart of ``examples/dse_and_simulate.py``; ``--device`` defaults
to the card (``cuda``), and ``cpu`` trains on the plain PyTorch path.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.gnn import DATASETS, GNNModelConfig
from repro_torch.core.abstraction import HitGNN
from repro_torch.core.simulator import SimConfig, scaling_curve
from repro_torch.data.graphs import scaled_dataset


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    ### Design phase (paper Listing 1) ###
    hit = HitGNN()
    hit.Graph_Partition("metis_like", p=4)
    hit.Feature_Storing("distdgl")
    hit.GNN_Computation("graphsage")
    hit.GNN_Parameters(L=2, hidden=[128], fanouts=(25, 10),
                       batch_targets=1024)
    hit.Platform_Metadata(num_devices=4)
    design = hit.Generate_Design(DATASETS["ogbn-products"], beta=0.8)
    f = design["fpga"]
    print(f"DSE (FPGA model): n={f['n']} agg PEs, m={f['m']} update PEs, "
          f"throughput={f['throughput']/1e6:.1f}M NVTPS "
          f"(dsp={f.get('dsp', 0):.0%} lut={f.get('lut', 0):.0%})")
    h = design["h100"]
    print(f"DSE (H100): aggregate_fused slab={h['slab']} z columns, "
          f"cluster={h['cluster']} thread blocks, "
          f"smem={h['smem']} B a block, "
          f"modelled t_agg={h['t_agg']*1e3:.3f} ms")

    ### Runtime phase ###
    hit.LoadInputGraph(scaled_dataset("ogbn-products", scale=10))
    history = hit.Start_training(epochs=3, lr=5e-3, device=args.device)
    for i, m in enumerate(history):
        print(f"epoch {i}: loss={m['loss']:.3f} acc={m['acc']:.2f} "
              f"NVTPS={m['nvtps']:.0f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = hit.Save_model(os.path.join(tmp, "hitgnn.npz"))
        print(f"saved {path} ({os.path.getsize(path)} bytes)")

    ### Scalability projection (paper Fig. 8) ###
    cfg = GNNModelConfig("graphsage", 2, 128, (25, 10), 1024)
    print("\nscaling (simulator, paper platform constants):")
    for r in scaling_curve(cfg, DATASETS["ogbn-products"], 0.8,
                           SimConfig(), max_p=16)[::3]:
        bar = "#" * int(r["speedup"])
        print(f"  p={r['p']:2d} speedup={r['speedup']:5.2f} {bar}")


if __name__ == "__main__":
    main()

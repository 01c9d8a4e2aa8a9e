"""HitGNN high-level APIs (paper Table 2, Listing 1/2), counterpart of
``repro.core.abstraction``.

The paper's pitch: a synchronous GNN training algorithm is expressible in a
handful of lines — (graph partitioning, feature storing) + a GNN model +
platform metadata; the framework does the rest. This module is that facade
over the port's building blocks, keeping the paper's API names:

    hit = HitGNN()
    hit.Graph_Partition("metis_like", p=4)           # Graph APIs
    hit.Feature_Storing("distdgl")
    hit.GNN_Computation("graphsage")                 # GNN APIs
    hit.GNN_Parameters(L=2, hidden=[128])
    hit.Platform_Metadata(num_devices=4)             # Host APIs
    design = hit.Generate_Design()
    hit.LoadInputGraph(graph)
    hit.Start_training(epochs=10)                    # on the card
    hit.Save_model("out.npz")

``Generate_Design`` runs the DSE engine: the paper's FPGA model and the
H100 instantiation (``core/dse.py``). ``Start_training`` builds the port's
``SyncGNNTrainer``, which runs on the card unless ``device="cpu"`` is
passed, and raises without CUDA otherwise. ``Save_model`` writes the
reference's npz: the parameters in the reference's tree order under the
keys "0", "1", ....
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.checkpoint.checkpointing import (Checkpointer,
                                                  flatten_with_paths)
from repro_torch.configs.gnn import GNNModelConfig, GraphDatasetConfig
from repro_torch.core.dse import (FPGADSE, H100DSE, FPGAMetadata,
                                  H100Metadata, PlatformMetadata,
                                  minibatch_shape)
from repro_torch.core.trainer import SyncGNNTrainer
from repro_torch.data.graphs import Graph


class HitGNN:
    """The user-facing framework object (paper Fig. 3 workflow)."""

    def __init__(self):
        self._partitioner = "metis_like"
        self._storing = "distdgl"
        self._model_name = "graphsage"
        self._L = 2
        self._hidden = [128]
        self._fanouts = (25, 10)
        self._batch_targets = 1024
        self._platform = PlatformMetadata()
        self._h100 = H100Metadata()
        self._p = 4
        self._graph: Optional[Graph] = None
        self._trainer: Optional[SyncGNNTrainer] = None
        self._design: Optional[dict] = None

    # -- Graph APIs -------------------------------------------------------------
    def Graph_Partition(self, strategy: str, p: int):
        self._partitioner = strategy
        self._p = p
        return self

    def Feature_Storing(self, strategy: str):
        self._storing = strategy
        return self

    # -- GNN APIs ---------------------------------------------------------------
    def GNN_Computation(self, model: str):
        self._model_name = model
        return self

    def GNN_Parameters(self, L: int, hidden: List[int],
                       fanouts=(25, 10), batch_targets: int = 1024):
        self._L = L
        self._hidden = hidden
        self._fanouts = tuple(fanouts)
        self._batch_targets = batch_targets
        return self

    def GNN_Model(self) -> GNNModelConfig:
        return GNNModelConfig(self._model_name, self._L, self._hidden[0],
                              self._fanouts, self._batch_targets)

    # -- Host APIs ----------------------------------------------------------------
    def Platform_Metadata(self, num_devices: int = 4, **kw):
        self._platform = PlatformMetadata(num_devices=num_devices, **kw)
        self._p = num_devices
        return self

    def FPGA_Metadata(self, **kw):
        self._platform = PlatformMetadata(
            num_devices=self._p, fpga=FPGAMetadata(**kw))
        return self

    def Generate_Design(self, dataset_stats: Optional[GraphDatasetConfig] = None,
                        beta: float = 0.8) -> dict:
        """Run the DSE engine; returns the chosen accelerator configuration
        (paper Algorithm 4) of the FPGA model and the H100 instantiation
        (``aggregate_fused``'s slab and cluster)."""
        model = self.GNN_Model()
        ds = dataset_stats or GraphDatasetConfig(
            "user", self._graph.num_vertices if self._graph else 1 << 20,
            self._graph.num_edges if self._graph else 1 << 24,
            self._graph.features.shape[1] if self._graph else 128,
            self._hidden[0],
            self._graph.num_classes if self._graph else 32)
        mb = minibatch_shape(model, ds)
        fpga = FPGADSE(self._platform).search(mb, beta)
        fpga.pop("grid", None)
        h100 = H100DSE(self._h100).search(mb, beta)
        self._design = {"fpga": fpga, "h100": h100}
        return self._design

    def LoadInputGraph(self, graph: Graph):
        self._graph = graph
        return self

    def Start_training(self, epochs: int = 1, *, algorithm: Optional[str] = None,
                       checkpoint_dir: Optional[str] = None, **trainer_kw):
        """Train ``epochs`` epochs on a new ``SyncGNNTrainer`` (``trainer_kw``
        passes through: ``device=``, ``params=``, ``lr=``, ...), saving a
        checkpoint after each epoch when ``checkpoint_dir`` is given.
        Returns each epoch's metrics."""
        assert self._graph is not None, "LoadInputGraph first"
        algo = algorithm or {"metis_like": "distdgl", "pagraph": "pagraph",
                             "p3": "p3", "hash": "distdgl"}[self._partitioner]
        self._trainer = SyncGNNTrainer(
            self._graph, self.GNN_Model(), self._p, algorithm=algo,
            **trainer_kw)
        ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
        history = []
        for e in range(epochs):
            history.append(self._trainer.run_epoch())
            if ckpt is not None:
                ckpt.save(self._trainer.step_no, self._trainer.params,
                          self._trainer._opt_tree())
        if ckpt is not None:
            ckpt.wait()
        return history

    def Save_model(self, path: str):
        assert self._trainer is not None
        leaves = flatten_with_paths(self._trainer.params).values()
        np.savez(path, **{str(i): v.detach().cpu().numpy()
                          for i, v in enumerate(leaves)})
        return path

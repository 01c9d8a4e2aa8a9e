"""The paper's "handful of lines" entry point (HitGNN Listing 1), the
counterpart of ``repro.gnn.api.train``:

    from repro_torch.gnn.api import train
    from repro_torch.configs.gnn import GNNModelConfig, PlatformConfig

    cfg = GNNModelConfig("graphsage", hidden=128, fanouts=(25, 10),
                         batch_targets=1024, aggregate_backend="pallas_edges")
    result = train(cfg, PlatformConfig(num_devices=1), algorithm="distdgl",
                   graph=g, epochs=1)

The platform's ``num_devices`` sizes the partition and schedule, whose p
batches per iteration run in sequence on one card;
``PlatformConfig(data_parallel=True)`` keeps the p devices' feature shards
on that card (several cards wait for torch.distributed data parallelism,
ROADMAP.md queue A, item A.9). A trainer with sampler workers
(``num_sampler_workers=N``) holds processes and shared-memory segments:
close the result (or use it as a context manager) when done.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.configs.gnn import GNNModelConfig, PlatformConfig
from repro_torch.core.trainer import SyncGNNTrainer
from repro_torch.data.graphs import Graph


@dataclass
class TrainResult:
    """The per-epoch metric dicts plus the live trainer. Close it (or use
    it as a context manager) to tear down the sampler pool."""

    trainer: SyncGNNTrainer
    epochs: List[dict] = field(default_factory=list)

    @property
    def final(self) -> dict:
        return self.epochs[-1] if self.epochs else {}

    @property
    def params(self):
        return self.trainer.params

    def close(self) -> None:
        self.trainer.close()

    def __enter__(self) -> "TrainResult":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def train(model_cfg: GNNModelConfig, platform: PlatformConfig,
          algorithm: str = "distdgl", *, graph: Graph, epochs: int = 1,
          lr: float = 1e-2, seed: int = 0, progress=None,
          **trainer_kwargs) -> TrainResult:
    """Map (algorithm, model, platform) onto the trainer and train for
    ``epochs`` epochs. ``progress(epoch_index, metrics)`` is called after
    each epoch; other keyword arguments pass through to
    :class:`SyncGNNTrainer` (``device=``, ``params=``,
    ``num_sampler_workers=``, ...). On an error the trainer is closed
    before the error propagates."""
    trainer = SyncGNNTrainer(
        graph, model_cfg, num_devices=platform.num_devices,
        algorithm=algorithm, lr=lr, seed=seed,
        data_parallel=platform.data_parallel, **trainer_kwargs)
    result = TrainResult(trainer)
    try:
        for e in range(epochs):
            m = trainer.run_epoch()
            result.epochs.append(m)
            if progress is not None:
                progress(e, m)
    except BaseException:
        trainer.close()
        raise
    return result

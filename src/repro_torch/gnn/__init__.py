"""GNN model zoo and the paper's top-level facades (counterpart of
``repro.gnn``).

``repro_torch.gnn.train`` / ``evaluate`` (:mod:`repro_torch.gnn.api`) and
``serve`` / ``GNNServer`` (:mod:`repro_torch.gnn.serving`) import lazily,
so ``from repro_torch.gnn import models`` stays cycle-free (the trainer
itself imports the model zoo).
"""


def __getattr__(name):
    if name in ("train", "TrainResult", "evaluate"):
        from repro_torch.gnn import api
        return getattr(api, name)
    if name in ("serve", "GNNServer"):
        from repro_torch.gnn import serving
        return getattr(serving, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

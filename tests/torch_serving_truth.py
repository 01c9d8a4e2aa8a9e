"""The ground truth a serving request is held against: the eager forward
over request ``rid``'s batch, built without the runtime from the same RNG
coordinates (``SERVE_EPOCH``, ``rid``) and the bucket's cyclic pad. The
serving tests and ``chip_smoke.py`` both use it, so it imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sampler import NeighborSampler
from repro_torch.core.serving import SERVE_EPOCH
from repro_torch.core.trainer import batch_to_arrays
from repro_torch.gnn import models as gnn_models


def request_arrays(rt, ids: np.ndarray, rid: int) -> dict:
    """Request ``rid``'s batch for ``ids``, padded cyclically to its
    bucket, gathered from ``rt``'s store and placed on ``rt``'s device."""
    m = len(ids)
    bucket = rt.batcher.bucket_for(m)
    sampler = NeighborSampler(rt.graph, rt.cfg, rt.graph.train_ids, 0,
                              rt.seed)
    mb = sampler.request_batch(SERVE_EPOCH, rid, ids[np.arange(bucket) % m])
    feats = rt.store.gather(0, mb.nodes[0], mb.node_mask[0])
    return batch_to_arrays(mb, feats, rt.device)


def eager_forward(rt, batch: dict) -> torch.Tensor:
    """The eager forward of ``rt``'s model and parameters over ``batch``."""
    with torch.no_grad():
        return gnn_models.forward(rt.cfg, rt.params, batch)


def ground_truth(rt, ids: np.ndarray, rid: int) -> np.ndarray:
    """The logits request ``rid`` for ``ids`` must answer, as numpy."""
    out = eager_forward(rt, request_arrays(rt, ids, rid))
    return out.cpu().numpy()[:len(ids)]

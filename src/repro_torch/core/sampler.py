"""Host-side layered neighbor sampler (copy of ``repro.core.sampler``)
producing static-shape padded mini-batches.

HitGNN task split (paper §4.2): sampling runs on the host CPU over the full
topology; the device consumes a MiniBatch of padded per-layer blocks. The
RNG streams are the reference's, so the same (seed, partition, epoch,
index) gives the bitwise-same batch in both packages, in any process (the
sampler pool's workers materialize batches by their coordinates).
``request_batch`` and ``pad_minibatch`` are the serving path's explicit-
target batches, which the sampler pool's task format carries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.data.graphs import Graph, sample_in_neighbors


@dataclass
class MiniBatch:
    """L-layer sampled block. Layer l edges connect layer_nodes[l] (src side,
    layer l-1 vertex ids) to layer_nodes[l+1]'s prefix.

    nodes[l]      (N_l,) int32 global vertex ids, padded (pad = repeat of 0)
    node_mask[l]  (N_l,) bool
    edge_src[l]   (E_l,) int32 LOCAL index into nodes[l]
    edge_dst[l]   (E_l,) int32 LOCAL index into nodes[l+1]
    edge_mask[l]  (E_l,) bool
    self_idx[l]   index of nodes[l+1][j] within nodes[l]
    targets       (T,) int32 global ids of the target vertices
    labels        (T,) int32
    """

    nodes: List[np.ndarray]
    node_mask: List[np.ndarray]
    edge_src: List[np.ndarray]
    edge_dst: List[np.ndarray]
    edge_mask: List[np.ndarray]
    self_idx: List[np.ndarray]
    targets: np.ndarray
    labels: np.ndarray
    partition_id: int = 0
    seq_no: int = 0

    def vertices_traversed(self) -> int:
        """Paper throughput metric numerator: sum_l |V^l| (real, unpadded)."""
        return int(sum(m.sum() for m in self.node_mask)
                   + len(self.targets))

    def edges_traversed(self) -> int:
        return int(sum(m.sum() for m in self.edge_mask))

    def work_estimate(self) -> float:
        """Per-batch load estimate (paper Eq. 5)."""
        return float(self.vertices_traversed() + self.edges_traversed())


def layer_capacities_for(batch_targets: int, fanouts: Sequence[int]
                         ) -> Tuple[List[int], List[int]]:
    """Static padded sizes per layer: node caps + edge caps (fanout bound),
    in input->output order (nodes[0] is the deepest layer)."""
    n_caps = [int(batch_targets)]
    e_caps = []
    for fan in fanouts:
        e_caps.append(n_caps[-1] * fan)
        n_caps.append(n_caps[-1] * (fan + 1))
    return n_caps[::-1], e_caps[::-1]


def layer_capacities(cfg: GNNModelConfig) -> Tuple[List[int], List[int]]:
    """Layer capacities at the config's full training batch shape."""
    return layer_capacities_for(cfg.batch_targets, cfg.fanouts)


class NeighborSampler:
    """Samples mini-batches from one graph partition's train vertices.

    Every batch draws from a counter-based stream derived from
    ``(seed, partition_id, epoch, batch_index)`` via
    ``np.random.SeedSequence``; the epoch permutation has its own stream
    (tag 0; batches use tag ``index + 1``).
    """

    def __init__(self, graph: Graph, cfg: GNNModelConfig,
                 train_ids: np.ndarray, partition_id: int = 0, seed: int = 0):
        self.g = graph
        self.cfg = cfg
        self.train_ids = np.asarray(train_ids, np.int32)
        self.partition_id = partition_id
        self.seed = seed
        self.node_caps, self.edge_caps = layer_capacities(cfg)
        self.epoch = 0
        self._epoch_order: np.ndarray = self._permutation(0)
        self._cursor = 0
        self._seq = 0
        self._perm_cache: Tuple[int, np.ndarray] = (0, self._epoch_order)

    def _stream(self, epoch: int, tag: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            (self.seed, self.partition_id, epoch, tag)))

    def _permutation(self, epoch: int) -> np.ndarray:
        return self._stream(epoch, 0).permutation(self.train_ids)

    def reset_epoch(self) -> None:
        self.epoch += 1
        self._epoch_order = self._permutation(self.epoch)
        self._perm_cache = (self.epoch, self._epoch_order)
        self._cursor = 0

    def state(self) -> dict:
        """Mid-epoch cursor state for checkpointing — everything mutable;
        the epoch permutation is NOT stored (it regenerates bit-exactly
        from the counter-based stream in :meth:`restore_state`)."""
        return {"epoch": self.epoch, "cursor": self._cursor,
                "seq": self._seq}

    def restore_state(self, state: dict) -> None:
        """Inverse of :meth:`state`: rebuilds the epoch permutation from
        the RNG counters, so a restored sampler continues the interrupted
        epoch bit-identically."""
        self.epoch = int(state["epoch"])
        self._epoch_order = self._permutation(self.epoch)
        self._perm_cache = (self.epoch, self._epoch_order)
        self._cursor = int(state["cursor"])
        self._seq = int(state["seq"])

    def batches_remaining(self) -> int:
        return (len(self._epoch_order) - self._cursor
                + self.cfg.batch_targets - 1) // self.cfg.batch_targets

    def epoch_batches(self, epoch: int | None = None) -> int:
        """Total batches one full epoch yields (independent of the cursor)."""
        del epoch  # every epoch permutes the same train set
        return (len(self.train_ids) + self.cfg.batch_targets - 1) \
            // self.cfg.batch_targets

    def _sample_layer(self, frontier: np.ndarray, fanout: int,
                      rng: np.random.Generator
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        src, dst = sample_in_neighbors(self.g.indptr, self.g.indices,
                                       frontier, fanout, rng)
        uniq = np.unique(np.concatenate([frontier.astype(np.int32), src]))
        return src, dst, uniq

    def batch_at(self, epoch: int, index: int) -> MiniBatch:
        """Materialize epoch ``epoch``'s batch ``index`` (location-
        independent); ``seq_no`` carries ``index``."""
        cfg = self.cfg
        cached_epoch, cached_order = self._perm_cache
        if epoch == cached_epoch:
            order = cached_order
        else:
            order = self._permutation(epoch)
            self._perm_cache = (epoch, order)
        lo = index * cfg.batch_targets
        if lo >= len(order) or index < 0:
            raise IndexError(
                f"batch index {index} out of range for epoch of "
                f"{self.epoch_batches()} batches (partition "
                f"{self.partition_id})")
        targets = order[lo:lo + cfg.batch_targets]
        return self._materialize(targets, self._stream(epoch, index + 1),
                                 seq_no=index)

    def next_batch(self) -> MiniBatch:
        """The next batch of the cursor's epoch (a new epoch starts when the
        current one is drained)."""
        if self._cursor >= len(self._epoch_order):
            self.reset_epoch()
        index = self._cursor // self.cfg.batch_targets
        self._cursor += self.cfg.batch_targets
        mb = self.batch_at(self.epoch, index)
        mb.seq_no = self._seq
        self._seq += 1
        return mb

    def request_batch(self, epoch: int, index: int,
                      targets: np.ndarray) -> MiniBatch:
        """Materialize an EXPLICIT-TARGET batch at the targets' own shape.

        The serving frontend's twin of :meth:`batch_at`: ``(epoch, index)``
        are pure RNG coordinates (the runtime reserves an epoch value
        disjoint from training epochs and a monotonically increasing
        micro-batch index), so a resubmitted or speculatively re-executed
        request task re-samples the bit-identical neighborhood — the fault
        tolerance contract carries over to serving unchanged. The batch is
        padded to capacities derived from ``len(targets)`` (the bucket
        size), NOT ``cfg.batch_targets``, so each bucket keeps one
        fixed-shape compiled forward."""
        targets = np.asarray(targets, np.int32)
        if not 1 <= len(targets) <= self.cfg.batch_targets:
            raise ValueError(
                f"request batch carries {len(targets)} targets; expected "
                f"1..{self.cfg.batch_targets} (= batch_targets)")
        n_caps, e_caps = layer_capacities_for(len(targets), self.cfg.fanouts)
        return self._materialize(targets, self._stream(epoch, index + 1),
                                 seq_no=index, node_caps=n_caps,
                                 edge_caps=e_caps)

    def _materialize(self, targets: np.ndarray, rng: np.random.Generator,
                     seq_no: int = 0,
                     node_caps: List[int] | None = None,
                     edge_caps: List[int] | None = None) -> MiniBatch:
        cfg = self.cfg
        if node_caps is None:
            node_caps, edge_caps = self.node_caps, self.edge_caps
        targets = np.asarray(targets, np.int32)
        target_cap = node_caps[-1]  # top-layer frontier = the targets
        if len(targets) < target_cap:  # pad tail batch
            pad = rng.choice(self.train_ids,
                             target_cap - len(targets))
            targets = np.concatenate([targets, pad.astype(np.int32)])

        # sample from the top layer down
        frontiers = [targets]
        edges = []
        for fan in cfg.fanouts:
            src, dst, uniq = self._sample_layer(frontiers[-1], fan, rng)
            edges.append((src, dst))
            frontiers.append(uniq)
        # reverse into bottom-up order
        frontiers = frontiers[::-1]
        edges = edges[::-1]

        nodes, node_mask = [], []
        for cap, f in zip(node_caps, frontiers):
            n = np.zeros(cap, np.int32)
            m = np.zeros(cap, bool)
            k = min(len(f), cap)
            n[:k] = f[:k]
            m[:k] = True
            nodes.append(n)
            node_mask.append(m)

        edge_src, edge_dst, edge_mask, self_idx = [], [], [], []
        for li, (cap, (src, dst)) in enumerate(zip(edge_caps, edges)):
            # frontiers[li] is sorted (np.unique) for every li < L, so
            # searchsorted maps global src ids -> local indices vectorized
            base = frontiers[li]
            es = np.zeros(cap, np.int32)
            ed = np.zeros(cap, np.int32)
            em = np.zeros(cap, bool)
            k = min(len(src), cap)
            es[:k] = np.searchsorted(base, src[:k]).astype(np.int32)
            ed[:k] = dst[:k]
            em[:k] = True
            edge_src.append(es)
            edge_dst.append(ed)
            edge_mask.append(em)
            upper = frontiers[li + 1]
            cap_up = node_caps[li + 1]
            si = np.zeros(cap_up, np.int32)
            kk = min(len(upper), cap_up)
            si[:kk] = np.searchsorted(base, upper[:kk]).astype(np.int32)
            self_idx.append(si)

        return MiniBatch(nodes, node_mask, edge_src, edge_dst, edge_mask,
                         self_idx, targets, self.g.labels[targets],
                         self.partition_id, seq_no)


# ---------------------------------------------------------------------------
# Bucket-shape adapters (serving path)
# ---------------------------------------------------------------------------
# Request batches are materialized at BUCKET capacities (see
# NeighborSampler.request_batch) but the sampler-pool ring carries exactly
# one codec geometry — the full training shape. A worker therefore
# zero-pads a bucket batch up to the codec's capacities before encode, and
# the serving consumer slices the decoded batch back down to the bucket
# before the bucket's compiled forward sees it. Padding is all-zeros with
# all-False masks, so slice(pad(mb)) == mb bitwise.

def _pad1(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros(cap, arr.dtype)
    out[:len(arr)] = arr
    return out


def pad_minibatch(mb: MiniBatch, node_caps: Sequence[int],
                  edge_caps: Sequence[int]) -> MiniBatch:
    """Zero-pad a bucket-shaped batch up to ``node_caps``/``edge_caps``
    (the codec's full training geometry). Real content stays a prefix;
    the padding rows carry False masks so every consumer ignores them."""
    t_cap = node_caps[-1]
    return MiniBatch(
        nodes=[_pad1(a, c) for a, c in zip(mb.nodes, node_caps)],
        node_mask=[_pad1(a, c) for a, c in zip(mb.node_mask, node_caps)],
        edge_src=[_pad1(a, c) for a, c in zip(mb.edge_src, edge_caps)],
        edge_dst=[_pad1(a, c) for a, c in zip(mb.edge_dst, edge_caps)],
        edge_mask=[_pad1(a, c) for a, c in zip(mb.edge_mask, edge_caps)],
        self_idx=[_pad1(a, c) for a, c in zip(mb.self_idx, node_caps[1:])],
        targets=_pad1(mb.targets, t_cap),
        labels=_pad1(mb.labels, t_cap),
        partition_id=mb.partition_id, seq_no=mb.seq_no)


def slice_minibatch(mb: MiniBatch, node_caps: Sequence[int],
                    edge_caps: Sequence[int]) -> MiniBatch:
    """Inverse of :func:`pad_minibatch`: take the bucket-sized prefix of
    every array. Exact because the pad was a pure suffix of zeros."""
    t_cap = node_caps[-1]
    return MiniBatch(
        nodes=[a[:c] for a, c in zip(mb.nodes, node_caps)],
        node_mask=[a[:c] for a, c in zip(mb.node_mask, node_caps)],
        edge_src=[a[:c] for a, c in zip(mb.edge_src, edge_caps)],
        edge_dst=[a[:c] for a, c in zip(mb.edge_dst, edge_caps)],
        edge_mask=[a[:c] for a, c in zip(mb.edge_mask, edge_caps)],
        self_idx=[a[:c] for a, c in zip(mb.self_idx, node_caps[1:])],
        targets=mb.targets[:t_cap],
        labels=mb.labels[:t_cap],
        partition_id=mb.partition_id, seq_no=mb.seq_no)

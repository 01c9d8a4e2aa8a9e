"""Graph partitioning strategies (copy of ``repro.core.partition``).

* ``metis_like`` — LDG streaming partitioner minimizing edge cut under
  vertex- and train-vertex-balance constraints (DistDGL's stand-in).
* ``pagraph`` — PaGraph's greedy: balance TRAIN vertices across partitions
  while maximizing neighbor affinity.
* ``p3`` — P3: topology hash-partitioned, FEATURES partitioned along the
  feature dimension (intra-layer model parallelism).
* ``hash`` — baseline random/hash partition.

Bitwise copies of the reference: the same permutation streams give the same
assignment.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.data.graphs import Graph


@dataclass
class Partition:
    """Vertex -> device assignment (+ per-device vertex lists)."""

    assignment: np.ndarray           # (V,) int32 in [0, p)
    num_parts: int
    strategy: str
    # P3 only: feature-dim ownership (device i owns feature slice i)
    feature_dim_partitioned: bool = False

    def part_vertices(self, i: int) -> np.ndarray:
        return np.where(self.assignment == i)[0].astype(np.int32)


def hash_partition(g: Graph, p: int, seed: int = 0) -> Partition:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, p, g.num_vertices).astype(np.int32)
    return Partition(a, p, "hash")


def metis_like_partition(g: Graph, p: int, seed: int = 0,
                         balance_slack: float = 1.05) -> Partition:
    """LDG streaming partitioner with multi-constraint balance (vertices AND
    train vertices), greedy edge-cut minimization."""
    V = g.num_vertices
    rng = np.random.default_rng(seed)
    order = rng.permutation(V)
    assign = np.full(V, -1, np.int32)
    cap_v = V / p * balance_slack
    cap_t = len(g.train_ids) / p * balance_slack
    sizes = np.zeros(p)
    train_sizes = np.zeros(p)
    is_train = np.zeros(V, bool)
    is_train[g.train_ids] = True
    for v in order:
        nbrs = g.neighbors(v)
        scores = np.zeros(p)
        if len(nbrs):
            placed = assign[nbrs]
            placed = placed[placed >= 0]
            if len(placed):
                scores += np.bincount(placed, minlength=p)
        # LDG penalty: discount by fullness; hard multi-constraint caps
        scores = (scores + 1e-3) * (1.0 - sizes / cap_v)
        scores[sizes >= cap_v] = -np.inf
        if is_train[v]:
            scores[train_sizes >= cap_t] = -np.inf
        if not np.isfinite(scores).any():
            tgt = int(np.argmin(sizes))
        else:
            tgt = int(np.argmax(scores))
        assign[v] = tgt
        sizes[tgt] += 1
        if is_train[v]:
            train_sizes[tgt] += 1
    return Partition(assign, p, "metis_like")


def pagraph_partition(g: Graph, p: int, seed: int = 0) -> Partition:
    """PaGraph greedy: iterate train vertices; assign each to the partition
    with the highest (neighbor-affinity - load) score. Non-train vertices
    follow the majority of their placed neighbors (or hash)."""
    V = g.num_vertices
    assign = np.full(V, -1, np.int32)
    train_sizes = np.zeros(p)
    expect = max(1, len(g.train_ids) / p)
    rng = np.random.default_rng(seed)
    for v in rng.permutation(g.train_ids):
        nbrs = g.neighbors(v)
        aff = np.zeros(p)
        if len(nbrs):
            placed = assign[nbrs]
            placed = placed[placed >= 0]
            if len(placed):
                aff = np.bincount(placed, minlength=p).astype(float)
        score = aff - train_sizes * (len(g.train_ids) / (expect * p))
        tgt = int(np.argmax(score))
        assign[v] = tgt
        train_sizes[tgt] += 1
    rest = np.where(assign < 0)[0]
    for v in rest:
        nbrs = g.neighbors(v)
        placed = assign[nbrs]
        placed = placed[placed >= 0]
        assign[v] = (np.bincount(placed, minlength=p).argmax()
                     if len(placed) else v % p)
    return Partition(assign.astype(np.int32), p, "pagraph")


def p3_partition(g: Graph, p: int, seed: int = 0) -> Partition:
    """P3: hash-partitioned topology; features split along the feature dim
    (marked so the feature store and the trainer serve each device's
    feature-dimension slice)."""
    part = hash_partition(g, p, seed)
    return Partition(part.assignment, p, "p3", feature_dim_partitioned=True)


PARTITIONERS = {
    "hash": hash_partition,
    "metis_like": metis_like_partition,
    "pagraph": pagraph_partition,
    "p3": p3_partition,
}


def get_partitioner(name: str):
    return PARTITIONERS[name]

"""Graph substrate (copy of ``repro.data.graphs``): CSR graphs, synthetic
RMAT generation and the scaled stand-ins for the paper's datasets.

Every function here is a bitwise copy of its counterpart: the same numpy
RNG calls in the same order, so a seed gives the same graph in both
packages. The shared-memory residency of the reference (``to_shared``)
waits for the sampler pool.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.gnn import DATASETS


@dataclass
class Graph:
    """CSR graph. ``indptr/indices`` encode IN-neighbors (aggregation reads
    messages from in-neighbors, paper Alg. 1)."""

    indptr: np.ndarray          # (V+1,) int64
    indices: np.ndarray         # (E,) int32  — src vertex of each in-edge
    features: np.ndarray        # (V, f0) float32
    labels: np.ndarray          # (V,) int32
    train_ids: np.ndarray       # (T,) int32
    num_classes: int
    name: str = "synthetic"

    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.num_vertices)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def sample_in_neighbors(indptr: np.ndarray, indices: np.ndarray,
                        frontier: np.ndarray, fanout: int,
                        rng: np.random.Generator
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized fanout-bounded in-neighbor draw over CSR arrays.

    Low-degree destinations (deg <= fanout) keep every in-edge; high-degree
    ones draw exactly ``fanout`` distinct in-neighbors by Floyd's sampling,
    vectorized across vertices. Returns (src_global int32, dst_local int32)
    sorted by (dst, src); ``dst_local`` indexes into ``frontier``. Requires
    distinct src entries per CSR row (``build_graph`` dedups), so the
    sampled pairs are distinct and a sort gives the canonical order.
    """
    frontier = np.asarray(frontier)
    start = indptr[frontier]
    deg = indptr[frontier.astype(np.int64) + 1] - start
    local = np.arange(len(frontier), dtype=np.int64)

    small = deg <= fanout
    cnt = deg[small]
    total = int(cnt.sum())
    if total:
        cum = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        offs = np.repeat(start[small] - cum, cnt) + np.arange(total)
        src_s = indices[offs].astype(np.int64)
        dst_s = np.repeat(local[small], cnt)
    else:
        src_s = np.empty(0, np.int64)
        dst_s = np.empty(0, np.int64)

    big = ~small
    n_big = int(big.sum())
    if n_big:
        # Floyd's algorithm, rows in lockstep: round s considers edge index
        # i = deg-fanout+s per row; draw t ~ U[0, i]; keep t unless an
        # earlier round already chose it, in which case keep i.
        deg_b = deg[big]
        u = rng.random((n_big, fanout))
        chosen = np.empty((n_big, fanout), np.int64)
        for s in range(fanout):
            i_row = deg_b - fanout + s
            t = (u[:, s] * (i_row + 1)).astype(np.int64)
            if s:
                dup = (chosen[:, :s] == t[:, None]).any(axis=1)
                t = np.where(dup, i_row, t)
            chosen[:, s] = t
        offs = (start[big][:, None] + chosen).ravel()
        src_b = indices[offs].astype(np.int64)
        dst_b = np.repeat(local[big], fanout)
    else:
        src_b = np.empty(0, np.int64)
        dst_b = np.empty(0, np.int64)

    src = np.concatenate([src_s, src_b])
    dst = np.concatenate([dst_s, dst_b])
    m = int(src.max()) + 1 if len(src) else 1  # key base covers all src ids
    key = dst * m + src
    key.sort()  # canonical (dst, src) order; pairs are distinct (see above)
    return ((key % m).astype(np.int32), (key // m).astype(np.int32))


def rmat_edges(scale: int, edge_factor: int, rng: np.random.Generator,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> np.ndarray:
    """Recursive-matrix (RMAT/Graph500) edge generator -> (E, 2) int array."""
    n_edges = (1 << scale) * edge_factor
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(n_edges)
        src_bit = r >= ab
        dst_bit = ((r >= a) & (r < ab)) | (r >= abc)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # permute vertex ids to avoid degree locality
    perm = rng.permutation(1 << scale)
    return np.stack([perm[src], perm[dst]], axis=1)


def build_graph(edges: np.ndarray, num_vertices: int, feat_dim: int,
                num_classes: int, rng: np.random.Generator,
                train_frac: float = 0.1, name: str = "synthetic") -> Graph:
    """Build a CSR Graph from an edge list (dedup, no self loops)."""
    e = edges[edges[:, 0] != edges[:, 1]]
    key = e[:, 0].astype(np.int64) * num_vertices + e[:, 1]
    _, idx = np.unique(key, return_index=True)
    e = e[idx]
    dst = e[:, 1]
    order = np.argsort(dst, kind="stable")
    e = e[order]
    indptr = np.zeros(num_vertices + 1, np.int64)
    np.add.at(indptr, e[:, 1] + 1, 1)
    indptr = np.cumsum(indptr)
    indices = e[:, 0].astype(np.int32)
    feats = rng.standard_normal((num_vertices, feat_dim)).astype(np.float32)
    labels = rng.integers(0, num_classes, num_vertices).astype(np.int32)
    # learnable signal: label-correlated feature block
    feats[np.arange(num_vertices), labels % feat_dim] += 2.0
    n_train = max(1, int(num_vertices * train_frac))
    train_ids = rng.choice(num_vertices, n_train, replace=False).astype(np.int32)
    return Graph(indptr, indices, feats, labels, np.sort(train_ids),
                 num_classes, name)


def synthetic_graph(scale: int = 12, edge_factor: int = 8, feat_dim: int = 64,
                    num_classes: int = 16, seed: int = 0,
                    name: str = "synthetic") -> Graph:
    rng = np.random.default_rng(seed)
    edges = rmat_edges(scale, edge_factor, rng)
    return build_graph(edges, 1 << scale, feat_dim, num_classes, rng, name=name)


def scaled_dataset(name: str, scale: int = 12, seed: int = 0) -> Graph:
    """Synthetic stand-in for a paper dataset: same feat/class dims, RMAT
    topology with a matching edge factor, at 2^scale vertices."""
    cfg = DATASETS[name]
    ef = max(2, round(cfg.num_edges / cfg.num_vertices / 2))
    rng = np.random.default_rng(seed)
    edges = rmat_edges(scale, ef, rng)
    return build_graph(edges, 1 << scale, cfg.feat_dim, cfg.num_classes, rng,
                       name=f"{name}-s{scale}")

"""Graph substrate (copy of ``repro.data.graphs``): CSR graphs, synthetic
RMAT generation and the scaled stand-ins for the paper's datasets.

Every function here is a bitwise copy of its counterpart: the same numpy
RNG calls in the same order, so a seed gives the same graph in both
packages. ``Graph.to_shared`` copies the arrays once into named
shared-memory segments that the sampler pool's worker processes attach
zero-copy (``Graph.from_shared``), as the reference does.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass
from multiprocessing import shared_memory
from typing import Dict, Tuple

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

    def in_degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.num_vertices)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    # -- shared-memory residency (multi-process sampling service) ------------
    def to_shared(self) -> "SharedGraph":
        """Copy the graph's arrays ONCE into named shared-memory segments.

        Returns the owning :class:`SharedGraph` handle; its picklable
        ``spec`` travels to sampler worker processes, which attach the same
        physical pages zero-copy via :meth:`from_shared`. The handle is a
        context manager — exiting (or ``close(unlink=True)``) releases the
        segments even on error paths."""
        return SharedGraph(self)

    @classmethod
    def from_shared(cls, spec: "SharedGraphSpec") -> "Graph":
        """Attach a :class:`Graph` whose arrays are zero-copy views over the
        shared segments described by ``spec`` (created by :meth:`to_shared`).

        The returned graph keeps the attachments alive for its lifetime via
        ``_shm_handles``. Attaching re-registers the segment name with the
        (shared, set-backed) resource tracker — an idempotent no-op — and
        attachers never unlink or unregister: ownership stays with the
        :class:`SharedGraph`, whose ``unlink`` removes the single tracker
        entry, and the tracker still reclaims the segments if the owner
        process dies without cleanup."""
        handles, arrays = attach_arrays(spec.arrays)
        g = cls(arrays["indptr"], arrays["indices"], arrays["features"],
                arrays["labels"], arrays["train_ids"], spec.num_classes,
                spec.name)
        g._shm_handles = handles  # keep the mappings alive with the Graph
        return g


_SHARED_FIELDS = ("indptr", "indices", "features", "labels", "train_ids")


@dataclass(frozen=True)
class SharedArraySpec:
    """One shared segment: its POSIX name plus the numpy view geometry."""

    name: str
    shape: Tuple[int, ...]
    dtype: str


@dataclass(frozen=True)
class SharedGraphSpec:
    """Picklable descriptor of a shared-memory-resident Graph (what the
    parent ships to each sampler worker at spawn)."""

    arrays: Dict[str, SharedArraySpec]
    num_classes: int
    name: str


def share_arrays(arrays: Dict[str, np.ndarray]
                 ) -> Tuple[list, Dict[str, SharedArraySpec]]:
    """Copy named numpy arrays ONCE into fresh shared-memory segments.

    The generic half of the shared stores (graph topology+features,
    feature residency): returns ``(segments, specs)`` where ``segments``
    are the owning ``SharedMemory`` handles (caller closes/unlinks) and
    ``specs`` the picklable attachment descriptors. On any failure the
    already-created segments are released and unlinked before re-raising,
    so a half-built store never leaks."""
    uid = uuid.uuid4().hex[:12]
    segments: list = []
    specs: Dict[str, SharedArraySpec] = {}
    try:
        for fld, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            # field-keyed names, capped so the whole name stays inside the
            # 31-char POSIX floor (macOS); the uid keeps them unique
            shm = shared_memory.SharedMemory(
                create=True, size=max(1, arr.nbytes),
                name=f"hitgnn_{fld[:10]}_{uid}")
            segments.append(shm)
            np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
            specs[fld] = SharedArraySpec(shm.name, tuple(arr.shape),
                                         str(arr.dtype))
    except BaseException:
        for shm in segments:
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        raise
    return segments, specs


def attach_arrays(specs: Dict[str, SharedArraySpec]
                  ) -> Tuple[list, Dict[str, np.ndarray]]:
    """Attach zero-copy numpy views over segments created by
    ``share_arrays``. Returns ``(handles, arrays)``; the handles must stay
    referenced as long as the views are alive (attachers never unlink —
    ownership stays with the creator)."""
    handles: list = []
    arrays: Dict[str, np.ndarray] = {}
    try:
        for fld, aspec in specs.items():
            shm = shared_memory.SharedMemory(name=aspec.name)
            handles.append(shm)
            arrays[fld] = np.ndarray(aspec.shape, np.dtype(aspec.dtype),
                                     buffer=shm.buf)
    except BaseException:
        for shm in handles:
            shm.close()
        raise
    return handles, arrays


class SharedGraph:
    """Owner handle for a graph copied into shared memory.

    Creates one named segment per array in ``_SHARED_FIELDS``; ``spec`` is
    the picklable attachment descriptor. Idempotent ``close``; the context
    manager (and ``__del__`` as a last resort) unlinks on every exit path —
    including KeyboardInterrupt — so no segments outlive the pool."""

    def __init__(self, graph: Graph):
        self._segments, specs = share_arrays(
            {fld: getattr(graph, fld) for fld in _SHARED_FIELDS})
        self.spec = SharedGraphSpec(specs, graph.num_classes, graph.name)
        self._closed = False

    def nbytes(self) -> int:
        return sum(s.size for s in self._segments)

    def close(self, unlink: bool = True) -> None:
        if getattr(self, "_closed", False):
            return
        self._closed = True
        for shm in self._segments:
            try:
                shm.close()
            except Exception:
                pass
            if unlink:
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass

    def __enter__(self) -> "SharedGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close(unlink=True)

    def __del__(self):
        try:
            self.close(unlink=True)
        except Exception:
            pass


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

"""Host-side block-CSR layout builders (copy of ``repro.kernels.layout``;
pure numpy).

The sampled adjacency of one layer is cut into 128x128 tiles, and each
destination block keeps ``max_blk`` tile slots whose source blocks the
``cols`` table names. Two forms feed the kernels:

* the compact triples (``aggregate_backend="pallas"``): per edge its slot
  ``tile_id``, its cell ``tile_off`` (``row*128 + col`` within the tile)
  and its weight ``val`` (1/deg for a mean), for A and A^T; the card
  scatter-adds them into dense tiles (``kernels/aggregate.densify_tiles``)
  for ``aggregate_blockcsr``;
* the edge segments (``"pallas_edges"``, ``"pallas_fused"``): the same
  triples sorted per tile, with CSR-style ``tile_seg`` offsets over the
  slots, for A and, independently sorted, for A^T.

``build_block_csr`` builds the dense tiles on the host. Bitwise copies of
the reference builders.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

BLK = 128

# aggregate_backend values that consume the per-tile SEGMENT layout
EDGE_STREAM_BACKENDS = ("pallas_edges", "pallas_fused")


def build_block_csr(edge_src: np.ndarray, edge_dst: np.ndarray,
                    edge_mask: np.ndarray, n_src: int, n_dst: int,
                    values: np.ndarray | None = None,
                    max_blk: int | None = None):
    """Edge list -> padded block-CSR on the host.

    Returns (blocks (Nd, max_blk, BLK, BLK) f32, cols (Nd, max_blk) i32,
    padded src row count), A[dst, src] = value (default 1). ``max_blk``
    pins the slots per destination block; unused slots keep all-zero
    tiles pointing at source block 0."""
    n_srcb = (n_src + BLK - 1) // BLK
    n_dstb = (n_dst + BLK - 1) // BLK
    src = np.asarray(edge_src)[np.asarray(edge_mask)]
    dst = np.asarray(edge_dst)[np.asarray(edge_mask)]
    val = (np.ones(len(src), np.float32) if values is None
           else np.asarray(values)[np.asarray(edge_mask)].astype(np.float32))
    bs, bd = src // BLK, dst // BLK
    keys = bd.astype(np.int64) * n_srcb + bs
    uniq, inv = np.unique(keys, return_inverse=True)
    blk_dst = (uniq // n_srcb).astype(np.int32)
    blk_src = (uniq % n_srcb).astype(np.int32)
    counts = np.bincount(blk_dst, minlength=n_dstb)
    need = max(1, int(counts.max()) if len(uniq) else 0)
    if max_blk is None:
        max_blk = need
    elif need > max_blk:
        raise ValueError(f"max_blk={max_blk} < required {need}")
    blocks = np.zeros((n_dstb, max_blk, BLK, BLK), np.float32)
    cols = np.zeros((n_dstb, max_blk), np.int32)
    # uniq is sorted, so entries are grouped by dst block: the slot of
    # entry u is its rank within its group
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_of = (np.arange(len(uniq)) - group_start[blk_dst]).astype(np.int32)
    cols[blk_dst, slot_of] = blk_src
    np.add.at(blocks,
              (bd.astype(np.int32), slot_of[inv], dst % BLK, src % BLK), val)
    return blocks, cols, n_srcb * BLK


def build_block_coo_pair(edge_src: np.ndarray, edge_dst: np.ndarray,
                         edge_mask: np.ndarray, n_src: int, n_dst: int,
                         values: np.ndarray | None = None,
                         max_blk: int | None = None,
                         max_blk_t: int | None = None,
                         edge_stream: bool = False) -> dict:
    """Compact layout for A AND A^T from one edge-key sort.

    Per edge: ``tile_id = dst_block * max_blk + slot``, ``tile_off =
    (dst % BLK) * BLK + src % BLK`` and ``val`` (0.0 for masked edges, which
    keep tile_id = tile_off = 0), plus the ``cols`` source-block table; the
    ``*_t`` keys are the same for A^T. ``edge_stream=True`` re-sorts the
    per-edge arrays into per-tile contiguous segments (stable, masked edges
    past the last segment) and adds ``tile_seg`` / ``tile_seg_t``: tile
    ``t``'s edges occupy ``sorted[tile_seg[t]:tile_seg[t + 1]]``.
    """
    n_srcb = (n_src + BLK - 1) // BLK
    n_dstb = (n_dst + BLK - 1) // BLK
    src = np.asarray(edge_src).astype(np.int64)
    dst = np.asarray(edge_dst).astype(np.int64)
    mask = np.asarray(edge_mask).astype(bool)
    E = len(src)
    if values is None:
        val = mask.astype(np.float32)
    else:
        val = np.where(mask, np.asarray(values), 0.0).astype(np.float32)
    src = np.where(mask, src, 0)
    dst = np.where(mask, dst, 0)
    bs, bd = src // BLK, dst // BLK

    # THE single sort: unique (dst_blk, src_blk) keys over the real edges.
    keys = bd * n_srcb + bs
    uniq, inv = np.unique(keys[mask], return_inverse=True)
    U = len(uniq)
    blk_dst = uniq // n_srcb
    blk_src = uniq % n_srcb

    # forward slots: the slot of a block is its rank within its dst group
    counts = np.bincount(blk_dst, minlength=n_dstb)
    need = int(counts.max()) if U else 0
    if max_blk is None:
        max_blk = max(1, need)
    elif need > max_blk:
        raise ValueError(f"max_blk={max_blk} < required {need}")
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_of = np.arange(U) - group_start[blk_dst]
    cols = np.zeros((n_dstb, max_blk), np.int32)
    cols[blk_dst, slot_of] = blk_src.astype(np.int32)
    tile_id = np.zeros(E, np.int32)
    tile_id[mask] = (blk_dst[inv] * max_blk + slot_of[inv]).astype(np.int32)
    tile_off = np.where(mask, (dst % BLK) * BLK + src % BLK,
                        0).astype(np.int32)

    # transpose slots: re-rank the SAME U blocks by (src_blk, dst_blk)
    order_t = np.argsort(blk_src * n_dstb + blk_dst)
    bs_t, bd_t = blk_src[order_t], blk_dst[order_t]
    counts_t = np.bincount(bs_t, minlength=n_srcb)
    need_t = int(counts_t.max()) if U else 0
    if max_blk_t is None:
        max_blk_t = max(1, need_t)
    elif need_t > max_blk_t:
        raise ValueError(f"max_blk_t={max_blk_t} < required {need_t}")
    group_start_t = np.concatenate([[0], np.cumsum(counts_t)[:-1]])
    slot_of_t = np.arange(U) - group_start_t[bs_t]
    cols_t = np.zeros((n_srcb, max_blk_t), np.int32)
    cols_t[bs_t, slot_of_t] = bd_t.astype(np.int32)
    slot_by_uniq = np.empty(U, np.int64)
    slot_by_uniq[order_t] = slot_of_t
    tile_id_t = np.zeros(E, np.int32)
    tile_id_t[mask] = (blk_src[inv] * max_blk_t
                       + slot_by_uniq[inv]).astype(np.int32)
    tile_off_t = np.where(mask, (src % BLK) * BLK + dst % BLK,
                          0).astype(np.int32)

    out = {"tile_id": tile_id, "tile_off": tile_off, "val": val,
           "cols": cols, "tile_id_t": tile_id_t, "tile_off_t": tile_off_t,
           "cols_t": cols_t, "n_src_pad": n_srcb * BLK}
    if edge_stream:
        out.update(_edge_stream_sort(out, mask, n_dstb * max_blk,
                                     n_srcb * max_blk_t))
    return out


def _edge_stream_sort(coo: dict, mask: np.ndarray, n_tiles: int,
                      n_tiles_t: int) -> dict:
    """Re-sort the compact triples into per-tile contiguous segments
    (stable; masked edges sort past every real segment, so ``tile_seg[-1]``
    is the number of real edges)."""
    sorted_fields = {}
    for suffix, n_t in (("", n_tiles), ("_t", n_tiles_t)):
        tid = coo[f"tile_id{suffix}"]
        order = np.argsort(np.where(mask, tid, n_t), kind="stable")
        seg = np.zeros(n_t + 1, np.int32)
        np.cumsum(np.bincount(tid[mask], minlength=n_t), out=seg[1:])
        sorted_fields[f"tile_id{suffix}"] = tid[order]
        sorted_fields[f"tile_off{suffix}"] = coo[f"tile_off{suffix}"][order]
        sorted_fields[f"val{suffix}"] = coo["val"][order]
        sorted_fields[f"tile_seg{suffix}"] = seg
    return sorted_fields


def block_capacities(cfg) -> List[Tuple[int, int, int, int, int]]:
    """Static per-layer capacities ``(n_src, n_dst, max_blk, max_blk_t,
    e_cap)`` for a sampler config: a dst block holds <= BLK * fanout edges,
    so it touches at most that many src blocks; the transpose has no
    fanout bound on its rows."""
    from repro_torch.core.sampler import layer_capacities
    n_caps, e_caps = layer_capacities(cfg)
    fans = cfg.fanouts[::-1]  # layer order matches n_caps
    caps = []
    for l in range(cfg.num_layers):
        n_srcb = (n_caps[l] + BLK - 1) // BLK
        n_dstb = (n_caps[l + 1] + BLK - 1) // BLK
        max_blk = min(n_srcb, BLK * fans[l])
        max_blk_t = n_dstb
        caps.append((n_caps[l], n_caps[l + 1], max_blk, max_blk_t,
                     e_caps[l]))
    return caps


def compact_layout_bytes(n_edges: int, n_dstb: int, max_blk: int,
                         n_srcb: int, max_blk_t: int) -> int:
    """Host->device bytes per batch for one layer's compact layout: three
    4-byte per-edge arrays for A (tile_id, tile_off, val), two more for A^T
    (the values are shared), plus the two cols tables."""
    return 5 * 4 * n_edges + 4 * (n_dstb * max_blk + n_srcb * max_blk_t)


def edge_stream_layout_bytes(n_edges: int, n_dstb: int, max_blk: int,
                             n_srcb: int, max_blk_t: int) -> int:
    """Host->device bytes per batch for one layer's edge-segment layout:
    (tile_off, val) for A and (tile_off_t, val_t) for A^T, the two offsets
    arrays and the two cols tables."""
    return (4 * 4 * n_edges
            + 4 * (n_dstb * max_blk + 1 + n_srcb * max_blk_t + 1)
            + 4 * (n_dstb * max_blk + n_srcb * max_blk_t))


def dense_layout_bytes(n_edges: int, n_dstb: int, max_blk: int,
                       n_srcb: int, max_blk_t: int) -> int:
    """Host->device bytes per batch for one layer's dense layout: full
    64 KB tiles for A and A^T plus the cols tables."""
    return (4 * (n_dstb * max_blk + n_srcb * max_blk_t) * BLK * BLK
            + 4 * (n_dstb * max_blk + n_srcb * max_blk_t))


def densify_tiles_np(tile_id: np.ndarray, tile_off: np.ndarray,
                     val: np.ndarray, n_tile_rows: int, max_blk: int
                     ) -> np.ndarray:
    """Numpy twin of ``aggregate.densify_tiles``. The scatter indexes 2-D
    ``(tile, cell)``, never the flat ``tile_id * BLK*BLK + tile_off``,
    which overflows int32 past 131,072 tile slots."""
    tiles = np.zeros((n_tile_rows * max_blk, BLK * BLK), np.float32)
    np.add.at(tiles, (tile_id, tile_off), val)
    return tiles.reshape(n_tile_rows, max_blk, BLK, BLK)


def densified_tile_bytes(caps: List[Tuple[int, int, int, int, int]]) -> int:
    """Device bytes per batch of the dense (Nd, max_blk, BLK, BLK) tiles
    of A and A^T that the compact triples densify into."""
    total = 0
    for n_src, n_dst, max_blk, max_blk_t, _ in caps:
        n_srcb = (n_src + BLK - 1) // BLK
        n_dstb = (n_dst + BLK - 1) // BLK
        total += (n_dstb * max_blk + n_srcb * max_blk_t) * BLK * BLK * 4
    return total


# what the block-CSR path reads (the compact triples), for A and A^T
LAYOUT_KEYS = ("tile_id", "tile_off", "val", "cols",
               "tile_id_t", "tile_off_t", "cols_t")
# what the edge-streaming kernels read, for A and A^T
EDGE_STREAM_KEYS = ("tile_off", "val", "cols", "tile_off_t", "cols_t",
                    "val_t", "tile_seg", "tile_seg_t")


def build_layer_layouts(edge_src: List[np.ndarray],
                        edge_dst: List[np.ndarray],
                        edge_mask: List[np.ndarray],
                        caps: List[Tuple[int, int, int, int, int]],
                        kind: Optional[str],
                        edge_stream: bool = False) -> dict:
    """Per-layer layout for one mini-batch (A + A^T from one sort).
    ``kind="mean"`` bakes 1/deg into the edge values; "sum" ships raw 1.0
    weights. Shapes are pinned by ``caps``. Returns ``{"agg_<key>":
    [per-layer array]}`` for every key in ``LAYOUT_KEYS`` (the compact
    triples), or in ``EDGE_STREAM_KEYS`` with ``edge_stream`` (the edge
    segments)."""
    keys = EDGE_STREAM_KEYS if edge_stream else LAYOUT_KEYS
    out: dict = {f"agg_{k}": [] for k in keys}
    for l, (n_src, n_dst, max_blk, max_blk_t, _) in enumerate(caps):
        src, dst, mask = edge_src[l], edge_dst[l], edge_mask[l]
        vals = None
        if kind == "mean":
            deg = np.bincount(dst[mask], minlength=n_dst)
            vals = 1.0 / np.maximum(deg[dst], 1.0)
        coo = build_block_coo_pair(src, dst, mask, n_src, n_dst, vals,
                                   max_blk=max_blk, max_blk_t=max_blk_t,
                                   edge_stream=edge_stream)
        for k in keys:
            out[f"agg_{k}"].append(coo[k])
    return out

"""GNN models in the aggregate-update paradigm (paper Alg. 1, §5.3);
counterpart of ``repro.gnn.models`` for GraphSAGE, GCN, GIN and GAT.

Models consume a padded mini-batch as a dict of tensors (see
``core/trainer.batch_to_arrays``):
  feats      (N_0, f0)   input features for the deepest layer's vertices
  edge_src[l](E_l,)      local src index into layer l's vertex set
  edge_dst[l](E_l,)      local dst index into layer l+1's vertex set
  edge_mask[l], node_mask[l], self_idx[l], labels
(under ``data_parallel`` the trainer assembles ``feats`` on the card from
the batch's hit positions and miss rows: ``assemble_device_feats``, or,
under P3, from every device's feature slice: ``assemble_p3_feats`` on one
card, ``p3_all_to_all_feats`` among the ranks of a mesh),
plus, under the kernel backends, each layer's layout (``agg_*``).
``"pallas"`` densifies the compact triples into 128x128 tiles and
aggregates through the CUDA block-CSR kernel
(``kernels/aggregate.AggregateCompact``); ``"pallas_edges"`` routes the
aggregation through the CUDA edge-segment kernel
(``kernels/aggregate.AggregateEdges``); in both the update matmul runs
after it. ``"pallas_fused"`` runs aggregate and update matmul in one CUDA
kernel (``kernels/aggregate.AggregateFused``), so the aggregate never
reaches device memory. ``"reference"`` aggregates with a masked segment sum
in plain PyTorch, whose sums run in one order on every run (no atomics),
forward and backward. GAT computes its attention weights on the device
(``segment_softmax``), so it takes that plain path under every backend,
as in the reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.distributed.sharding import all_gather_flat
from repro_torch.kernels.aggregate import (AggregateCompact, AggregateEdges,
                                           AggregateFused)
from repro_torch.kernels.layout import BLK
from repro_torch.nn.param import PSpec

# the aggregate_backend values the port runs, and those that route through
# a kernel (and so need the layout arrays in the batch)
KERNEL_BACKENDS = ("pallas", "pallas_edges", "pallas_fused")
BACKENDS = ("reference",) + KERNEL_BACKENDS
MODELS = ("graphsage", "gcn", "gin", "gat")

# aggregation semantics per model; "mean" bakes 1/deg into the layout's
# edge values host-side. GAT's weights are computed on the device, so it
# takes no kernel and no layout.
AGG_KIND = {"graphsage": "mean", "gcn": "mean", "gin": "sum", "gat": None}


# rows past n that the card's segment sums spread masked entries over
SPREAD_ROWS = 4096


def _segments(index: torch.Tensor, n: int,
              mask: torch.Tensor | None = None) -> tuple:
    """What a segment sum over ``index`` (int64) into n rows needs: on the
    card the index, with each entry that ``mask`` leaves out sent to one of
    ``SPREAD_ROWS`` rows past n in turn, and n; elsewhere the stable order
    of ``index`` and the length of each of its n segments. The caller
    passes ``mask`` only where every left-out entry is +-0 (a masked
    message, or a padding row whose gradient the model zeroes): padding
    points at row 0, and one run of ~30,000 equal indices at the paper
    batch would be summed by one warp on the card, in order."""
    if index.is_cuda:
        if mask is not None:
            spread = n + torch.arange(len(index), device=index.device
                                      ) % SPREAD_ROWS
            index = torch.where(mask.bool(), index, spread)
        return index, n
    return (torch.argsort(index, stable=True),
            torch.bincount(index, minlength=n))


def _segment_sum(x: torch.Tensor, segs: tuple) -> torch.Tensor:
    """Rows of ``x`` summed per segment in edge order: one summation order
    on every run (``index_add`` uses atomics on CUDA). On the card,
    ``index_put_`` with ``accumulate``: a stable sort of the index, then
    each run of equal indices summed by one warp, in order, without
    atomics; the spread rows are dropped. Elsewhere
    ``torch.segment_reduce`` over the sorted rows (whose CUDA kernels run
    a thread per segment and column, ~100x slower at the paper batch)."""
    if x.is_cuda:
        index, n = segs
        return x.new_zeros((n + SPREAD_ROWS, *x.shape[1:])).index_put_(
            (index,), x, accumulate=True)[:n]
    order, lengths = segs
    return torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


class _SegmentSum(torch.autograd.Function):
    """out[d] = sum of x[e] over the e with index[e] == d, in edge order
    (``segs``: ``_segments(index, n)``); the backward gathers,
    ``dx = g[index]``."""

    @staticmethod
    def forward(ctx, x, index, segs):
        ctx.save_for_backward(index)
        return _segment_sum(x, segs)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return g[index], None, None


class _GatherRows(torch.autograd.Function):
    """h[index], whose backward adds the rows of g that gather from one row
    of h by a segment sum in edge order (``segs``: ``_segments(index,
    h.shape[0])``), not by an atomic scatter-add."""

    @staticmethod
    def forward(ctx, h, index, segs):
        ctx.segs = segs
        return h[index]

    @staticmethod
    def backward(ctx, g):
        return _segment_sum(g, ctx.segs), None, None


def gather_rows(h: torch.Tensor, index: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """``h[index]`` with a backward that gives the same bits on every
    run; ``mask``: the rows whose gradient the caller makes +-0
    (``_segments``)."""
    index = index.long()
    return _GatherRows.apply(h, index, _segments(index, h.shape[0], mask))


def aggregate(h_src: torch.Tensor, edge_src: torch.Tensor,
              edge_dst: torch.Tensor, edge_mask: torch.Tensor, n_dst: int,
              kind: str = "mean") -> torch.Tensor:
    """Masked segment aggregation of messages h_src[edge_src] into dst
    rows. Every sum, forward and backward, is a sorted segment sum in edge
    order, so a run repeats its bits on the card."""
    mask = edge_mask.to(h_src.dtype)
    msg = gather_rows(h_src, edge_src, edge_mask) * mask[:, None]
    dst = edge_dst.long()
    segs = _segments(dst, n_dst, edge_mask)
    agg = _SegmentSum.apply(msg, dst, segs)
    if kind == "sum":
        return agg
    if kind == "mean":
        deg = _segment_sum(mask[:, None], segs)
        return agg / deg.clamp_min(1.0)
    raise ValueError(kind)


def segment_softmax(scores: torch.Tensor, seg: torch.Tensor,
                    mask: torch.Tensor, n_seg: int,
                    segs=None) -> torch.Tensor:
    """Numerically stable per-segment softmax over edges (GAT): masked
    scores are -1e30, each segment's max comes off before ``exp``, and the
    sum is clamped at 1e-9. Both sums are segment sums in edge order
    (``segs``: ``_segments(seg, n_seg)``, or computed here) and the max is
    exact in any order (``scatter_reduce``, -inf in an empty segment, its
    gradient split evenly among ties, as ``jax.ops.segment_max``'s), so a
    run repeats its bits on the card. The fill is a scalar, not a tensor
    made from one: that would be a copy from the host, which waits for the
    card and so cannot be captured in a CUDA graph (the serving path)."""
    seg = seg.long()
    segs = segs if segs is not None else _segments(seg, n_seg, mask)
    maskf = mask.to(scores.dtype)
    neg = scores.masked_fill(~mask.bool(), -1e30)
    smax = scores.new_full((n_seg,), float("-inf")).scatter_reduce(
        0, seg, neg, "amax", include_self=False)
    ex = torch.exp(neg - _GatherRows.apply(smax, seg, segs)) * maskf
    den = _SegmentSum.apply(ex, seg, segs)
    return ex / _GatherRows.apply(den, seg, segs).clamp_min(1e-9)


def _leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """The reference's leaky relu: x where x >= 0 (gradient 1 at 0)."""
    return torch.where(x >= 0, x, slope * x)


def _gat_layer(p, h, batch, l: int, n_dst: int) -> torch.Tensor:
    """One GAT layer: ``hw = h @ w``, a leaky-relu(0.2) score per edge from
    its source and destination rows, the per-destination softmax, and the
    attention-weighted sum of the source rows plus ``b``. Every gather's
    backward and every sum is a sorted segment reduction in edge order."""
    hw = h @ p["w"]
    src = batch["edge_src"][l].long()
    dst = batch["edge_dst"][l].long()
    emask = batch["edge_mask"][l]
    segs = _segments(dst, n_dst, emask)
    hw_src = gather_rows(hw, src, emask)
    # a padding row of hw_dst is named by no edge: its gradient is +0
    hw_dst = _GatherRows.apply(gather_rows(hw, batch["self_idx"][l],
                                           batch["node_mask"][l + 1]),
                               dst, segs)
    e = _leaky_relu((hw_src * p["a_src"]).sum(-1)
                    + (hw_dst * p["a_dst"]).sum(-1), 0.2)
    alpha = segment_softmax(e, dst, emask, n_dst, segs)
    return _SegmentSum.apply(hw_src * alpha[:, None], dst, segs) + p["b"]


def _dims(cfg: GNNModelConfig, f_in: int, n_classes: int) -> list:
    return [f_in] + [cfg.hidden] * (cfg.num_layers - 1) + [n_classes]


def param_spec(cfg: GNNModelConfig, f_in: int, n_classes: int):
    dims = _dims(cfg, f_in, n_classes)
    layers = []
    for l in range(cfg.num_layers):
        fi, fo = dims[l], dims[l + 1]
        if cfg.name == "graphsage":
            layers.append({"w_self": PSpec((fi, fo)),
                           "w_neigh": PSpec((fi, fo)),
                           "b": PSpec((fo,), init="zeros")})
        elif cfg.name == "gcn":
            layers.append({"w": PSpec((fi, fo)),
                           "b": PSpec((fo,), init="zeros")})
        elif cfg.name == "gat":
            layers.append({"w": PSpec((fi, fo)),
                           "a_src": PSpec((fo,)),
                           "a_dst": PSpec((fo,)),
                           "b": PSpec((fo,), init="zeros")})
        elif cfg.name == "gin":
            layers.append({"eps": PSpec((), init="zeros"),
                           "w1": PSpec((fi, fo)),
                           "b1": PSpec((fo,), init="zeros"),
                           "w2": PSpec((fo, fo)),
                           "b2": PSpec((fo,), init="zeros")})
        else:
            raise ValueError(cfg.name)
    return {"layers": layers}


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, rows - x.shape[0])) if rows != x.shape[0] else x


def _kernel_aggregate(batch, l: int, h: torch.Tensor,
                      n_dst: int) -> torch.Tensor:
    """Layer-l aggregation through the edge-segment kernel. ``h`` is
    zero-padded to the layout's source blocks here, not in the kernel, and
    the output is cut back to the layer's ``n_dst`` rows."""
    cols_t = batch["agg_cols_t"][l]
    h32 = _pad_rows(h.float(), cols_t.shape[0] * BLK)
    out = AggregateEdges.apply(
        batch["agg_tile_off"][l], batch["agg_val"][l],
        batch["agg_tile_seg"][l], batch["agg_cols"][l],
        batch["agg_tile_off_t"][l], batch["agg_val_t"][l],
        batch["agg_tile_seg_t"][l], cols_t, h32.contiguous())
    return out[:n_dst].to(h.dtype)


def _blockcsr_aggregate(batch, l: int, h: torch.Tensor,
                        n_dst: int) -> torch.Tensor:
    """Layer-l aggregation through the block-CSR kernel: the compact
    triples are densified into 128x128 tiles on the card, A's in the
    forward and, only when ``h`` needs a gradient, A^T's in the backward.
    ``h`` is zero-padded to the layout's source blocks and the output cut
    back to ``n_dst`` rows."""
    cols_t = batch["agg_cols_t"][l]
    h32 = _pad_rows(h.float(), cols_t.shape[0] * BLK)
    out = AggregateCompact.apply(
        batch["agg_tile_id"][l], batch["agg_tile_off"][l],
        batch["agg_val"][l], batch["agg_cols"][l],
        batch["agg_tile_id_t"][l], batch["agg_tile_off_t"][l], cols_t,
        h32.contiguous())
    return out[:n_dst].to(h.dtype)


def _fused_aggregate_update(batch, l: int, h: torch.Tensor, n_dst: int,
                            w: torch.Tensor,
                            s: torch.Tensor | None = None) -> torch.Tensor:
    """Layer-l ``(A @ h [+ s]) @ w`` through the fused kernel, which keeps
    the (n_dstb*128, F) aggregate out of device memory, forward and
    backward. ``h`` is padded to the layout's source blocks and ``s`` to
    its destination blocks (after any scaling, so its gradient covers
    exactly the unfused rows); bias and activation stay outside the kernel,
    as in the reference."""
    cols_t = batch["agg_cols_t"][l]
    h32 = _pad_rows(h.float(), cols_t.shape[0] * BLK).contiguous()
    if s is not None:
        s = _pad_rows(s.float(),
                      batch["agg_cols"][l].shape[0] * BLK).contiguous()
    out = AggregateFused.apply(
        batch["agg_tile_off"][l], batch["agg_val"][l],
        batch["agg_tile_seg"][l], batch["agg_cols"][l],
        batch["agg_tile_off_t"][l], batch["agg_val_t"][l],
        batch["agg_tile_seg_t"][l], cols_t, h32, w.float().contiguous(),
        None, s, "none")
    return out[:n_dst].to(h.dtype)


def _layer(cfg: GNNModelConfig, p, h, batch, l: int, n_dst: int):
    if cfg.name == "gat":
        return _gat_layer(p, h, batch, l, n_dst)
    # forward() zeroes a padding node's output row, so its gradient is +-0
    h_self = gather_rows(h, batch["self_idx"][l], batch["node_mask"][l + 1])
    use_kernel = (cfg.aggregate_backend in KERNEL_BACKENDS
                  and AGG_KIND.get(cfg.name) is not None
                  and "agg_tile_off" in batch)
    fused = use_kernel and cfg.aggregate_backend == "pallas_fused"

    def _agg() -> torch.Tensor:
        if use_kernel and cfg.aggregate_backend == "pallas":
            return _blockcsr_aggregate(batch, l, h, n_dst)
        if use_kernel:
            return _kernel_aggregate(batch, l, h, n_dst)
        return aggregate(h, batch["edge_src"][l], batch["edge_dst"][l],
                         batch["edge_mask"][l], n_dst, AGG_KIND[cfg.name])

    def _fused(w, s=None):
        return _fused_aggregate_update(batch, l, h, n_dst, w, s)

    if cfg.name == "graphsage":
        neigh = _fused(p["w_neigh"]) if fused else _agg() @ p["w_neigh"]
        return h_self @ p["w_self"] + neigh + p["b"]
    if cfg.name == "gcn":
        y = _fused(p["w"], h_self) if fused else (_agg() + h_self) @ p["w"]
        return y * 0.5 + p["b"]
    if cfg.name == "gin":
        hs = (1.0 + p["eps"]) * h_self
        y = _fused(p["w1"], hs) if fused else (hs + _agg()) @ p["w1"]
        return torch.relu(y + p["b1"]) @ p["w2"] + p["b2"]
    raise ValueError(cfg.name)


def forward(cfg: GNNModelConfig, params, batch) -> torch.Tensor:
    """Returns logits (T, n_classes) for the target vertices."""
    h = batch["feats"]
    n_layers = cfg.num_layers
    for l in range(n_layers):
        n_dst = batch["self_idx"][l].shape[0]
        h = _layer(cfg, params["layers"][l], h, batch, l, n_dst)
        if l != n_layers - 1:
            h = torch.relu(h)
            h = h * batch["node_mask"][l + 1][:, None].to(h.dtype)
    return h


def assemble_device_feats(shard: torch.Tensor, batch) -> torch.Tensor:
    """The layer-0 block of a batch, assembled where ``shard`` lives (the
    ``data_parallel`` path; counterpart of the reference's
    ``assemble_device_feats``). ``shard`` is the device's (rows, f)
    resident block; the batch carries its hit rows, ``hit_idx`` (H,) rows
    of the block and ``hit_pos`` (H,) their rows in the shard, and exactly
    its miss rows, ``miss_pos`` (M,) and ``miss_rows`` (M, f). The block
    has ``node_mask[0]``'s N_0 rows: hit rows read the shard, miss rows are
    copied in, every other row is +0.0 — the values of
    ``FeatureStore.gather``. Each row is written once, by unique
    positions, so no sum and no atomic reaches the result, and the block
    is written in one pass over the zeros."""
    out = shard.new_zeros((batch["node_mask"][0].shape[0], shard.shape[1]))
    out.index_copy_(0, batch["hit_idx"],
                    shard.index_select(0, batch["hit_pos"]))
    return out.index_copy_(0, batch["miss_pos"], batch["miss_rows"])


def assemble_p3_feats(shards: torch.Tensor, batch,
                      feat_dim: int) -> torch.Tensor:
    """P3's layer-0 block assembled on the card from every device's
    feature-dimension slice: the one-card counterpart of the reference's
    ``p3_all_to_all_feats``, whose exchange among the p simulated devices
    is an index here. ``shards`` is the (p, V, chunk) slice matrix
    (``FeatureStore.build_shard_matrix``); the batch carries its valid rows
    ``hit_idx`` (H,) and their vertex ids ``hit_pos`` (H,). Each valid row
    is the concatenation of its p slices, cut to ``feat_dim``, written once
    at its unique position over ``node_mask[0]``'s N_0 zero rows: the
    values of ``FeatureStore.gather_p3_full``, +0.0 rows included (no mask
    multiply, which would keep a negative row's signed zeros)."""
    p, _, chunk = shards.shape
    rows = shards.index_select(1, batch["hit_pos"])       # (p, H, chunk)
    rows = rows.transpose(0, 1).reshape(-1, p * chunk)[:, :feat_dim]
    out = shards.new_zeros((batch["node_mask"][0].shape[0], feat_dim))
    return out.index_copy_(0, batch["hit_idx"], rows)


def p3_all_to_all_feats(shard: torch.Tensor, batch, feat_dim: int,
                        group=None) -> torch.Tensor:
    """P3's layer-1 exchange (paper Listing 3) among the ranks of a mesh,
    the counterpart of the reference's ``p3_all_to_all_feats``. ``shard``
    is this rank's (V, chunk) feature-dimension slice of every vertex; the
    batch carries its valid rows ``hit_idx`` (H,) and their vertex ids
    ``hit_pos`` (H,). One ``all_gather`` brings every rank's padded
    layer-0 ids (p x N_0 x 8 bytes, invalid rows id 0), this rank gathers
    its slice of every batch's rows, (p, N_0, chunk), and one
    ``all_to_all_single`` (p x N_0 x chunk x 4 bytes each way) hands rank
    d the p slices of its own batch. Its valid rows are laid side by side,
    cut to ``feat_dim`` and written once into a zero block, so the block
    equals ``assemble_p3_feats``' (and ``FeatureStore.gather_p3_full``'s)
    bit for bit; no row another rank gathered for an invalid position is
    kept, so no mask is exchanged."""
    n0 = batch["node_mask"][0].shape[0]
    p = dist.get_world_size(group)
    ids = torch.zeros(n0, dtype=torch.int64, device=shard.device)
    ids.index_copy_(0, batch["hit_idx"], batch["hit_pos"])
    ids_all = ids.new_empty(p * n0)
    all_gather_flat(ids_all, ids, group=group)
    mine = shard.index_select(0, ids_all)     # my slice of every batch
    got = torch.empty_like(mine)
    dist.all_to_all_single(got, mine, group=group)  # got[e]: slice e of mine
    rows = got.view(p, n0, -1).index_select(1, batch["hit_idx"])
    rows = rows.transpose(0, 1).reshape(-1, p * shard.shape[1])[:, :feat_dim]
    out = shard.new_zeros((n0, feat_dim))
    return out.index_copy_(0, batch["hit_idx"], rows)


def loss_fn(cfg: GNNModelConfig, params, batch):
    """Mean cross-entropy over the targets, and the metrics dict."""
    logits = forward(cfg, params, batch).float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(1, labels[:, None])[:, 0]
    loss = (lse - ll).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}

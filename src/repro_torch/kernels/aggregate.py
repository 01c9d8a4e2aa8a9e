"""Block-CSR and edge-streaming aggregation and the fused aggregate->update
datapath (counterparts of ``repro.kernels.aggregate``'s
``aggregate_blockcsr`` / ``aggregate_blockcsr_vjp`` /
``aggregate_compact_vjp``, ``aggregate_edges`` / ``aggregate_edges_vjp``
and ``aggregate_fused`` / ``aggregate_fused_vjp``).

A arrives as compact per-edge triples or as per-tile edge segments
(``kernels/layout.py``). Each wrapper below takes a CUDA tensor to its
hand-written kernel in ``csrc/`` — or raises — and a CPU tensor to its
``*_plain`` twin, the same function in plain PyTorch, which the tests hold
against the JAX reference:

* ``aggregate_blockcsr`` (``csrc/aggregate_blockcsr.cu``): ``out = A @ h``
  over dense 128x128 tiles, walking only each destination block's real
  slots when given their counts (``real_slot_counts``). ``densify_tiles``
  scatter-adds the compact triples into those tiles (plain PyTorch, as
  the reference's is an XLA scatter). ``AggregateCompact`` is the
  training path's autograd function (tiles densified in the forward and,
  only when ``h`` needs a gradient, from A^T in the backward);
  ``AggregateBlockCSR`` takes dense tiles.
* ``aggregate_edges`` (``csrc/aggregate_edges.cu``): ``out = A @ h``;
  ``aggregate_edges_shape`` sizes its grid (row groups of each
  destination block) from the shapes. ``AggregateEdges`` is its autograd
  function; the backward is the same kernel over the transposed
  segments, ``dh = A^T @ g``.
* ``aggregate_fused`` (``csrc/aggregate_fused.cu``): ``act((A @ h [+ s]) @
  w [+ b])`` with the aggregate kept on chip, never written to device
  memory; ``aggregate_fused_shape`` sizes its grid (slabs of z columns
  split over a thread block cluster) from the shapes.
* ``fused_bwd`` and ``fused_bwd_merged`` (``csrc/aggregate_fused_bwd.cu``):
  its backward, which recomputes the aggregate per destination block;
  ``fused_bwd_merged_shape`` sizes the merged kernel's grid from the
  shapes. ``AggregateFused`` is the autograd function and picks between
  them as the reference's ``_fused_bwd`` does.

``launch_counts`` (``kernels/build.py``) counts wrapper calls that launched
their kernel (incremented where a launch is made, nowhere else), so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import (  # noqa: F401  (re-exported)
    check_tensor, launch_counts, on_card, raise_on, reset_launch_counts,
    sm_count, stream)
from repro_torch.kernels.layout import BLK
from repro_torch.kernels.update_mlp import ACTS, update_epilogue

launch_counts.update(aggregate_blockcsr=0, aggregate_edges=0,
                     aggregate_fused=0, fused_bwd=0, fused_bwd_merged=0)

# dynamic shared memory a thread block may use on Hopper
_MAX_SMEM = 232_448
# aggregate_edges (csrc/aggregate_edges.cu): the most row-columns a thread
# block walks, and the fewest rows of a group (one a warp)
_EDGES_GROUP_WORK = 32768
_EDGES_MIN_ROWS = 8


def aggregate_edges_plain(tile_off: torch.Tensor, val: torch.Tensor,
                          seg: torch.Tensor, cols: torch.Tensor,
                          h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every valid edge ``e <
    seg[-1]`` finds its tile slot ``t`` (``seg[t] <= e < seg[t+1]``), then
    adds ``val[e] * h[src]`` into ``out[dst]``. Returns (n_dstb*128, F).
    The sums run in one order on every run: ``index_add_`` on the CPU, and
    on the card ``index_put_`` with ``accumulate`` (a stable sort of the
    rows, each row's messages summed in edge order), where ``index_add_``
    sums with atomics, so a row of many edges changed its last bits from
    run to run (ROADMAP.md C.9)."""
    n_dstb, max_blk = cols.shape
    out = torch.zeros((n_dstb * BLK, h.shape[1]), dtype=h.dtype,
                      device=h.device)
    n_valid = int(seg[-1]) if seg.numel() else 0
    if n_valid == 0:
        return out
    e = torch.arange(n_valid, dtype=seg.dtype, device=seg.device)
    t = (torch.searchsorted(seg, e, right=True) - 1).long()
    i, k = t // max_blk, t % max_blk
    off = tile_off[:n_valid].long()
    dst = i * BLK + off // BLK
    src = cols[i, k].long() * BLK + off % BLK
    msg = val[:n_valid, None].to(h.dtype) * h[src]
    if h.is_cuda:
        return out.index_put_((dst,), msg, accumulate=True)
    return out.index_add_(0, dst, msg)


def _check(tile_off, val, seg, cols, h) -> None:
    for name, t, dtype in (("tile_off", tile_off, torch.int32),
                           ("val", val, torch.float32),
                           ("seg", seg, torch.int32),
                           ("cols", cols, torch.int32),
                           ("h", h, torch.float32)):
        check_tensor(name, t, h.device, dtype)
    if tile_off.dim() != 1 or val.shape != tile_off.shape:
        raise ValueError(f"tile_off {tuple(tile_off.shape)} and val "
                         f"{tuple(val.shape)} must be equal 1-D shapes")
    if cols.dim() != 2 or h.dim() != 2:
        raise ValueError("cols and h must be 2-D")
    n_dstb, max_blk = cols.shape
    if seg.shape != (n_dstb * max_blk + 1,):
        raise ValueError(f"seg has shape {tuple(seg.shape)}, expected "
                         f"({n_dstb * max_blk + 1},) for cols "
                         f"{tuple(cols.shape)}")
    if h.shape[0] % BLK:
        raise ValueError(f"h has {h.shape[0]} rows; pad it to a multiple of "
                         f"{BLK} (the source blocks)")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each library in csrc/: {C function: (argument types, result type)}
_SIGNATURES = {
    "aggregate_blockcsr": {
        "aggregate_blockcsr_smem_bytes": ([], _I),
        "aggregate_blockcsr_launch": ([_P] * 6 + [_I, _I, _L, _I, _P], _I)},
    "aggregate_edges": {
        "aggregate_edges_launch": ([_P] * 6 + [_I, _I, _L, _I, _I, _I, _P],
                                   _I)},
    "aggregate_fused": {
        "aggregate_fused_smem_bytes": ([_I], _L),
        "aggregate_fused_max_clusters": ([_I, _I], _I),
        "aggregate_fused_launch": ([_P] * 9 + [_I, _I, _L, _I, _I, _I, _I,
                                               _I, _P], _I)},
    "aggregate_fused_bwd": {
        "fused_bwd_smem_bytes": ([_I, _I], _L),
        "fused_bwd_launch": ([_P] * 15 + [_I, _I, _L, _I, _I, _I, _I, _I,
                                          _P], _I),
        "fused_bwd_merged_launch": ([_P] * 17 + [_I, _I, _L] + [_I] * 5
                                    + [_P], _I)},
}


def _lib(name: str) -> ctypes.CDLL:
    return build.bind(name, _SIGNATURES[name])


def _check_smem(what: str, smem: int) -> None:
    if smem > _MAX_SMEM:
        raise ValueError(f"{what} needs {smem} B of shared memory for this "
                         f"layout; a block has {_MAX_SMEM}")


# --- block-CSR aggregation over dense tiles ---------------------------------

def densify_tiles(tile_id: torch.Tensor, tile_off: torch.Tensor,
                  val: torch.Tensor, n_tile_rows: int,
                  max_blk: int) -> torch.Tensor:
    """Scatter-add the compact per-edge triples into dense (n_tile_rows,
    max_blk, BLK, BLK) f32 tiles on ``val``'s device (the reference's
    ``densify_tiles``, an XLA scatter there, so plain PyTorch here). The
    index is 2-D ``(tile_id, tile_off)``: the flat ``tile_id * BLK*BLK +
    tile_off`` would pass 2**31 at 131,072 tile slots, and layer 0 of the
    paper's batch has 266,240. Masked edges add 0.0 at cell (0, 0)."""
    tiles = torch.zeros((n_tile_rows * max_blk, BLK * BLK),
                        dtype=torch.float32, device=val.device)
    tiles.index_put_((tile_id.long(), tile_off.long()), val.float(),
                     accumulate=True)
    return tiles.view(n_tile_rows, max_blk, BLK, BLK)


def real_slot_counts(tile_id: torch.Tensor, n_tile_rows: int,
                     max_blk: int) -> torch.Tensor:
    """Real tile slots of each destination block, (n_tile_rows,) int32 on
    ``tile_id``'s device: 1 + the largest slot that an edge's ``tile_id``
    names in that row, by an amax scatter (order-free, so the same on
    every run). The layouts pack a block's real slots first
    (``kernels/layout.py``), so every slot at or past the count holds a
    zero tile. A masked edge keeps tile_id 0, which can only raise row 0's
    count to 1: slot 0 is then a zero tile, an exact zero term."""
    counts = torch.zeros(n_tile_rows, dtype=torch.int64,
                         device=tile_id.device)
    if tile_id.numel():
        t = tile_id.long()
        counts.scatter_reduce_(0, t // max_blk, t % max_blk + 1, "amax")
    return counts.int()


def aggregate_blockcsr_plain(blocks: torch.Tensor, cols: torch.Tensor,
                             h: torch.Tensor,
                             nblk: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain version of ``aggregate_blockcsr``: for each slot k in order,
    one batched ``(Nd, 128, 128) @ (Nd, 128, F)`` product of the slot's
    tiles and the source blocks ``cols[:, k]`` names, added into the fp32
    result. Given the real-slot counts ``nblk`` it stops after the largest:
    every slot past it holds zero tiles, so the result is bitwise the same.
    Returns (Nd*128, F)."""
    n_dstb, max_blk = cols.shape
    F = h.shape[1]
    hb = h.view(-1, BLK, F)
    out = torch.zeros((n_dstb, BLK, F), dtype=torch.float32,
                      device=h.device)
    if nblk is not None:
        max_blk = min(max_blk, int(nblk.max())) if nblk.numel() else 0
    for k in range(max_blk):
        out += torch.bmm(blocks[:, k], hb[cols[:, k].long()])
    return out.view(n_dstb * BLK, F)


def _check_blockcsr(blocks, cols, h, nblk) -> None:
    for name, t, dtype in (("blocks", blocks, torch.float32),
                           ("cols", cols, torch.int32),
                           ("h", h, torch.float32)):
        check_tensor(name, t, h.device, dtype)
    if nblk is not None:
        check_tensor("nblk", nblk, h.device, torch.int32)
        if tuple(nblk.shape) != (cols.shape[0],):
            raise ValueError(f"nblk has shape {tuple(nblk.shape)}, expected "
                             f"({cols.shape[0]},) for cols "
                             f"{tuple(cols.shape)}")
    if cols.dim() != 2 or tuple(blocks.shape) != (*cols.shape, BLK, BLK):
        raise ValueError(f"blocks {tuple(blocks.shape)} and cols "
                         f"{tuple(cols.shape)} must be (Nd, max_blk, {BLK}, "
                         f"{BLK}) and (Nd, max_blk)")
    if h.dim() != 2 or h.shape[0] % BLK:
        raise ValueError(f"h has shape {tuple(h.shape)}; pad its rows to a "
                         f"multiple of {BLK} (the source blocks)")


def aggregate_blockcsr(blocks: torch.Tensor, cols: torch.Tensor,
                       h: torch.Tensor,
                       nblk: torch.Tensor | None = None) -> torch.Tensor:
    """out = A @ h with A in padded block-CSR form: blocks (Nd, max_blk,
    128, 128) f32 dense tiles, cols (Nd, max_blk) i32 their source blocks,
    h (n_srcb*128, F) f32; ``nblk`` (Nd,) i32, the real slots of each
    destination block (``real_slot_counts``), or None to walk every slot.
    The slots past ``nblk[i]`` must hold zero tiles (the layouts pack the
    real ones first). Returns (Nd*128, F) f32. Any F is taken (the kernel
    masks the ragged columns; the reference pads F to its ``feat_block``).
    A CUDA tensor goes through ``csrc/aggregate_blockcsr.cu``, which walks
    only the counted slots, heaviest destination blocks first; a CPU tensor
    through ``aggregate_blockcsr_plain``."""
    _check_blockcsr(blocks, cols, h, nblk)
    if not on_card("aggregate_blockcsr", h):
        return aggregate_blockcsr_plain(blocks, cols, h, nblk)
    n_dstb, max_blk = cols.shape
    F = h.shape[1]
    out = torch.empty((n_dstb * BLK, F), dtype=torch.float32,
                      device=h.device)
    if out.numel() == 0:
        return out
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must start on a 16-byte boundary (the "
                         "kernel copies its tiles 16 bytes at a time)")
    order = None
    if nblk is not None:  # heaviest destination blocks first
        order = torch.argsort(nblk, descending=True, stable=True).int()
    with torch.cuda.device(h.device):
        status = _lib("aggregate_blockcsr").aggregate_blockcsr_launch(
            blocks.data_ptr(), cols.data_ptr(),
            None if nblk is None else nblk.data_ptr(),
            None if order is None else order.data_ptr(), h.data_ptr(),
            out.data_ptr(), n_dstb, max_blk, h.shape[0], F, stream(h))
    raise_on(status, "aggregate_blockcsr", "aggregate_blockcsr")
    launch_counts["aggregate_blockcsr"] += 1
    return out


def aggregate_blockcsr_smem_bytes() -> int:
    """Dynamic shared memory of one ``aggregate_blockcsr`` thread block,
    its three-stage copy ring (builds the kernel)."""
    return _lib("aggregate_blockcsr").aggregate_blockcsr_smem_bytes()


class AggregateBlockCSR(torch.autograd.Function):
    """Differentiable ``A @ h`` over dense tiles (the reference's
    ``aggregate_blockcsr_vjp``): the backward is the same kernel over the
    tiles of A^T, ``dh = A^T @ g``, run only when ``h`` needs a gradient;
    the tiles are sampled data and get none."""

    @staticmethod
    def forward(ctx, blocks, cols, blocks_t, cols_t, h):
        ctx.save_for_backward(blocks_t, cols_t)
        return aggregate_blockcsr(blocks, cols, h)

    @staticmethod
    def backward(ctx, g):
        dh = None
        if ctx.needs_input_grad[4]:
            blocks_t, cols_t = ctx.saved_tensors
            dh = aggregate_blockcsr(blocks_t, cols_t,
                                    g.float().contiguous()).to(g.dtype)
        return None, None, None, None, dh


class AggregateCompact(torch.autograd.Function):
    """Differentiable ``A @ h`` fed by the compact triples (the reference's
    ``aggregate_compact_vjp``, the ``"pallas"`` training path). The forward
    densifies A's tiles, launches the kernel over A's real slots
    (``real_slot_counts``) and lets the tiles go; only the triples are
    saved. The backward densifies A^T's tiles (the values are shared with
    A) and runs the same kernel over A^T's real slots on ``g``, but only
    when ``h`` needs a gradient: layer 0's ``h`` is the input features,
    and its A^T would take 2,288 x 208 slots x 64 KB = 31.2 GB at the
    paper's batch for nothing."""

    @staticmethod
    def forward(ctx, tile_id, tile_off, val, cols, tile_id_t, tile_off_t,
                cols_t, h):
        ctx.save_for_backward(tile_id_t, tile_off_t, val, cols_t)
        blocks = densify_tiles(tile_id, tile_off, val, *cols.shape)
        return aggregate_blockcsr(blocks, cols, h,
                                  real_slot_counts(tile_id, *cols.shape))

    @staticmethod
    def backward(ctx, g):
        dh = None
        if ctx.needs_input_grad[7]:
            tile_id_t, tile_off_t, val, cols_t = ctx.saved_tensors
            blocks_t = densify_tiles(tile_id_t, tile_off_t, val,
                                     *cols_t.shape)
            dh = aggregate_blockcsr(
                blocks_t, cols_t, g.float().contiguous(),
                real_slot_counts(tile_id_t, *cols_t.shape)).to(g.dtype)
        return (None,) * 7 + (dh,)


# --- edge-streaming aggregation ---------------------------------------------

def aggregate_edges_shape(n_dstb: int, F: int, sms: int) -> int:
    """The row groups a destination block of ``aggregate_edges`` is cut
    into on a card of ``sms`` SMs, from the shapes alone (no host sync).
    The grid is (groups, n_dstb) thread blocks of 256 threads, two an SM,
    each owning 128 / groups rows and every column of them. Groups double
    while a thread block would walk more than ``_EDGES_GROUP_WORK``
    row-columns (F = 602: 32 rows, so the paper batch's 52 busy layer-0
    blocks become 208 thread blocks that the card holds at once) or the
    grid would hold fewer than four thread blocks an SM (layer 1's 8
    destination blocks, and the 208 of its backward), down to
    ``_EDGES_MIN_ROWS`` rows, one a warp."""
    groups = 1
    while BLK // groups > _EDGES_MIN_ROWS and (
            BLK // groups * F > _EDGES_GROUP_WORK
            or n_dstb * groups < 4 * sms):
        groups *= 2
    return groups


def aggregate_edges_vec(h: torch.Tensor) -> int:
    """The floats an ``aggregate_edges`` lane loads at once from ``h``: the
    widest of 4, 2 and 1 that the row length and the base allow (float2 at
    F = 602, whose rows are 8-byte aligned; float4 at F = 128)."""
    F, ptr = h.shape[1], h.data_ptr()
    return next(v for v in (4, 2, 1) if F % v == 0 and ptr % (4 * v) == 0)


def aggregate_edges(tile_off: torch.Tensor, val: torch.Tensor,
                    seg: torch.Tensor, cols: torch.Tensor,
                    h: torch.Tensor) -> torch.Tensor:
    """out = A @ h with A streamed from per-tile edge segments.

    tile_off (E,) i32 and val (E,) f32 sorted into per-tile segments; seg
    (n_dstb*max_blk + 1,) i32 segment offsets (masked edges lie past
    seg[-1]); cols (n_dstb, max_blk) i32 source-block table; h (n_srcb*128,
    F) f32. Returns (n_dstb*128, F) f32. A CUDA tensor goes through the
    kernel in the grid ``aggregate_edges_shape`` picks, a CPU tensor
    through ``aggregate_edges_plain``."""
    _check(tile_off, val, seg, cols, h)
    if not on_card("aggregate_edges", h):
        return aggregate_edges_plain(tile_off, val, seg, cols, h)
    n_dstb, max_blk = cols.shape
    F = h.shape[1]
    out = torch.empty((n_dstb * BLK, F), dtype=torch.float32, device=h.device)
    if tile_off.numel() == 0 or out.numel() == 0:  # A or out is empty
        return out.zero_()
    groups = aggregate_edges_shape(n_dstb, F, sm_count(h))
    with torch.cuda.device(h.device):
        status = _lib("aggregate_edges").aggregate_edges_launch(
            tile_off.data_ptr(), val.data_ptr(), seg.data_ptr(),
            cols.data_ptr(), h.data_ptr(), out.data_ptr(), n_dstb, max_blk,
            h.shape[0], F, groups, aggregate_edges_vec(h), stream(h))
    raise_on(status, "aggregate_edges", "aggregate_edges")
    launch_counts["aggregate_edges"] += 1
    return out


class AggregateEdges(torch.autograd.Function):
    """Differentiable ``A @ h``. The backward is the same kernel over the
    transposed segments (``dh = A^T @ g``), run only when ``h`` needs a
    gradient; the layout is sampled data and gets none."""

    @staticmethod
    def forward(ctx, tile_off, val, seg, cols, tile_off_t, val_t, seg_t,
                cols_t, h):
        ctx.save_for_backward(tile_off_t, val_t, seg_t, cols_t)
        return aggregate_edges(tile_off, val, seg, cols, h)

    @staticmethod
    def backward(ctx, g):
        dh = None
        if ctx.needs_input_grad[8]:
            tile_off_t, val_t, seg_t, cols_t = ctx.saved_tensors
            dh = aggregate_edges(tile_off_t, val_t, seg_t, cols_t,
                                 g.float().contiguous()).to(g.dtype)
        return None, None, None, None, None, None, None, None, dh


# --- the fused aggregate -> update datapath -----------------------------------

# the reference takes the merged backward only up to this feature width
MERGED_MAX_F = 256
# output columns per thread block of the fused kernels (csrc/
# fused_update.cuh: NB)
_NB = 128
# aggregate_fused (csrc/aggregate_fused.cu): the most thread blocks of a
# cluster (the portable size)
_FWD_MAX_CLUSTER = 8
# fused_bwd's dw pass (csrc/aggregate_fused_bwd.cu): the z columns a thread
# block may take (S), the cap on its partials, and the work a block adds
# when it has a self term or a bias, in edges (staging its rows and dy
# tile, and its product, cost about as much as walking 512 edges)
_BWD_SLABS = (128, 32)
_BWD_PARTIAL_CAP = 8 << 20
_BWD_BLOCK_COST = 512
# fused_bwd_merged (csrc/aggregate_fused_bwd.cu): the destination block's
# rows a dw thread block takes; a cluster of 128 / 8 = 16 thread blocks (a
# size Hopper allows past the portable 8) takes them all
_MERGED_DW_ROWS = 8

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _act_grad(y: torch.Tensor, act: str) -> torch.Tensor:
    """d act(y) / dy for relu and the tanh-form gelu. With u the tanh's
    argument, 0.5 (1 + tanh u) = sigmoid(2u) and 1 - tanh(u)^2 = 4
    sigmoid(2u) sigmoid(-2u); this form keeps its accuracy where tanh
    saturates, which 1 - tanh^2 does not."""
    if act == "relu":
        return (y > 0.0).to(y.dtype)
    u2 = 2.0 * _SQRT_2_OVER_PI * (y + 0.044715 * y * y * y)
    sg = torch.sigmoid(u2)
    return sg + 2.0 * y * sg * torch.sigmoid(-u2) * _SQRT_2_OVER_PI * (
        1.0 + 3 * 0.044715 * y * y)


def _aggregate_z(tile_off, val, seg, cols, h, s):
    z = aggregate_edges_plain(tile_off, val, seg, cols, h)
    return z if s is None else z + s


def aggregate_fused_plain(tile_off, val, seg, cols, h, w, b=None, s=None,
                          act: str = "none") -> torch.Tensor:
    """Plain version of ``aggregate_fused``: ``act((A @ h [+ s]) @ w [+
    b])`` for every padded destination row, (n_dstb*128, N). With no edges
    (``E == 0``) the aggregate is zero and the rows are ``act(s @ w +
    b)``, as the reference's zero-capacity branch gives."""
    z = _aggregate_z(tile_off, val, seg, cols, h, s)
    return update_epilogue(z @ w, b, act)


def fused_bwd_plain(tile_off, val, seg, cols, h, g, w, b=None, s=None,
                    act: str = "none"):
    """Plain version of ``fused_bwd`` (the reference's ``_fused_bwd_call``):
    with z = A @ h [+ s] and dy = g * act'(z @ w [+ b]) (dy = g for act
    none), returns ``dw = z^T dy`` (F, N), ``db = sum_rows dy`` (N,) if a
    bias is given, and ``dy`` (n_dstb*128, N) if act is not none."""
    z = _aggregate_z(tile_off, val, seg, cols, h, s)
    if act == "none":
        dy = g
    else:
        dy = g * _act_grad(update_epilogue(z @ w, b, "none"), act)
    db = dy.sum(0) if b is not None else None
    return z.T @ dy, db, (dy if act != "none" else None)


def fused_bwd_merged_plain(tile_off, val, seg, cols, tile_off_t, val_t,
                           seg_t, cols_t, h, g, dz, s=None,
                           has_bias: bool = False):
    """Plain version of ``fused_bwd_merged`` (the reference's
    ``_fused_bwd_merged_call``, one destination block, act none): ``dw =
    z^T g``, ``db = sum_rows g`` if ``has_bias``, and ``dh = A^T @ dz``
    (n_srcb*128, F) with the source blocks that no slot of ``cols[0]``
    names set to +0.0."""
    z = _aggregate_z(tile_off, val, seg, cols, h, s)
    db = g.sum(0) if has_bias else None
    dh = aggregate_edges_plain(tile_off_t, val_t, seg_t, cols_t, dz)
    covered = torch.zeros(h.shape[0] // BLK, dtype=torch.bool,
                          device=h.device)
    covered[cols[0].long()] = True
    dh = torch.where(covered.repeat_interleave(BLK)[:, None], dh, 0.0)
    return z.T @ g, db, dh


def _check_fused(tile_off, val, seg, cols, h, w, b, s, act) -> None:
    _check(tile_off, val, seg, cols, h)
    check_tensor("w", w, h.device, torch.float32)
    if w.dim() != 2 or w.shape[0] != h.shape[1]:
        raise ValueError(f"w has shape {tuple(w.shape)}; expected "
                         f"({h.shape[1]}, N) for h {tuple(h.shape)}")
    if b is not None:
        check_tensor("b", b, h.device, torch.float32)
        if tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"b has shape {tuple(b.shape)}; expected "
                             f"({w.shape[1]},)")
    if s is not None:
        check_tensor("s", s, h.device, torch.float32)
        want = (cols.shape[0] * BLK, h.shape[1])
        if tuple(s.shape) != want:
            raise ValueError(f"s has shape {tuple(s.shape)}; expected "
                             f"{want}")
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}; expected one of "
                         f"{tuple(ACTS)}")


def _check_z_dtype(z_dtype) -> None:
    if z_dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"z_dtype={z_dtype} is not ported yet (ROADMAP.md queue A, "
            f"item A.15: reduced-precision datapaths); the port's fused "
            f"kernels run in float32")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def aggregate_fused_smem_bytes(slab: int) -> int:
    """Dynamic shared memory of one ``aggregate_fused`` thread block for a
    slab of ``slab`` z columns (builds the kernel)."""
    return _lib("aggregate_fused").aggregate_fused_smem_bytes(slab)


def aggregate_fused_max_clusters(slab: int, cluster: int) -> int:
    """The most clusters of ``cluster`` ``aggregate_fused`` thread blocks
    the current card runs at once at a slab of ``slab`` z columns
    (``cudaOccupancyMaxActiveClusters``; builds the kernel)."""
    return _lib("aggregate_fused").aggregate_fused_max_clusters(slab, cluster)


def aggregate_fused_shape(n_dstb: int, F: int, N: int, sms: int) -> tuple:
    """(slab, cluster, rounds) of ``aggregate_fused`` on a card of ``sms``
    SMs, from the shapes alone (no host sync). The grid is (cluster,
    n_dstb, N / 128 rounded up) thread blocks of 512 threads, one an SM
    (up to ~200 KB of shared memory); the ``cluster`` blocks of a
    destination block split its ``ceil(F / slab)`` slabs of z columns,
    rank r taking slabs r, r + cluster, ... (``rounds`` at most), and sum
    their partials through distributed shared memory. The cluster is at
    most 8 (the portable size).

    The slab is wide where that busies half the SMs, else 32: a wider
    slab walks each edge fewer times, a narrower one spreads a layer of
    few destination blocks (layer 1's 8) over more SMs. Wide is 160 z
    columns where that needs fewer slabs than 128, else 128: at F = 602
    it cuts the cluster from 5 thread blocks to 4, and the card runs 30
    clusters of 4 at once against 22 of 5 on an H100 (PERF.md)."""
    wide = 160 if -(-F // 160) < -(-F // 128) else 128
    for slab in (wide, 32):
        slabs = -(-F // slab)
        cluster = max(1, min(slabs, _FWD_MAX_CLUSTER))
        if 2 * cluster * n_dstb * -(-N // _NB) > sms:
            break
    return slab, cluster, -(-slabs // cluster)


def aggregate_fused(tile_off, val, seg, cols, h, w, b=None, s=None, *,
                    act: str = "none", z_dtype=None) -> torch.Tensor:
    """out = act((A @ h [+ s]) @ w [+ b]), the aggregate never written to
    device memory.

    The layout and h are as for ``aggregate_edges``; w (F, N), b (N,) and
    s (n_dstb*128, F) are float32 and unpadded; act is none, relu or gelu.
    Returns (n_dstb*128, N) float32. A CUDA tensor goes through
    ``csrc/aggregate_fused.cu`` in the grid ``aggregate_fused_shape``
    picks, a CPU tensor through ``aggregate_fused_plain``."""
    _check_z_dtype(z_dtype)
    _check_fused(tile_off, val, seg, cols, h, w, b, s, act)
    if not on_card("aggregate_fused", h):
        return aggregate_fused_plain(tile_off, val, seg, cols, h, w, b, s,
                                     act)
    n_dstb, max_blk = cols.shape
    F, N = w.shape
    out = torch.empty((n_dstb * BLK, N), dtype=torch.float32,
                      device=h.device)
    if out.numel() == 0:
        return out
    slab, cluster, _ = aggregate_fused_shape(n_dstb, F, N, sm_count(h))
    _check_smem("aggregate_fused", aggregate_fused_smem_bytes(slab))
    with torch.cuda.device(h.device):
        status = _lib("aggregate_fused").aggregate_fused_launch(
            tile_off.data_ptr(), val.data_ptr(), seg.data_ptr(),
            cols.data_ptr(), h.data_ptr(), w.data_ptr(), _ptr(b), _ptr(s),
            out.data_ptr(), n_dstb, max_blk, h.shape[0], F, N, ACTS[act],
            slab, cluster, stream(h))
    raise_on(status, "aggregate_fused", "aggregate_fused")
    launch_counts["aggregate_fused"] += 1
    return out


def fused_bwd_shape(n_dstb: int, F: int, N: int, sms: int) -> tuple:
    """(slab, groups) of ``fused_bwd``'s dw pass on a card of ``sms``
    SMs, from the shapes alone, so the grid (groups x slabs of z columns x
    tiles of 128 output columns) and the (groups, F, N) partials are sized
    without reading the device. The grid fills the card in one wave of one
    thread block an SM (a block takes 512 threads and ~170 KB of shared
    memory); the groups are at most ``n_dstb`` and keep the partials under
    ``_BWD_PARTIAL_CAP`` bytes. The slab is 128 z columns where that
    busies half the SMs, else 32: a wider slab walks each edge fewer
    times, a narrower one spreads a layer of few destination blocks
    (layer 1's 8) over more SMs."""
    cap = max(1, _BWD_PARTIAL_CAP // max(1, 4 * F * N))
    for slab in _BWD_SLABS:
        per_group = -(-F // slab) * -(-N // _NB)
        groups = max(1, min(n_dstb, cap, sms // per_group))
        if 2 * groups * per_group > sms:
            break
    return slab, groups


def fused_bwd_plan(seg: torch.Tensor, max_blk: int, groups: int,
                   dense: bool) -> torch.Tensor:
    """Cuts the destination blocks into ``groups`` contiguous groups of
    about equal work, on ``seg``'s device and with no host sync. Returns
    (groups + 1,) int64 bounds: group g takes blocks [bounds[g],
    bounds[g+1]), in order, so the partials still sum in one fixed order.

    A block's work is its edge count (``seg`` at block boundaries), plus
    ``_BWD_BLOCK_COST`` when ``dense`` (a self term s or a bias: then every
    block has rows to add, edges or not). Block i falls in the group whose
    share of the total work holds the midpoint of its own; a block with no
    work past the last busy one falls in no group, since it adds
    nothing."""
    cost = seg[::max_blk].long()  # work before each block, and the total
    if dense:
        cost += torch.arange(0, _BWD_BLOCK_COST * cost.numel(),
                             _BWD_BLOCK_COST, device=seg.device)
    mid2 = cost[:-1] + cost[1:]  # twice each block's midpoint
    # group g starts at the first block whose midpoint reaches g/groups of
    # the total: 2 g total // groups against mid2
    targets = torch.div(torch.arange(0, 2 * groups + 1, 2,
                                     device=seg.device) * cost[-1],
                        groups, rounding_mode="floor")
    return torch.searchsorted(mid2, targets)


def fused_bwd_smem_bytes(max_blk: int, slab: int) -> int:
    """Dynamic shared memory of ``fused_bwd``'s largest thread block for a
    layout with ``max_blk`` slots and the plan's slab (builds it)."""
    return _lib("aggregate_fused_bwd").fused_bwd_smem_bytes(max_blk, slab)


def fused_bwd(tile_off, val, seg, cols, h, g, w, b=None, s=None, *,
              act: str = "none", z_dtype=None):
    """The fused datapath's backward recompute pass (the reference's
    ``_fused_bwd_call``). Recomputes z = A @ h [+ s] per destination block
    and returns (dw (F, N), db (N,) or None, dy (n_dstb*128, N) or None);
    dy is returned when act is not none. g is (n_dstb*128, N) float32. A
    CUDA tensor goes through ``csrc/aggregate_fused_bwd.cu``, a CPU tensor
    through ``fused_bwd_plain``."""
    _check_z_dtype(z_dtype)
    _check_fused(tile_off, val, seg, cols, h, w, b, s, act)
    n_dstb, max_blk = cols.shape
    F, N = w.shape
    check_tensor("g", g, h.device, torch.float32)
    if tuple(g.shape) != (n_dstb * BLK, N):
        raise ValueError(f"g has shape {tuple(g.shape)}; expected "
                         f"({n_dstb * BLK}, {N})")
    if not on_card("fused_bwd", h):
        return fused_bwd_plain(tile_off, val, seg, cols, h, g, w, b, s, act)
    dev = h.device
    dw = torch.empty((F, N), dtype=torch.float32, device=dev)
    db = (torch.empty((N,), dtype=torch.float32, device=dev)
          if b is not None else None)
    dy = (torch.empty((n_dstb * BLK, N), dtype=torch.float32, device=dev)
          if act != "none" else None)
    if dw.numel() == 0 or n_dstb == 0:
        dw.zero_()
        return dw, (db.zero_() if db is not None else None), dy
    slab, groups = fused_bwd_shape(n_dstb, F, N, sm_count(h))
    bounds = fused_bwd_plan(seg, max_blk, groups,
                            s is not None or b is not None)
    part_dw = torch.empty((groups, F, N), dtype=torch.float32, device=dev)
    part_db = (torch.empty((groups, N), dtype=torch.float32, device=dev)
               if b is not None else None)
    _check_smem("fused_bwd", fused_bwd_smem_bytes(max_blk, slab))
    with torch.cuda.device(dev):
        status = _lib("aggregate_fused_bwd").fused_bwd_launch(
            tile_off.data_ptr(), val.data_ptr(), seg.data_ptr(),
            cols.data_ptr(), h.data_ptr(), g.data_ptr(), w.data_ptr(),
            _ptr(b), _ptr(s), bounds.data_ptr(), dw.data_ptr(), _ptr(db),
            _ptr(dy), part_dw.data_ptr(), _ptr(part_db), n_dstb, max_blk,
            h.shape[0], F, N, ACTS[act], groups, slab, stream(h))
    raise_on(status, "aggregate_fused_bwd", "fused_bwd")
    launch_counts["fused_bwd"] += 1
    return dw, db, dy


def fused_bwd_merged_shape(n_srcb: int, F: int, N: int, sms: int) -> tuple:
    """(dh_groups, dw_groups, thread blocks) of ``fused_bwd_merged`` on a
    card of ``sms`` SMs, from the shapes alone (no host sync). One launch
    of 256-thread blocks in clusters of ``dw_groups``: the first cluster
    takes the dw role, each rank ``_MERGED_DW_ROWS`` rows of the one
    destination block; then ``dh_groups`` row groups of each of the
    ``n_srcb`` source blocks take the dh role, sized as
    ``aggregate_edges_shape`` sizes them (each is that kernel's thread
    block over A^T), padded to whole clusters. N does not change the
    grid."""
    del N
    dh_groups = aggregate_edges_shape(n_srcb, F, sms)
    dw_groups = BLK // _MERGED_DW_ROWS
    return dh_groups, dw_groups, dw_groups * (1 + -(-dh_groups * n_srcb
                                                   // dw_groups))


def fused_bwd_merged_smem_bytes(F: int, dw_groups: int) -> int:
    """Dynamic shared memory of a ``fused_bwd_merged`` thread block: the dw
    role's z and s tiles, R x ldz each (R = 128 / dw_groups rows, ldz = F
    rounded up to 32, plus 8), and its g tile, R x 136, as
    ``csrc/aggregate_fused_bwd.cu``'s launcher sizes it. Beside it every
    thread block holds the row walk's static shared memory
    (``csrc/edge_rows.cuh``: Smem, ~31 KB)."""
    R = BLK // dw_groups
    return 4 * R * (2 * (-(-F // 32) * 32 + 8) + _NB + 8)


def fused_bwd_merged(tile_off, val, seg, cols, tile_off_t, val_t, seg_t,
                     cols_t, h, g, dz, s=None, *, has_bias: bool = False,
                     z_dtype=None):
    """The single-pass backward for one destination block and act none
    (the reference's ``_fused_bwd_merged_call``): dw and db from the
    forward segments and ``dh = A^T @ dz`` from the transposed ones, in one
    launch. g is (128, N), dz (128, F); returns (dw (F, N), db (N,) or
    None, dh (n_srcb*128, F)), dh +0.0 on source blocks no slot of
    ``cols[0]`` names. A CUDA tensor goes through
    ``csrc/aggregate_fused_bwd.cu``, a CPU tensor through
    ``fused_bwd_merged_plain``."""
    _check_z_dtype(z_dtype)
    _check(tile_off, val, seg, cols, h)
    _check(tile_off_t, val_t, seg_t, cols_t, dz)
    n_dstb, max_blk = cols.shape
    n_srcb, max_blk_t = cols_t.shape
    F = h.shape[1]
    if n_dstb != 1 or F > MERGED_MAX_F or tile_off_t.numel() == 0:
        raise ValueError(f"fused_bwd_merged takes one destination block, "
                         f"F <= {MERGED_MAX_F} and a non-empty A^T; got "
                         f"n_dstb={n_dstb}, F={F}, "
                         f"E_t={tile_off_t.numel()}")
    check_tensor("g", g, h.device, torch.float32)
    if g.dim() != 2 or g.shape[0] != BLK:
        raise ValueError(f"g has shape {tuple(g.shape)}; expected "
                         f"({BLK}, N)")
    if tuple(dz.shape) != (BLK, F) or n_srcb * BLK != h.shape[0]:
        raise ValueError(f"dz {tuple(dz.shape)} and cols_t "
                         f"{tuple(cols_t.shape)} do not fit h "
                         f"{tuple(h.shape)}")
    if s is not None:
        check_tensor("s", s, h.device, torch.float32)
        if tuple(s.shape) != (BLK, F):
            raise ValueError(f"s has shape {tuple(s.shape)}; expected "
                             f"({BLK}, {F})")
    if not on_card("fused_bwd_merged", h):
        return fused_bwd_merged_plain(tile_off, val, seg, cols, tile_off_t,
                                      val_t, seg_t, cols_t, h, g, dz, s,
                                      has_bias)
    N = g.shape[1]
    dev = h.device
    dw = torch.empty((F, N), dtype=torch.float32, device=dev)
    db = (torch.empty((N,), dtype=torch.float32, device=dev)
          if has_bias else None)
    dh = torch.empty_like(h)
    dh_groups, dw_groups, _ = fused_bwd_merged_shape(n_srcb, F, N,
                                                     sm_count(h))
    # the dw role's partials: D fragments of dw padded to (16 x 8) tiles
    tiles = dw_groups * -(-F // 16) * 16 * -(-N // 8) * 8
    part = torch.empty((tiles + (dw_groups * N if has_bias else 0),),
                       dtype=torch.float32, device=dev)
    part_db = part[tiles:] if has_bias else None
    vec = min(aggregate_edges_vec(h), aggregate_edges_vec(dz))
    with torch.cuda.device(dev):
        status = _lib("aggregate_fused_bwd").fused_bwd_merged_launch(
            tile_off.data_ptr(), val.data_ptr(), seg.data_ptr(),
            cols.data_ptr(), tile_off_t.data_ptr(), val_t.data_ptr(),
            seg_t.data_ptr(), cols_t.data_ptr(), h.data_ptr(), g.data_ptr(),
            dz.data_ptr(), _ptr(s), dw.data_ptr(), _ptr(db), dh.data_ptr(),
            part.data_ptr(), _ptr(part_db), max_blk, max_blk_t, h.shape[0],
            F, N, dh_groups, dw_groups, vec, stream(h))
    raise_on(status, "aggregate_fused_bwd", "fused_bwd_merged")
    launch_counts["fused_bwd_merged"] += 1
    return dw, db, dh


class AggregateFused(torch.autograd.Function):
    """Differentiable ``act((A @ h [+ s]) @ w [+ b])`` (the reference's
    ``aggregate_fused_vjp``). The backward takes the reference's branches:
    one destination block with act none, F <= 256 and a non-empty A^T
    takes ``fused_bwd_merged``; every other layer takes ``fused_bwd`` and
    then ``aggregate_edges`` over A^T for ``dh``. A layer with no edges
    takes the second branch too, where it gives the reference's
    zero-capacity cotangents (z = s, dh = 0). ``dz = dy @ w^T`` is a plain
    ``torch.matmul``. The second branch computes ``dh`` only when ``h``
    needs a gradient (the input features get none); the merged branch
    forms it in the same launch and drops it then."""

    @staticmethod
    def forward(ctx, tile_off, val, seg, cols, tile_off_t, val_t, seg_t,
                cols_t, h, w, b, s, act):
        ctx.act = act
        ctx.save_for_backward(tile_off, val, seg, cols, tile_off_t, val_t,
                              seg_t, cols_t, h, w, b, s)
        return aggregate_fused(tile_off, val, seg, cols, h, w, b, s, act=act)

    @staticmethod
    def backward(ctx, g):
        (tile_off, val, seg, cols, tile_off_t, val_t, seg_t, cols_t, h, w,
         b, s) = ctx.saved_tensors
        act = ctx.act
        need_h, need_w, need_b, need_s = ctx.needs_input_grad[8:12]
        g = g.float().contiguous()
        n_dstb = cols.shape[0]
        F = h.shape[1]
        dh = dz = None
        if (n_dstb == 1 and act == "none" and F <= MERGED_MAX_F
                and tile_off_t.numel() > 0):
            dy = g
            dz = (g @ w.T).contiguous()
            dw, db, dh = fused_bwd_merged(
                tile_off, val, seg, cols, tile_off_t, val_t, seg_t, cols_t,
                h, g, dz, s, has_bias=b is not None)
        else:
            dw, db, dy = fused_bwd(tile_off, val, seg, cols, h, g, w, b, s,
                                   act=act)
            if dy is None:
                dy = g
        if dz is None and (need_h or need_s):
            dz = (dy @ w.T).contiguous()
        if need_h and dh is None:
            dh = aggregate_edges(tile_off_t, val_t, seg_t, cols_t, dz)
        return (None,) * 8 + (dh if need_h else None,
                              dw if need_w else None,
                              db if need_b else None,
                              dz if need_s else None, None)

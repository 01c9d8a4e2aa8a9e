"""Dispatch wrappers for the kernels (counterpart of
``repro.kernels.ops``, with its signatures and keyword names).

``use_pallas=True`` (the default) takes the hand-written CUDA kernel on a
CUDA tensor, and the kernel's plain version on a CPU tensor, as every
wrapper in ``kernels/`` does. ``use_pallas=False`` takes the reference's
other branch: the plain version of ``update`` and ``aggregate`` on any
device, and for ``aggregate_update`` the unfused composition, the
``aggregate_edges`` wrapper followed by the matmul and the epilogue. The
name is the reference's; here it picks a kernel, not Pallas.
"""
from __future__ import annotations

from repro_torch.kernels.aggregate import (aggregate_blockcsr,
                                           aggregate_blockcsr_plain,
                                           aggregate_edges, aggregate_fused)
from repro_torch.kernels.update_mlp import (update_epilogue, update_mlp,
                                            update_mlp_plain)


def update(x, w, b, *, act: str = "none", use_pallas: bool = True):
    """act(x @ w + b) through ``update_mlp``; with ``use_pallas=False``
    its plain version, in fp32 and cast back to x's dtype as the
    reference's ``update_mlp_ref``."""
    if use_pallas:
        return update_mlp(x, w, b, act)
    return update_mlp_plain(x, w, b, act).to(x.dtype)


def aggregate(blocks, cols, h_in, *, feat_block: int = 256,
              use_pallas: bool = True):
    """A @ h_in over dense block-CSR tiles through ``aggregate_blockcsr``.
    ``feat_block`` is the reference's feature block; the kernel masks a
    ragged F instead of padding it, so the value does not change the
    result."""
    if feat_block < 1:
        raise ValueError(f"feat_block must be >= 1, got {feat_block}")
    if use_pallas:
        return aggregate_blockcsr(blocks, cols, h_in)
    return aggregate_blockcsr_plain(blocks, cols, h_in)


def aggregate_update(tile_off, val, seg, cols, h_in, w, b=None, s=None, *,
                     act: str = "none", use_pallas: bool = True):
    """act((A @ h [+ s]) @ w [+ b]) with A in tile-sorted edge-segment
    form: one ``aggregate_fused`` launch, or with ``use_pallas=False`` the
    ``aggregate_edges`` aggregate, then the matmul and the epilogue."""
    if use_pallas:
        return aggregate_fused(tile_off, val, seg, cols, h_in, w, b, s,
                               act=act)
    z = aggregate_edges(tile_off, val, seg, cols,
                        h_in.float()).to(h_in.dtype)
    if s is not None:
        z = z + s
    return update_epilogue(z @ w, b, act)


def flash_attention(q, k, v, *, causal: bool = True,
                    use_pallas: bool = True):
    raise NotImplementedError(
        "flash_attention is not ported yet (ROADMAP.md queue B, item B.7, "
        "with the LM zoo)")


def wkv6(r, k, v, lw, u, *, chunk: int = 16, use_pallas: bool = True):
    raise NotImplementedError(
        "wkv6 is not ported yet (ROADMAP.md queue B, item B.8, with the LM "
        "zoo)")

"""Dispatch wrappers for the kernels (counterpart of
``repro.kernels.ops``, with its signatures and keyword names).

``use_pallas=True`` (the default) takes the hand-written CUDA kernel on a
CUDA tensor, and the kernel's plain version on a CPU tensor, as every
wrapper in ``kernels/`` does. ``use_pallas=False`` takes the reference's
other branch: the plain version of ``update`` and ``aggregate`` on any
device, and for ``aggregate_update`` the unfused composition, the
``aggregate_edges`` wrapper followed by the matmul and the epilogue. The
name is the reference's; here it picks a kernel, not Pallas. For
``flash_attention`` and ``wkv6`` the other branch is the oracle of
``kernels/ref.py``, as in the reference.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.aggregate import (aggregate_blockcsr,
                                           aggregate_blockcsr_plain,
                                           aggregate_edges, aggregate_fused)
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.update_mlp import (update_epilogue, update_mlp,
                                            update_mlp_plain)
from repro_torch.kernels.wkv6 import wkv6_chunk


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
    """Softmax attention over q (BH, Sq, D) and k, v (BH, Sk, D), GQA
    already repeated: ``flash_attention_fwd`` (one head per BH row), or
    with ``use_pallas=False`` the oracle ``ref.attention_ref``."""
    if not use_pallas:
        return ref.attention_ref(q, k, v, causal)
    return flash_attention_fwd(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal)[:, :, 0]


def wkv6(r, k, v, lw, u, *, chunk: int = 16, use_pallas: bool = True):
    """The WKV6 recurrence from a zero state over r, k, lw (BH, S, K), v
    (BH, S, V) and u (BH, 1, K); returns y (BH, S, V) in r's dtype:
    ``wkv6_chunk`` (one head per BH row, its final state dropped), or with
    ``use_pallas=False`` the oracle ``ref.wkv6_ref``. The kernel walks
    chunks of 16 whatever ``chunk`` says, as the plain version does: the
    result does not depend on the chunk beyond rounding."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if not use_pallas:
        return ref.wkv6_ref(r, k, v, lw, u)
    y, _ = wkv6_chunk(*(t[:, :, None] for t in (r, k, v, lw)), u)
    return y[:, :, 0]

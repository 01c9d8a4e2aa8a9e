"""``fused_bwd_merged`` and its plain version, each run again and again on
the card in one process, on the cases of
``tests/test_torch_fused.py::test_merged_kernel_matches_plain_on_card``
whose destination rows hold thousands of edges: which side changes its
bits from run to run, and which side is nearer the exact result.

For each case, ``--repeats`` runs each of: the kernel; the plain version
as the package has it (``aggregate.fused_bwd_merged_plain``); the plain
version with its aggregate summed by ``index_add_`` (atomics on the card,
the package's sum before the repair of ROADMAP.md C.9); and cuBLAS's
``z^T g`` alone on one fixed z. One JSON line a case: for each of them the
number of distinct bit patterns of dw over the runs, and the largest
distance of any run's dw from dw in float64 (the aggregate and the product
summed in float64 on the CPU); then the largest distance of the kernel's
dw from each plain version's over the runs, beside the test's allowance
(rtol 1e-5 of the plain value plus 1e-6 of the plain dw's largest
magnitude). Exits 1 if the kernel or the package's plain version gave more
than one bit pattern.

Run on the card from the repository's root:
    PYTHONPATH=src:tests python tests/merged_plain_repeat.py --repeats 20
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

from repro_torch.kernels import aggregate as agg
from test_torch_fused import (BWD, FWD, RTOL, _atol, _layout, _layout_t,
                              _operands, _t)

CASES = (("single_block_dense_row", 128, 41, False, True),
         ("single_block_dense_row", 256, 130, True, False),
         ("single_block_multi_edge", 128, 41, False, True))


def _bits(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def _z_index_add(lay, h, s):
    """The plain aggregate as it was: ``index_add_`` over the valid
    edges, plus the self term."""
    tile_off, val, seg, cols = lay[:4]
    n_dstb, max_blk = cols.shape
    out = torch.zeros((n_dstb * agg.BLK, h.shape[1]), dtype=h.dtype,
                      device=h.device)
    n = int(seg[-1])
    e = torch.arange(n, dtype=seg.dtype, device=seg.device)
    t = (torch.searchsorted(seg, e, right=True) - 1).long()
    i, k = t // max_blk, t % max_blk
    off = tile_off[:n].long()
    out.index_add_(0, i * agg.BLK + off // agg.BLK,
                   val[:n, None] * h[cols[i, k].long() * agg.BLK
                                     + off % agg.BLK])
    return out if s is None else out + s


def run_case(name, F, N, bias, self_term, repeats) -> dict:
    coo = _layout(name)
    ops = _operands(coo, F, N, bias, self_term)
    h, w, _, s, g = (None if x is None else _t(x).cuda() for x in ops)
    dz = (g @ w.T).contiguous()
    lay = [t.cuda() for t in _layout_t(coo, FWD + BWD)]
    # float64 on the CPU: the aggregate, then z^T g
    lay64 = [t.cpu() for t in lay[:4]]
    z64 = agg.aggregate_edges_plain(*lay64, h.cpu().double())
    if s is not None:
        z64 = z64 + s.cpu().double()
    dw64 = z64.T @ g.cpu().double()
    z_fixed = _z_index_add(lay, h, s)
    variants = {
        "kernel": lambda: agg.fused_bwd_merged(*lay, h, g, dz, s,
                                               has_bias=bias)[0],
        "plain": lambda: agg.fused_bwd_merged_plain(*lay, h, g, dz, s,
                                                    bias)[0],
        "plain_index_add": lambda: _z_index_add(lay, h, s).T @ g,
        "cublas_only": lambda: z_fixed.T @ g}
    runs = {key: [] for key in variants}
    for _ in range(repeats):
        for key, fn in variants.items():
            runs[key].append(fn().clone())
    torch.cuda.synchronize()
    row = {"case": [name, F, N, bias, self_term], "repeats": repeats,
           "dw_shape": list(dw64.shape),
           "max_abs_dw": float(dw64.abs().max())}
    for key, outs in runs.items():
        row[key] = {
            "bit_patterns": len({_bits(o) for o in outs}),
            "max_abs_err_vs_fp64": max(
                float((o.cpu().double() - dw64).abs().max()) for o in outs)}
    for key in ("plain", "plain_index_add"):
        worst, where, ratio = 0.0, None, 0.0
        for k_out, p_out in zip(runs["kernel"], runs[key]):
            p = p_out.cpu()
            allow = RTOL * p.abs() + _atol(p)
            err = (k_out.cpu() - p).abs()
            r = float((err / allow).max())
            if r > ratio:
                ratio = r
                worst = float(err.max())
                where = list(divmod(int((err / allow).argmax()),
                                    p.shape[1]))
        row[f"kernel_vs_{key}"] = {"max_abs_err": worst,
                                   "worst_share_of_allowance": ratio,
                                   "at": where}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("merged_plain_repeat: needs a CUDA card", file=sys.stderr)
        return 1
    bad = False
    for case in CASES:
        row = run_case(*case, args.repeats)
        print("merged_repeat " + json.dumps(row), flush=True)
        bad |= row["kernel"]["bit_patterns"] != 1
        bad |= row["plain"]["bit_patterns"] != 1
    print(json.dumps({"ok": not bad,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

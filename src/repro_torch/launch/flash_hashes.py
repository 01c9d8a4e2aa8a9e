"""Bit-for-bit comparison of two builds of ``flash_attention_fwd`` on the
card: the sha256 of its output (with and without the log-sum-exp) and of
its lse at ``chip_smoke.py``'s forward shapes and the backward launches'
shapes, from seeded inputs, and the time of the Llama-3-8B prefill launch
(CUDA events, 20 launches). A change that only moves code must leave
every hash as it was.

Run it from each checkout (on the card), the second time against the
first's output; it exits 1 if a hash differs:

    PYTHONPATH=src python -m repro_torch.launch.flash_hashes > before.json
    PYTHONPATH=src python -m repro_torch.launch.flash_hashes --against before.json

For a checkout that predates this module, run this file by its path with
that checkout's ``src`` on ``PYTHONPATH``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

# (name, B, Sq, Sk, H, KH, D, dtype, causal)
SHAPES = (
    ("llama3_8b_prefill", 4, 4096, 4096, 32, 8, 128, torch.bfloat16, True),
    ("fp32_causal", 1, 1024, 1024, 32, 8, 128, torch.float32, True),
    ("noncausal_ragged", 2, 1000, 1537, 8, 2, 128, torch.bfloat16, False),
    ("llama3_8b_train", 1, 4096, 4096, 32, 8, 128, torch.bfloat16, True),
    ("ragged_causal", 2, 1000, 1000, 4, 2, 64, torch.bfloat16, True),
    ("noncausal_cross", 2, 448, 1500, 20, 20, 64, torch.bfloat16, False),
)
TIMED = "llama3_8b_prefill"


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hashes() -> dict:
    """{shape: {"out", "out_lse", "lse": sha256}} and the timed launch's
    ms under "ms"."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    got = {}
    for name, B, Sq, Sk, H, KH, D, dtype, causal in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((B, S, h, D), device="cuda", generator=gen)
                   .to(dtype) for S, h in ((Sq, H), (Sk, KH), (Sk, KH)))
        out = flash_attention_fwd(q, k, v, causal)
        out_lse, lse = flash_attention_fwd(q, k, v, causal, return_lse=True)
        got[name] = {"out": _sha(out), "out_lse": _sha(out_lse),
                     "lse": _sha(lse)}
        if name == TIMED:
            got["ms"] = _ms(lambda: flash_attention_fwd(q, k, v, causal))
        del q, k, v, out, out_lse, lse
        torch.cuda.empty_cache()
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another build's output (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_hashes: needs a CUDA card", file=sys.stderr)
        return 2
    got = hashes()
    if args.against is None:
        print(json.dumps(got))
        return 0
    with open(args.against) as f:
        ref = json.load(f)
    same = {name: got[name] == ref[name] for name, *_ in SHAPES}
    print(json.dumps({"bitwise": same, "ms": got["ms"],
                      "against_ms": ref["ms"]}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

"""How well conditioned Zamba2-2.7B's training gradient is in fp32: one
micro-step's loss and every gradient leaf at the published widths (or a
cut width), from the same seeded parameters and tokens, in fp32 on the
card (TF32 off), in fp32 on the CPU and in float64 on the CPU. Per depth,
one JSON line: the float64 gradient norm, and per leaf the largest error
of each fp32 run against float64 and of the card against the CPU, each as
a share of the leaf's largest float64 magnitude (the share ``chip_smoke.py``'s
``train_vs_cpu`` holds under 1e-4); then the worst leaf of each.

    PYTHONPATH=src python tests/zamba2_fp32_conditioning.py --layers 6 12
    PYTHONPATH=src python tests/zamba2_fp32_conditioning.py --device cpu \\
        --d-model 512 --layers 6 12

The second runs here at a cut width (d 512, 8 heads of 64, d_ff 1,024,
vocab 1,000) without a card: then "card" is a second CPU fp32 run. The
float64 run widens the plain flash version's dtypes (its CPU path only);
the rest of the port takes float64 as it is. Exit 1 if a value is not
finite.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _grads(bundle, params, batch, dtype, device):
    import torch
    from repro_torch.launch.steps import _loss_and_grads
    from repro_torch.nn.param import flatten, unflatten
    p = unflatten(params, [t.to(device=device, dtype=dtype)
                           for t in flatten(params)])
    b = {k: v.to(device) for k, v in batch.items()}
    loss, _, grads = _loss_and_grads(bundle, p, flatten(p), b)
    return loss.double().cpu(), [g.double().cpu() for g in grads]


def one_depth(layers: int, args) -> dict:
    import torch
    from repro_torch.checkpoint.checkpointing import flatten_with_paths
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build, sample_inputs
    cfg = get_config("zamba2-2.7b").replace(n_layers=layers)
    if args.d_model:
        cfg = cfg.replace(d_model=args.d_model, n_heads=args.d_model // 64,
                          n_kv_heads=args.d_model // 64,
                          d_ff=2 * args.d_model, vocab_size=1000)
    bundle = build(cfg)
    params = bundle.init_params(args.seed, torch.float32, "cpu")
    batch = sample_inputs(cfg, ShapeSpec("c", args.tokens, 1, "train"),
                          np.random.default_rng(args.seed), "cpu")
    runs = {"card": _grads(bundle, params, batch, torch.float32,
                           args.device),
            "cpu": _grads(bundle, params, batch, torch.float32, "cpu"),
            "f64": _grads(bundle, params, batch, torch.float64, "cpu")}
    names = list(flatten_with_paths(params))
    exact = runs["f64"][1]
    leaves = {}
    for i, name in enumerate(names):
        scale = max(1.0, float(exact[i].abs().max()))
        leaves[name] = {
            "card_vs_f64": float((runs["card"][1][i] - exact[i]).abs().max())
            / scale,
            "cpu_vs_f64": float((runs["cpu"][1][i] - exact[i]).abs().max())
            / scale,
            "card_vs_cpu": float((runs["card"][1][i] - runs["cpu"][1][i])
                                 .abs().max()) / scale}
    finite = all(bool(torch.isfinite(g).all()) for r in runs.values()
                 for g in r[1])
    row = {"layers": layers, "d_model": cfg.d_model, "tokens": args.tokens,
           "device": args.device, "finite": finite,
           "loss": {k: float(v[0]) for k, v in runs.items()},
           "grad_norm_f64": float(torch.sqrt(sum((g ** 2).sum()
                                                  for g in exact))),
           "worst": {k: max((v[k], n) for n, v in leaves.items())
                     for k in ("card_vs_f64", "cpu_vs_f64", "card_vs_cpu")},
           "leaves": leaves}
    if args.device != "cpu":
        row["card"] = torch.cuda.get_device_name(0)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[6, 12])
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d-model", type=int, default=0,
                    help="a cut width (0: the published 2,560)")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.DTYPES = {**fa.DTYPES, torch.float64: -1}
    ok = True
    for layers in args.layers:
        row = one_depth(layers, args)
        ok &= row["finite"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

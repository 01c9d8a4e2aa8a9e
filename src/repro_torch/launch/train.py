"""LM training launcher (counterpart of ``repro.launch.train``): trains an
arch's smoke config from the seeded init on numpy-seeded tokens, through
``launch.steps.make_train_step`` and AdamW, with optional checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu

It runs on the card unless ``--device cpu`` is given. Checkpoints go
through ``checkpoint.checkpointing.Checkpointer`` in the reference's
on-disk format: the parameters' tree, and the optimizer's state as the
reference's ``{"m": tree, "v": tree, "step"}``, so either package restores
the other's. ``--resume`` restores the newest valid checkpoint and draws
(and drops) the batches of the steps it already took, so a resumed run
sees the batches of the uninterrupted one (the reference's launcher draws
its generator afresh from the resumed step). The reference's ``--dry``
lowers the full config through XLA, which has no counterpart here: it
raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _opt_tree(params, opt_state) -> dict:
    """The optimizer's state as the reference's tree."""
    from repro_torch.nn.param import unflatten
    return {"m": unflatten(params, opt_state["m"]),
            "v": unflatten(params, opt_state["v"]),
            "step": opt_state["step"]}


def main(argv=None) -> dict:
    """Runs the launcher; returns {"params", "opt_state", "losses" (one a
    step taken), "start"} for a caller that drives it in process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry", action="store_true",
                    help="the reference's XLA lowering of the full config; "
                         "no counterpart here")
    args = ap.parse_args(argv)

    if args.dry:
        raise NotImplementedError(
            "--dry lowers the full config through XLA's compiler on a TPU "
            "mesh (the reference's launch/dryrun.py), which has no "
            "counterpart in the PyTorch port")

    import torch

    from repro_torch.checkpoint.checkpointing import Checkpointer
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build, sample_inputs
    from repro_torch.nn.param import flatten
    from repro_torch.optim.adam import AdamW
    from repro_torch.optim.schedules import get_schedule

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    bundle = build(cfg)
    params = bundle.init_params(0, torch.float32, device)
    opt = AdamW(get_schedule(cfg.lr_schedule, args.lr, 10, args.steps))
    opt_state = opt.init(flatten(params))
    step_fn = make_train_step(bundle, opt)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    start = 0
    if ckpt is not None and args.resume and ckpt.latest_step() is not None:
        restored = ckpt.restore(ckpt.latest_step(), params,
                                _opt_tree(params, opt_state))
        params = restored["params"]
        opt_state = {"m": flatten(restored["opt"]["m"]),
                     "v": flatten(restored["opt"]["v"]),
                     "step": restored["opt"]["step"]}
        start = restored["step"]
        print(f"resumed from step {start}")

    rng = np.random.default_rng(0)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    for _ in range(start):  # the batches of the steps already taken
        sample_inputs(cfg, shape, rng, "cpu")
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = sample_inputs(cfg, shape, rng, device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % 5 == 0 or step == args.steps - 1:
            tok_s = (args.batch * args.seq * (step - start + 1)
                     / (time.time() - t0))
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} tok/s={tok_s:.0f}")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, params, _opt_tree(params, opt_state))
    if ckpt is not None:
        ckpt.wait()
    print(f"done: {args.steps - start} steps ({cfg.name})")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "start": start}


if __name__ == "__main__":
    main()

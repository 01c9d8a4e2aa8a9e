"""A MoE model's routing at its published widths, the port against the
reference on the CPU: each layer's expert choices and the (token, slot)
pairs each package drops at capacity in a prefill, from the same seeded
weights and tokens.

The port's weights are drawn by ``ModelBundle.init_params(seed, float32,
"cpu")`` and carried into ``repro`` as numpy; the tokens come from
``numpy.random.default_rng(seed)``. Both packages run the prefill layer by
layer (``repro`` under ``jax.jit``, ``repro.nn.moe.route`` wrapped while
it is traced, as ``tests/test_torch_moe_train.py`` does). The port's drops
are its own ``nn.moe.rank``'s; the reference's follow from its experts:
a batch row drops max(0, n_e - C) pairs of an expert that n_e of its pairs
chose, whatever order it ranks them in. Beside them, for the reason of a
high drop share, each layer's router input: the share of its energy in the
component its batch row's tokens share (||mean_s h||^2 / mean_s ||h||^2,
near 0 for unrelated tokens, 1 for equal ones), and the share of its pairs
that the 8 busiest experts of their row take.

Run (OLMoE-1B-7B at 3 layers and 1 x 4,096 tokens, C 640 as in a 4,096
token prefill: about 2 minutes and 12 GiB of host memory):
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/moe_routing_compare.py \\
        --arch olmoe-1b-7b --layers 3 --seq 4096
One JSON line a layer, then a summary line; exits 1 if the packages'
experts or drops differ.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch


def dropped(experts: np.ndarray, E: int, C: int) -> int:
    """experts: (B, S, K). The pairs dropped at a per-row capacity C."""
    B = experts.shape[0]
    counts = np.stack([np.bincount(experts[b].ravel(), minlength=E)
                       for b in range(B)])
    return int(np.maximum(counts - C, 0).sum())


def _port_layers(cfg, params, tokens) -> list[dict]:
    """The port's prefill, layer by layer: experts (B, S, K), kept pairs by
    ``nn.moe.rank``, and the router input's statistics."""
    from repro_torch.models import lm
    from repro_torch.nn import moe
    seen, route, rank = [], moe.route, moe.rank
    B, S = tokens.shape

    def recording_route(router_w, x, m):
        out = route(router_w, x, m)
        h = x.float().view(B, S, -1)
        shared = (h.mean(1).pow(2).sum(-1)
                  / h.pow(2).sum(-1).mean(1)).mean()
        seen.append({"experts": out[1].view(B, S, -1).numpy().copy(),
                     "shared_share": float(shared)})
        return out

    def recording_rank(experts, m, C):
        slots = rank(experts, m, C)
        seen[-1]["kept"] = int(slots.keep.sum())
        return slots
    moe.route, moe.rank = recording_route, recording_rank
    try:
        with torch.no_grad():
            lm.forward(params, cfg, torch.from_numpy(tokens), mode="prefill")
    finally:
        moe.route, moe.rank = route, rank
    return seen


def _reference_layers(cfg, jp, tokens) -> list[np.ndarray]:
    """The reference's prefill, layer by layer: each layer's experts."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as j_lm
    from repro.nn import moe as j_moe
    route = j_moe.route

    def layers(jp, tokens):
        seen = []

        def recording(*a):
            out = route(*a)
            seen.append(out[1])
            return out
        j_moe.route = recording
        try:
            x = j_lm.L.embed_tokens(jp["embed"], tokens)
            positions = jnp.arange(tokens.shape[1])[None, :]
            for l in range(cfg.n_layers):
                p_l = jax.tree.map(lambda a, l=l: a[l], jp["layers"])
                x, _, _ = j_lm._layer_apply(cfg, p_l, x, positions,
                                            "prefill", None, "seq_kv")
        finally:
            j_moe.route = route
        return seen
    B, S = tokens.shape
    return [np.asarray(e).reshape(B, S, -1)
            for e in jax.jit(layers)(jp, jnp.asarray(tokens))]


def compare(arch: str, layers: int, seq: int, batch: int = 1, seed: int = 0,
            capacity_factor: float | None = None,
            smoke: bool = False) -> list[dict]:
    """One row a layer: both packages' drops, the tokens whose experts
    differ, and the router input's statistics."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as j_reg
    from repro_torch.configs import registry as t_reg
    from repro_torch.models.registry import build
    from repro_torch.nn.moe import capacity
    from repro_torch.nn.param import params_to_numpy

    def cut(cfg):
        cfg = cfg.replace(n_layers=layers)
        if capacity_factor is not None:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        return cfg
    get = "get_smoke_config" if smoke else "get_config"
    cfg, j_cfg = cut(getattr(t_reg, get)(arch)), cut(getattr(j_reg, get)(arch))
    m = cfg.moe
    C = capacity(seq, m)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    params = build(cfg).init_params(seed, torch.float32, "cpu")
    port = _port_layers(cfg, params, tokens)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(params))
    del params
    ref = _reference_layers(j_cfg, jp, tokens)
    del jp
    rows, pairs = [], batch * seq * m.top_k
    for l, (p, r) in enumerate(zip(port, ref)):
        e = p["experts"]
        busiest = sum(np.sort(np.bincount(e[b].ravel(),
                                          minlength=m.num_experts))[-8:].sum()
                      for b in range(batch))
        rows.append({
            "layer": l, "capacity_per_row": C, "pairs": pairs,
            "dropped_port": pairs - p["kept"],
            "dropped_port_from_experts": dropped(e, m.num_experts, C),
            "dropped_reference": dropped(r, m.num_experts, C),
            "drop_share_reference": dropped(r, m.num_experts, C) / pairs,
            "tokens_whose_experts_differ": int(
                (e != r).any(-1).sum()),
            "router_input_shared_share": p["shared_share"],
            "busiest_8_experts_share": float(busiest) / pairs})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config, not its published one")
    a = ap.parse_args(argv)
    rows = compare(a.arch, a.layers, a.seq, a.batch, a.seed,
                   a.capacity_factor, a.smoke)
    for row in rows:
        print("moe_routing " + json.dumps(row), flush=True)
    same = all(r["dropped_port"] == r["dropped_reference"]
               and r["tokens_whose_experts_differ"] == 0 for r in rows)
    print("moe_routing_summary " + json.dumps({
        "arch": a.arch, "layers": a.layers, "batch": a.batch, "seq": a.seq,
        "seed": a.seed, "same_experts_and_drops": same,
        "drop_share_port": sum(r["dropped_port"] for r in rows)
        / sum(r["pairs"] for r in rows)}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

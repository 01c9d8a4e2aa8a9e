"""The port's LM zoo (the ``smoke()`` configs of Llama-3-8B, MiniCPM-2B,
StarCoder2-7B, Yi-9B, RWKV-6-3B, OLMoE-1B-7B, Grok-1 and LLaVA-NeXT-34B)
against ``repro``: the configs, the weight bridge, the standalone init's
laws, the dense model's building blocks (norms, rope, MLP, logits,
attention in prefill and decode) and the dense and MoE models'
``prefill_fn`` and ``decode_fn``, on the same numpy-seeded inputs and
bridged parameters, in fp32 on the CPU (the VLM's prefix:
``tests/test_torch_vlm.py``).

Tolerance: rtol 1e-4 / atol 1e-5 for the blocks (fp32 products over at
most 192 terms, taken in another order), and rtol 1e-4 / atol 1e-4 for
whole-model logits and caches (two layers of those, the softmax taken in
one pass against the reference's chunked online one), each atol times
the largest magnitude of the reference's result (at least 1). JAX is imported
only inside the tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.registry import build, sample_inputs
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tL
from repro_torch.nn.param import (flatten, param_count, params_from_numpy,
                                  params_to_numpy)

BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
DENSE = ("minicpm-2b", "starcoder2-7b", "yi-9b")
ARCHS = ("llama3-8b", "rwkv6-3b", "olmoe-1b-7b", "grok-1-314b",
         "llava-next-34b") + DENSE


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jax_bundle(arch, seed=0):
    """The reference's bundle for ``arch``'s smoke config, its fp32
    parameters, and the port's bundle with them bridged."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import build as j_build
    jb = j_build(j_smoke(arch))
    jp = jb.init_params(jax.random.PRNGKey(seed), jnp.float32)
    tb = build(get_smoke_config(arch))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jb, jp, tb, tp


def _close(got, want, tol):
    """assert_allclose with atol times the largest magnitude of ``want``
    (at least 1): an element that cancels towards zero keeps the absolute
    error of its terms' size."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


# ---------------------------------------------------------------------------
# configs, bridge, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    import dataclasses

    from repro.configs.registry import get_config as j_config
    from repro.configs.registry import get_smoke_config as j_smoke
    for mine, theirs in ((get_config(arch), j_config(arch)),
                         (get_smoke_config(arch), j_smoke(arch))):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        b.pop("technique_applicability")
        a.pop("technique_applicability")
        assert a == b
        assert mine.param_count() == theirs.param_count()


def test_unported_archs_raise_naming_their_item():
    from repro.configs.registry import ARCH_IDS as J_IDS
    assert set(ARCH_IDS) == set(J_IDS)
    for arch in set(ARCH_IDS) - set(ARCHS):
        with pytest.raises(NotImplementedError, match=r"A\.14\.\d"):
            get_config(arch)
    # every ported family trains (RWKV's step takes the WKV6 backward)
    for arch in ARCHS:
        assert callable(make_train_step(build(get_smoke_config(arch)), None))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 3])
def test_bridge_round_trips_bitwise_in_pytree_order(arch, seed):
    import jax
    _, jp, _, tp = _jax_bundle(arch, seed)
    leaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
    mine = flatten(tp)
    assert len(mine) == len(leaves)
    for a, b in zip(mine, leaves):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert np.array_equal(a.numpy(), b)
    back = flatten(params_to_numpy(tp))
    assert all(np.array_equal(a, b) for a, b in zip(back, leaves))
    # bf16 on the torch side, carried back as float32
    bf = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in flatten(bf))
    assert all(np.array_equal(
        a, torch.from_numpy(b.copy()).bfloat16().float().numpy())
        for a, b in zip(flatten(params_to_numpy(bf)), leaves))


@pytest.mark.parametrize("arch", ARCHS)
def test_standalone_init_follows_the_reference_laws(arch):
    """Same leaves, shapes and dtype as the reference's init; zeros and
    ones exact; every drawn leaf of 1,000 or more elements has the
    reference's std within 15% (two independent draws)."""
    import jax
    from repro.nn.param import param_count as j_param_count
    jb, jp, tb, _ = _jax_bundle(arch)
    mine = tb.init_params(0, torch.float32, "cpu")
    again = tb.init_params(0, torch.float32, "cpu")
    assert param_count(tb.param_spec) == j_param_count(jb.param_spec)
    for a, a2, b in zip(flatten(mine), flatten(again), jax.tree.leaves(jp)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert torch.equal(a, a2)  # one seed, one set of weights
        if np.all(b == b.flat[0]):  # zeros or ones
            assert np.array_equal(a.numpy(), b)
        elif b.size >= 1000:
            assert abs(float(a.std()) / float(b.std()) - 1) < 0.15
    bf = tb.init_params(0, torch.bfloat16, "cpu")
    assert all(x.dtype == torch.bfloat16 for x in flatten(bf))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(kind):
    import jax.numpy as jnp
    from repro.nn import layers as jL
    x = _normal(0, 2, 5, 48, scale=3.0)
    p = {"scale": _normal(1, 48)}
    if kind == "layernorm":
        p["bias"] = _normal(2, 48)
    want = jL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), 1e-5)
    got = tL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), 1e-5)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_is_the_split_half_form(theta):
    import jax.numpy as jnp
    from repro.nn import layers as jL
    x = _normal(0, 2, 9, 4, 16)
    pos = np.arange(9)[None, :] + 3
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("act", ["silu", "relu_sq", "gelu"])
def test_apply_mlp_matches_reference(act):
    import jax.numpy as jnp
    from repro.nn import layers as jL
    spec = jL.mlp_spec(32, 96, act)
    p = {k: _normal(i, *s.shape, scale=0.2)
         for i, (k, s) in enumerate(sorted(spec.items()))}
    x = _normal(9, 2, 5, 32)
    want = jL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), act)
    got = tL.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act)
    _close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("tie,real_vocab", [(False, 256), (False, 250),
                                            (True, 200)])
def test_logits_fn_masks_the_padded_vocab(tie, real_vocab):
    import jax.numpy as jnp
    from repro.nn import layers as jL
    p = {"table": _normal(0, 256, 32, scale=0.02)}
    if not tie:
        p["unembed"] = _normal(1, 32, 256, scale=0.2)
    x = _normal(2, 2, 3, 32)
    want = jL.logits_fn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), real_vocab)
    got = tL.logits_fn({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), real_vocab)
    assert got.dtype == torch.float32
    _close(got, want, BLOCK_TOL)
    assert (got[..., real_vocab:] <= -1e29).all()


def _attn_params(d=64, H=4, KH=2, hd=16):
    from repro.nn.attention import attention_spec
    spec = attention_spec(d, H, KH, hd)
    return {k: _normal(i, *s.shape, scale=d ** -0.5)
            for i, (k, s) in enumerate(sorted(spec.items()))}


@pytest.mark.parametrize("S", [16, 13])
def test_attend_prefill_output_and_cache(S):
    import jax.numpy as jnp
    from repro.nn import attention as jattn
    p = _attn_params()
    x = _normal(7, 2, S, 64)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=500_000.0)
    want, wc = jattn.attend({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), mode="prefill",
                            positions=jnp.arange(S)[None, :], **kw)
    got, gc = tattn.attend({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), mode="prefill",
                           positions=torch.arange(S)[None, :], **kw)
    _close(got, want, BLOCK_TOL)
    for name in ("k", "v"):  # unrepeated (B, S, KH, D), rope on k
        assert tuple(gc[name].shape) == (2, S, 2, 16)
        _close(gc[name], wc[name], BLOCK_TOL)


@pytest.mark.parametrize("pos", [5, 0, 11, 40])
def test_attend_decode_writes_the_cache_where_the_reference_does(pos):
    """One token at ``pos`` into a cache of 12 slots: written at pos, or
    at the last slot when pos is past it (``dynamic_update_slice``
    clamps), attending positions <= pos."""
    import jax.numpy as jnp
    from repro.nn import attention as jattn
    p = _attn_params()
    x = _normal(8, 2, 1, 64)
    cache = {"k": _normal(9, 2, 12, 2, 16), "v": _normal(10, 2, 12, 2, 16)}
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=500_000.0)
    want, wc = jattn.attend(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        mode="decode", positions=jnp.full((2, 1), pos),
        cache={k: jnp.asarray(v) for k, v in cache.items()}, **kw)
    got, gc = tattn.attend(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        mode="decode", positions=torch.full((2, 1), pos),
        cache={k: torch.from_numpy(v.copy()) for k, v in cache.items()},
        **kw)
    _close(got, want, BLOCK_TOL)
    for name in ("k", "v"):
        _close(gc[name], wc[name], BLOCK_TOL)


@pytest.mark.parametrize("n_rep,pos", [(2, 7), (1, 0), (4, 11)])
def test_decode_attention_matches_reference(n_rep, pos):
    import jax.numpy as jnp
    from repro.nn.attention import decode_attention
    KH = 2
    q = _normal(0, 3, 1, KH * n_rep, 16)
    kc, vc = _normal(1, 3, 12, KH, 16), _normal(2, 3, 12, KH, 16)
    want = decode_attention(*map(jnp.asarray, (q, kc, vc)), jnp.asarray(pos),
                            n_rep)
    got = tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc)), pos,
                                 n_rep)
    _close(got, want, BLOCK_TOL)


# ---------------------------------------------------------------------------
# the whole model: prefill, grow the cache, decode
# ---------------------------------------------------------------------------

def _grow(cache, extra, prompt_len):
    """examples/lm_serve.py's growth: pad the sequence dim (2) of every
    stacked cache leaf of 4+ dims whose sequence is the prompt's."""
    return {k: (torch.nn.functional.pad(v, (0, 0) * (v.dim() - 3)
                                        + (0, extra))
                if v.dim() >= 4 and v.shape[2] == prompt_len else v)
            for k, v in cache.items()}


def _prefill_and_decode_match_reference(arch, B, S):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeSpec as JShape
    from repro.models.registry import sample_inputs as j_sample
    jb, jp, tb, tp = _jax_bundle(arch, seed=1)
    cfg = tb.cfg
    shape = JShape("t", S, B, "prefill")
    jbatch = j_sample(jb.cfg, shape, np.random.default_rng(4))
    tbatch = sample_inputs(cfg, shape, np.random.default_rng(4), "cpu")
    assert np.array_equal(tbatch["tokens"].numpy(),
                          np.asarray(jbatch["tokens"]))
    jl, jc = jb.prefill_fn(jp, jbatch)
    tl, tc = make_prefill_step(tb)(tp, tbatch)
    assert tl.shape == (B, 1, cfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl, MODEL_TOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                         cfg.resolved_head_dim)
        _close(tc[name], jc[name], MODEL_TOL)
    extra = 3
    jc = jax.tree.map(lambda c: jnp.pad(
        c, [(0, 0)] * 2 + [(0, extra)] + [(0, 0)] * (c.ndim - 3)), jc)
    tc = _grow(tc, extra, S)
    decode = make_decode_step(tb)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
        np.int32)
    for i in range(extra):
        jl, jc = jb.decode_fn(jp, jc, {"tokens": jnp.asarray(tok),
                                       "pos": jnp.asarray(S + i, jnp.int32)})
        tl, tc = decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                 "pos": S + i})
        _close(tl, jl, MODEL_TOL)
        for name in ("k", "v"):
            _close(tc[name], jc[name], MODEL_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)


@pytest.mark.parametrize("B,S", [(2, 16), (1, 13)])
def test_llama_prefill_and_decode_match_reference(B, S):
    _prefill_and_decode_match_reference("llama3-8b", B, S)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "grok-1-314b"])
@pytest.mark.parametrize("B,S", [(2, 16), (1, 13)])
def test_moe_prefill_and_decode_match_reference(arch, B, S):
    """The MoE models: the capacity is per batch row, C = capacity(S) for
    the prefill and 8 for each decode step, as in the reference."""
    _prefill_and_decode_match_reference(arch, B, S)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("B,S", [(2, 16), (1, 13)])
def test_dense_prefill_and_decode_match_reference(arch, B, S):
    """The other dense configs: MiniCPM-2B (36 heads over 36, tied
    embeddings), StarCoder2-7B (gelu MLP and layernorm, 6 heads over 2)
    and Yi-9B, at their smoke widths."""
    _prefill_and_decode_match_reference(arch, B, S)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_fn_cache_contract(arch):
    """dense, moe and vlm: decode_fn writes the step into the given cache's
    tensors and returns them (the cache is donated); ssm: it returns a new
    state and leaves the given one as it was."""
    tb = build(get_smoke_config(arch))
    p = tb.init_params(0, torch.float32, "cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, tb.cfg.vocab_size, (2, 6))
        .astype(np.int32))
    _, cache = tb.prefill_fn(p, {"tokens": tokens})
    kv = tb.cfg.family != "ssm"
    if kv:
        cache = _grow(cache, 2, 6)
    before = {k: v.clone() for k, v in cache.items()}
    _, after = tb.decode_fn(p, cache, {"tokens": tokens[:, :1], "pos": 6})
    for name, t in cache.items():
        if kv:
            assert after[name] is t
            assert torch.equal(t[:, :, :6], before[name][:, :, :6])
            assert not torch.equal(t[:, :, 6], before[name][:, :, 6])
        else:
            assert torch.equal(t, before[name])
            assert after[name] is not t


def test_llama_unported_paths_raise_naming_their_items():
    """Since the VLM prefix is ported (A.14.3), the dense model takes one
    too, as the reference's ``lm.forward`` does: its positions come first
    and the loss leaves them unsupervised; one of the wrong width raises.
    The default device is the card."""
    from repro_torch.models import lm
    cfg = get_smoke_config("llama3-8b")
    tb = build(cfg)
    p = tb.init_params(0, torch.float32, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    x, _, _ = lm.forward(p, cfg, toks, embeds_prefix=torch.ones(1, 2, 64))
    assert tuple(x.shape) == (1, 6, 64)
    loss, _ = tb.loss_fn(p, {"tokens": toks, "labels": toks,
                             "patch_embeds": torch.ones(1, 2, 64)})
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="embeds_prefix"):
        lm.forward(p, cfg, toks, embeds_prefix=torch.zeros(1, 2, 32))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.init_params(0)

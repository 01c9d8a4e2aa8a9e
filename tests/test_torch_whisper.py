"""The port's encoder-decoder (``repro_torch.models.whisper``, Whisper-small's
``smoke()`` config: 2 encoder and 2 decoder layers, d 64, 4 heads of 16,
32 frames, and a ragged 30) against ``repro.models.whisper``: the config,
``EncDecSpec`` and ``param_count``, the parameter and cache specs, the
weight bridge in pytree order, the init's laws, the seeded inputs, the
sinusoidal positions, ``attend`` with ``x_kv`` (non-causal, Sq != Sk),
``encode``, prefill logits with all four caches, decode steps after a grown
self cache, ``loss_fn`` and every gradient leaf with and without remat,
one ``make_train_step`` step, and the launcher. Inputs come from numpy
seeds, the reference's parameters are carried across by
``nn.param.params_from_numpy``, fp32 on the CPU; JAX is imported only
inside the tests (the card has none).

Tolerances, as ``tests/test_torch_zamba2.py``'s (each atol times the
largest magnitude of the reference's result, at least 1): MODEL_TOL, rtol
1e-4 / atol 1e-4, for positions, attention, the encoder's output, logits,
caches, loss, gradients and the state after a step (fp32 sums taken in
another order; sin and cos of arguments up to 4,112 by two libraries).
The ``gpu`` test (skipped here) runs the smoke model's prefill, decode
and gradients on the card against the CPU at the same tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointing import flatten_with_paths
from repro_torch.configs.base import EncDecSpec, ShapeSpec
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import whisper
from repro_torch.models.registry import build, input_specs, sample_inputs
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tL
from repro_torch.nn.param import (flatten, params_from_numpy,
                                  params_to_numpy, unflatten)
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedules import get_schedule

ARCH = "whisper-small"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol=MODEL_TOL):
    """assert_allclose with atol times the largest magnitude of ``want``
    (at least 1)."""
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _cfg_kw(enc_len=None, **cfg_kw):
    if enc_len is not None:
        cfg_kw["encdec"] = EncDecSpec(enc_layers=2, enc_len=enc_len)
    return cfg_kw


def _bundles(seed=0, enc_len=None, **cfg_kw):
    """The reference's bundle and fp32 parameters for the smoke config
    (``enc_len`` frames where given), and the port's bundle with them
    bridged."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import EncDecSpec as JEncDec
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import build as j_build
    kw = _cfg_kw(enc_len, **cfg_kw)
    j_kw = dict(kw)
    if "encdec" in kw:
        j_kw["encdec"] = JEncDec(**dataclasses.asdict(kw["encdec"]))
    jb = j_build(j_smoke(ARCH).replace(**j_kw))
    jp = jb.init_params(jax.random.PRNGKey(seed), jnp.float32)
    tb = build(get_smoke_config(ARCH).replace(**kw))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jb, jp, tb, tp


def _batches(cfg, shape, seed):
    """The reference's and the port's inputs from one numpy seed."""
    from repro.configs.base import ShapeSpec as JShape
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import sample_inputs as j_sample
    j_cfg = j_smoke(ARCH).replace(encdec=type(j_smoke(ARCH).encdec)(
        **dataclasses.asdict(cfg.encdec)))
    jshape = JShape(shape.name, shape.seq_len, shape.global_batch,
                    shape.kind)
    return (j_sample(j_cfg, jshape, np.random.default_rng(seed)),
            sample_inputs(cfg, shape, np.random.default_rng(seed), "cpu"))


# ---------------------------------------------------------------------------
# config, specs, bridge, init, inputs
# ---------------------------------------------------------------------------

def test_config_and_specs_are_the_references():
    import jax
    from repro.configs.registry import get_config as j_config
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models import whisper as jw
    from repro.nn.param import PSpec as JPSpec
    for mine, theirs in ((get_config(ARCH), j_config(ARCH)),
                         (get_smoke_config(ARCH), j_smoke(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert isinstance(mine.encdec, EncDecSpec)
        assert mine.param_count() == theirs.param_count()
        for fn_mine, fn_theirs in (
                (whisper.param_spec(mine), jw.param_spec(theirs)),
                (whisper.cache_spec(mine, 3, 40),
                 jw.cache_spec(theirs, 3, 40))):
            leaves = jax.tree.leaves(
                fn_theirs, is_leaf=lambda s: isinstance(s, JPSpec))
            got = flatten(fn_mine)
            assert [(s.shape, s.init, s.scale) for s in got] == [
                (s.shape, s.init, s.scale) for s in leaves]
    cfg = get_config(ARCH)
    assert cfg.param_count() == 277_845_504
    assert (cfg.encdec.enc_layers, cfg.encdec.enc_len) == (12, 1_500)
    assert cfg.resolved_head_dim == 64 and not cfg.tie_embeddings
    spec = whisper.param_spec(cfg)
    assert spec["embed"]["unembed"].shape == (768, 51_968)
    assert spec["decoder"]["xattn"]["wk"].shape == (12, 768, 12, 64)


@pytest.mark.parametrize("seed", [0, 5])
def test_bridge_round_trips_bitwise_in_pytree_order(seed):
    """Leaves in ``jax.tree.leaves`` order (decoder, embed, encoder,
    ln_enc, ln_f), bitwise there and back, and in bf16."""
    import jax
    _, jp, _, tp = _bundles(seed)
    names = list(flatten_with_paths(tp))
    j_paths = ["/".join(str(getattr(k, "key", k)) for k in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == j_paths
    assert names[0].startswith("decoder/") and names[-1] == "ln_f/scale"
    leaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
    for a, b in zip(flatten(tp), leaves):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
    back = flatten(params_to_numpy(tp))
    assert all(np.array_equal(a, b) for a, b in zip(back, leaves))
    bf = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in flatten(bf))


def test_init_draws_by_the_references_laws():
    """A stacked (L, d, H, hd) projection takes d x H as its fan-in, the
    (L, H, hd, d) output H x hd, the (L, d, f) MLP d, the unembedding d,
    the table 0.02; norms are ones and zeros. Each drawn leaf's std within
    10% of the law's, at Whisper's published widths cut to 2 + 2 layers."""
    cfg = get_config(ARCH).replace(n_layers=2, vocab_size=512,
                                   encdec=EncDecSpec(2, 1500))
    p = build(cfg).init_params(0, torch.float32, "cpu")
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    laws = {"encoder/attn/wq": 1 / np.sqrt(d * H),
            "decoder/xattn/wk": 1 / np.sqrt(d * H),
            "decoder/attn/wo": 1 / np.sqrt(H * hd),
            "encoder/mlp/wi": 1 / np.sqrt(d),
            "decoder/mlp/wo": 1 / np.sqrt(cfg.d_ff),
            "embed/unembed": 1 / np.sqrt(d),
            "embed/table": 0.02}
    leaves = flatten_with_paths(p)
    for name, want in laws.items():
        got = float(leaves[name].std())
        assert abs(got / want - 1) < 0.1, (name, got, want)
    for name in ("ln_enc/scale", "decoder/ln_x/scale"):
        assert torch.equal(leaves[name], torch.ones_like(leaves[name]))
    assert torch.equal(leaves["decoder/ln_x/bias"],
                       torch.zeros_like(leaves["decoder/ln_x/bias"]))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_seeded_inputs_are_the_references(kind):
    """The same names in the same order (frames, tokens, labels), shapes
    and kinds as the reference's specs, and the same draws from one numpy
    seed: the frames' bf16 values bit for bit, at a ragged 30 frames."""
    from repro.configs.base import ShapeSpec as JShape
    from repro.models.registry import input_specs as j_specs
    cfg = get_smoke_config(ARCH).replace(encdec=EncDecSpec(2, 30))
    shape = ShapeSpec("t", 24, 2, kind)
    jbatch, tbatch = _batches(cfg, shape, 7)
    from repro.configs.registry import get_smoke_config as j_smoke
    j_cfg = j_smoke(ARCH)
    j_cfg = j_cfg.replace(encdec=type(j_cfg.encdec)(2, 30))
    theirs = j_specs(j_cfg, JShape("t", 24, 2, kind))
    mine = input_specs(cfg, shape)
    assert list(mine) == list(theirs) == list(tbatch) == list(jbatch)
    for name, spec in mine.items():
        assert spec.spec.shape == theirs[name].spec.shape
        assert spec.kind == theirs[name].kind
    if kind != "decode":
        assert tbatch["frames"].shape == (2, 30, cfg.d_model)
        assert tbatch["frames"].dtype == torch.bfloat16
    for name in tbatch:
        want = np.asarray(jbatch[name].astype("float32")
                          if name == "frames" else jbatch[name])
        assert np.array_equal(tbatch[name].float().numpy()
                              if name == "frames" else tbatch[name].numpy(),
                              want)


def test_sinusoidal_positions_match_reference():
    """Whisper's encoder positions at 1,500 x 768 and the decoder's at
    positions up to 4,112 (a 4,096-token prefill and 16 decode steps),
    against the reference's fp32 sinusoids.

    The frequencies come out of two fp32 ``exp``s: XLA's is one ulp off the
    correctly rounded value at 32 of the 384, the port's (PyTorch's) at 4,
    so 28 frequencies differ by one ulp. At position p that moves the angle
    by p ulps of the frequency (~2.5e-4 at 4,112 for a frequency near 1),
    past MODEL_TOL for any fp32 rounding; a kept difference (ROADMAP C).
    So the positions are held against the reference's output on every
    column whose frequency has the reference's bits, and on every column
    against the reference's formula (its fp32 products, sin and cos) fed
    the port's frequencies."""
    import jax.numpy as jnp
    from repro.models.whisper import _sin_pos_at as j_sin_at
    from repro.nn.layers import sinusoidal_positions as j_sin
    freqs = tL.sinusoid_freqs(768)
    j_freqs = np.asarray(jnp.exp(-jnp.arange(384, dtype=jnp.float32)
                                 * (jnp.log(10_000.0) / 383)))
    _close(freqs, j_freqs)
    ulps = np.abs(freqs.numpy().view(np.int32) - j_freqs.view(np.int32))
    assert ulps.max() <= 1 and (ulps > 0).sum() <= 32
    same = np.tile(ulps == 0, 2)          # the sin half, then the cos half

    def j_formula(pos):                   # the reference's, on our freqs
        ang = jnp.asarray(pos, jnp.float32)[..., None] * jnp.asarray(
            freqs.numpy())
        return jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=-1)

    got = tL.sinusoidal_positions(1500, 768)
    assert got.shape == (1500, 768) and got.dtype == torch.float32
    _close(got[:, same], np.asarray(j_sin(1500, 768))[:, same])
    _close(got, j_formula(np.arange(1500)))
    pos = np.array([[0], [448], [1499], [4096], [4112]], dtype=np.int32)
    got = whisper._sin_pos_at(torch.from_numpy(pos), 768)
    assert got.shape == (5, 1, 768)
    _close(got[..., same], np.asarray(j_sin_at(jnp.asarray(pos), 768))[
        ..., same])
    _close(got, j_formula(pos))
    # the decoder's prefill positions are the rows of the same table
    assert torch.equal(whisper._sin_pos_at(torch.arange(40)[None], 64)[0],
                       tL.sinusoidal_positions(40, 64))


def _attend_inputs(seed, B=2, Sq=12, Sk=30, d=64, H=4, hd=16):
    rng = np.random.default_rng(seed)
    p = {"wq": rng.standard_normal((d, H, hd)), "wk": rng.standard_normal(
        (d, H, hd)), "wv": rng.standard_normal((d, H, hd)),
         "wo": rng.standard_normal((H, hd, d))}
    p = {k: (v / np.sqrt(d)).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, Sq, d)).astype(np.float32)
    x_kv = rng.standard_normal((B, Sk, d)).astype(np.float32)
    do = rng.standard_normal((B, Sq, d)).astype(np.float32)
    return p, x, x_kv, do


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_attend_with_x_kv_matches_reference(mode):
    """``attend`` with ``x_kv``: k and v from x_kv, no rope, non-causal at
    Sq 12 != Sk 30 (the decoder's cross-attention). ``"train"`` also holds
    the gradients of x, x_kv and every weight; ``"prefill"`` returns no
    self cache but x_kv's k and v, which the reference projects apart."""
    import jax
    import jax.numpy as jnp
    from repro.nn.attention import attend as j_attend
    p, x, x_kv, do = _attend_inputs(3)
    kw = dict(n_heads=4, n_kv=4, head_dim=16, rope_theta=10_000.0)
    pos = np.arange(12)[None]

    def j_fn(p, x, x_kv):
        return j_attend(p, x, positions=jnp.asarray(pos), mode=mode,
                        x_kv=x_kv, **kw)
    (j_out, j_cache), vjp = jax.vjp(j_fn, p, jnp.asarray(x),
                                    jnp.asarray(x_kv))
    assert j_cache is None
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx, tkv = (torch.from_numpy(a).requires_grad_() for a in (x, x_kv))
    out, cache = tattn.attend(tp, tx, positions=torch.from_numpy(pos),
                              mode=mode, x_kv=tkv, **kw)
    _close(out, j_out)
    if mode == "prefill":
        assert set(cache) == {"k", "v"}
        for name in ("k", "v"):
            _close(cache[name], jnp.einsum("bsd,dhk->bshk", x_kv,
                                           p[f"w{name}"]))
        return
    assert cache is None
    j_gp, j_gx, j_gkv = vjp((jnp.asarray(do), None))
    grads = torch.autograd.grad(out, [tx, tkv] + [tp[k] for k in sorted(p)],
                                torch.from_numpy(do))
    _close(grads[0], j_gx)
    _close(grads[1], j_gkv)
    for g, k in zip(grads[2:], sorted(p)):
        _close(g, j_gp[k])


def test_attend_self_attention_keeps_its_causal_path(monkeypatch):
    """Without ``x_kv`` the core stays causal (rope applied); with ``x_kv``
    = x it is non-causal, the encoder's; decode refuses ``x_kv``."""
    seen = []
    fwd = tattn.flash_attention_fwd
    monkeypatch.setattr(tattn, "flash_attention_fwd",
                        lambda q, k, v, causal: seen.append(causal)
                        or fwd(q, k, v, causal))
    p, x, _, _ = _attend_inputs(4, Sq=10)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    x = torch.from_numpy(x)
    kw = dict(n_heads=4, n_kv=4, head_dim=16, rope_theta=None,
              positions=torch.arange(10)[None], mode="prefill")
    tattn.attend(p, x, **kw)
    tattn.attend(p, x, x_kv=x, **kw)
    assert seen == [True, False]
    with pytest.raises(ValueError, match="decode"):
        tattn.attend(p, x[:, :1], **{**kw, "mode": "decode"}, x_kv=x,
                     cache={"k": torch.zeros(2, 4, 4, 16),
                            "v": torch.zeros(2, 4, 4, 16)})


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("enc_len", [32, 30])
def test_encode_matches_reference(enc_len):
    import jax.numpy as jnp
    from repro.models.whisper import encode as j_encode
    jb, jp, tb, tp = _bundles(seed=1, enc_len=enc_len)
    jbatch, tbatch = _batches(tb.cfg, ShapeSpec("t", 8, 2, "prefill"), 2)
    want = j_encode(jp, jb.cfg, jbatch["frames"])
    for mode in ("train", "prefill"):
        with torch.no_grad():
            got = whisper.encode(tp, tb.cfg, tbatch["frames"], mode)
        assert got.shape == (2, enc_len, 64) and got.dtype == torch.float32
        _close(got, want)
    assert want.dtype == jnp.float32


def _grow(cache, extra):
    """self k and v grown by ``extra`` slots along their sequence (dim 2);
    the cross cache stays at the encoder's length."""
    return {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra))
                if k.startswith("self") else v) for k, v in cache.items()}


@pytest.mark.parametrize("B,S,enc_len", [(2, 16, 32), (1, 13, 30)])
def test_prefill_and_decode_match_reference(B, S, enc_len):
    """Prefill logits and all four cache leaves, then three greedy decode
    steps from the grown self cache: logits and caches each step, the
    cross cache unchanged."""
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles(seed=1, enc_len=enc_len)
    cfg = tb.cfg
    jbatch, tbatch = _batches(cfg, ShapeSpec("t", S, B, "prefill"), 4)
    jl, jc = jb.prefill_fn(jp, jbatch)
    tl, tc = make_prefill_step(tb)(tp, tbatch)
    assert tl.shape == (B, 1, 256) and tl.dtype == torch.float32
    _close(tl, jl)
    assert set(tc) == set(jc) == {"self_k", "self_v", "cross_k", "cross_v"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    assert tc["cross_k"].shape == (2, B, enc_len, 4, 16)
    extra = 3
    jc = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
              if k.startswith("self") else v) for k, v in jc.items()}
    tc = _grow(tc, extra)
    cross = {k: tc[k].clone() for k in ("cross_k", "cross_v")}
    decode = make_decode_step(tb)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
        np.int32)
    for i in range(extra):
        jl, jc = jb.decode_fn(jp, jc, {"tokens": jnp.asarray(tok),
                                       "pos": jnp.asarray(S + i, jnp.int32)})
        tl, tc = decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                 "pos": S + i})
        _close(tl, jl)
        for name in tc:
            _close(tc[name], jc[name])
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)
    for name, t in cross.items():
        assert torch.equal(tc[name], t)


def test_decode_writes_self_kv_in_place_and_never_the_cross_cache():
    tb = build(get_smoke_config(ARCH))
    p = tb.init_params(0, torch.float32, "cpu")
    batch = sample_inputs(tb.cfg, ShapeSpec("t", 6, 2, "prefill"),
                          np.random.default_rng(5), "cpu")
    _, cache = tb.prefill_fn(p, batch)
    cache = _grow(cache, 2)
    before = {k: v.clone() for k, v in cache.items()}
    _, after = tb.decode_fn(p, cache, {"tokens": batch["tokens"][:, :1],
                                       "pos": 6})
    assert after is cache
    for name in ("self_k", "self_v"):
        t = cache[name]
        assert torch.equal(t[:, :, :6], before[name][:, :, :6])
        assert not torch.equal(t[:, :, 6], before[name][:, :, 6])
        assert torch.equal(t[:, :, 7], before[name][:, :, 7])
    for name in ("cross_k", "cross_v"):
        assert torch.equal(cache[name], before[name])


def test_cache_spec_is_the_cache_a_prefill_returns():
    tb = build(get_smoke_config(ARCH))
    p = tb.init_params(0, torch.float32, "cpu")
    batch = sample_inputs(tb.cfg, ShapeSpec("t", 10, 3, "prefill"),
                          np.random.default_rng(0), "cpu")
    _, cache = tb.prefill_fn(p, batch)
    spec = tb.cache_spec(3, 10)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: s.shape for k, s in spec.items()}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat,enc_len", [("full", 32), ("none", 30)])
def test_loss_fn_and_every_gradient_leaf_match_reference(remat, enc_len):
    import jax
    jb, jp, tb, tp = _bundles(enc_len=enc_len, remat=remat)
    jbatch, tbatch = _batches(tb.cfg, ShapeSpec("t", 16, 2, "train"), 5)
    (j_loss, j_met), j_grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
        jp, jbatch)
    leaves = [t.clone().requires_grad_() for t in flatten(tp)]
    loss, met = tb.loss_fn(unflatten(tp, leaves), tbatch)
    grads = torch.autograd.grad(loss, leaves)
    assert set(met) == set(j_met) == {"loss", "ce"}
    for key in met:
        _close(met[key], j_met[key])
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for got, want in zip(grads, j_leaves):
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_remat_recomputes_only_the_decoder(monkeypatch):
    """Under remat "full" each decoder layer runs twice (its forward and
    the backward's recompute) and each encoder layer once; the flash
    forward runs once an encoder layer and four times a decoder layer (two
    attentions, each recomputed), the backward once an attention: at
    Whisper-small's 12 + 12 layers, 60 forwards and 36 backwards a
    micro-batch. The gradients are bitwise remat "none"'s."""
    calls = {"enc": 0, "dec": 0, "fwd": 0, "bwd": 0}
    wrapped = {"enc": (whisper, "_enc_layer"), "dec": (whisper, "_dec_layer"),
               "fwd": (kfa, "flash_attention_fwd"),
               "bwd": (kfa, "flash_attention_bwd")}
    for name, (mod, attr) in wrapped.items():
        def counting(*a, _fn=getattr(mod, attr), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, attr, counting)
    runs = []
    for remat in ("full", "none"):
        tb = build(get_smoke_config(ARCH).replace(remat=remat))
        batch = sample_inputs(tb.cfg, ShapeSpec("t", 12, 2, "train"),
                              np.random.default_rng(1), "cpu")
        tp = tb.init_params(3, torch.float32, "cpu")
        leaves = [t.clone().requires_grad_() for t in flatten(tp)]
        for k in calls:
            calls[k] = 0
        loss, _ = tb.loss_fn(unflatten(tp, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        runs.append((loss, grads, dict(calls)))
    (l_full, g_full, c_full), (l_none, g_none, c_none) = runs
    assert torch.equal(l_full, l_none)
    assert all(torch.equal(a, b) for a, b in zip(g_full, g_none))
    assert c_full == {"enc": 2, "dec": 4, "fwd": 2 + 2 * 4, "bwd": 2 + 2 * 2}
    assert c_none == {"enc": 2, "dec": 2, "fwd": 2 + 2 * 2, "bwd": 2 + 2 * 2}


def test_train_step_matches_reference():
    """One ``make_train_step`` step (grad_accum 2 over a batch of 4, each
    sequence over its own frames) against the reference's jitted step,
    from the same parameters, with AdamW on a cosine schedule: the
    parameters, m, v and the metrics."""
    import jax
    from repro.launch.steps import make_train_step as j_make
    from repro.optim.adam import AdamW as JAdamW
    from repro.optim.schedules import get_schedule as j_schedule
    jb, jp, tb, tp = _bundles(seed=2, grad_accum=2)
    jbatch, tbatch = _batches(tb.cfg, ShapeSpec("t", 16, 4, "train"), 9)
    j_opt = JAdamW(j_schedule("cosine", 1e-3, 2, 10))
    j_state = j_opt.init(jp)
    jp, j_state, j_met = jax.jit(j_make(jb, j_opt))(jp, j_state, jbatch)
    opt = AdamW(get_schedule("cosine", 1e-3, 2, 10))
    tp, state, met = make_train_step(tb, opt)(tp, opt.init(flatten(tp)),
                                              tbatch)
    assert set(met) == set(j_met) == {"loss", "lr", "grad_norm"}
    for key in met:
        _close(met[key], j_met[key])
    assert state["step"] == int(j_state["step"]) == 1
    for got, want in zip(flatten(tp), jax.tree.leaves(jp)):
        _close(got, want)
    for name in ("m", "v"):
        for got, want in zip(state[name], jax.tree.leaves(j_state[name])):
            _close(got, want)


def test_launcher_trains_whisper_and_resumes_bitwise(tmp_path):
    """``--arch whisper-small`` on the CPU: the loss falls over 20 steps
    of 4 x 64 tokens (labels drawn uniformly: it falls towards log 256);
    a run saving every 2 steps loses its step-4 checkpoint, and the run
    resumed from step 2 ends with the uninterrupted run's parameters,
    moments and step, bit for bit."""
    import os
    from repro_torch.launch import train
    args = ["--arch", ARCH, "--device", "cpu"]
    res = train.main(args + ["--batch", "4", "--seq", "64", "--lr", "3e-3",
                             "--steps", "20"])
    losses = res["losses"]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.05
    ck = str(tmp_path / "ck")
    args += ["--batch", "2", "--seq", "16", "--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2"]
    full = train.main(args)
    for ext in (".npz", ".json"):
        os.remove(os.path.join(ck, f"ckpt_00000004{ext}"))
    resumed = train.main(args + ["--resume"])
    assert resumed["start"] == 2 and resumed["losses"] == full["losses"][2:]
    for a, b in zip(flatten(full["params"]), flatten(resumed["params"])):
        assert torch.equal(a, b)
    for name in ("m", "v"):
        for a, b in zip(full["opt_state"][name], resumed["opt_state"][name]):
            assert torch.equal(a, b)
    assert full["opt_state"]["step"] == resumed["opt_state"]["step"] == 4


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_whisper_on_card_matches_the_cpu():
    """The smoke model in fp32 (TF32 off) at a ragged 30 frames on the
    card against the CPU: prefill logits and caches (3 flash forwards a
    layer pair), a decode step (no launch), the loss and every gradient
    leaf (the flash backward at Sq != Sk), within MODEL_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config(ARCH).replace(encdec=EncDecSpec(2, 30))
    tb = build(cfg)
    p0 = params_to_numpy(tb.init_params(0, torch.float32, "cpu"))
    batch = sample_inputs(cfg, ShapeSpec("t", 40, 2, "train"),
                          np.random.default_rng(0), "cpu")
    pre = {k: v for k, v in batch.items() if k != "labels"}
    out = {}
    for dev in ("cpu", "cuda"):
        tp = params_from_numpy(p0, dev)
        kbuild.reset_launch_counts()
        logits, cache = make_prefill_step(tb)(
            tp, {k: v.to(dev) for k, v in pre.items()})
        launches = dict(kbuild.launch_counts)
        cache = _grow(cache, 1)
        step, _ = make_decode_step(tb)(tp, cache, {
            "tokens": batch["tokens"][:, :1].to(dev), "pos": 40})
        leaves = [t.clone().requires_grad_() for t in flatten(tp)]
        loss, _ = tb.loss_fn(unflatten(tp, leaves),
                             {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves)
        out[dev] = (logits, cache, step, loss, grads, launches)
    (l_cpu, c_cpu, s_cpu, loss_cpu, g_cpu, _) = out["cpu"]
    (l_card, c_card, s_card, loss_card, g_card, n_card) = out["cuda"]
    assert n_card["flash_attention_fwd"] == 2 + 2 * 2
    _close(l_card, l_cpu.numpy())
    for name in c_cpu:
        _close(c_card[name], c_cpu[name].numpy())
    _close(s_card, s_cpu.numpy())
    _close(loss_card, loss_cpu.detach().numpy())
    for a, b in zip(g_card, g_cpu):
        _close(a, b.numpy())

"""The port's VLM backbone (LLaVA-NeXT-34B's ``smoke()`` config: 2 layers,
d 64, 4 heads over 2, a prefix of 16 patch embeddings) against ``repro``:
the input specs and seeded inputs, ``lm.forward`` with the patch-embedding
prefix, ``loss_fn`` and every gradient leaf (fp32, remat on and off, and
bf16), two ``make_train_step`` steps with gradient accumulation, and the
prefill of a prefixed prompt followed by three decode steps; and the
request upload through the pinned staging ring (``core.staging.
upload_tensors``). The same numpy-seeded inputs go to both packages (the
prefix rounded to bf16 once, as the reference's input spec has it), the
reference's parameters carried across by ``nn.param.params_from_numpy``.
JAX is imported only inside the tests (the card has none).

Tolerances, each atol times the largest magnitude of the reference's
result (at least 1), as ``tests/test_torch_lm_train.py``'s:
* MODEL_TOL, rtol 1e-4 / atol 1e-4: hidden states, loss, every gradient
  leaf, logits, caches and the state after two steps, in fp32;
* BF16_TOL, rtol 2e-2 / atol 2e-2: every gradient leaf of the bf16 model;
  BF16_LOSS_TOL, rtol 1e-3 / atol 1e-3: its loss.
The ``gpu`` tests (skipped here) hold the flash forward at LLaVA's GQA
group of 7 against its plain version on the card (fp32 at FLASH_TOL; bf16
at rtol 1e-2 plus 4e-3 times P|v| element-wise, ``chip_smoke.py``'s law:
the kernel rounds each p to bf16 before PV), and the prefixed prefill and
decode on the card against the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.staging import StagingRing, upload_tensors
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import lm
from repro_torch.models.registry import build, input_specs, sample_inputs
from repro_torch.nn.param import (flatten, params_from_numpy,
                                  params_to_numpy, unflatten)
from repro_torch.optim.adam import AdamW
from repro_torch.optim.schedules import get_schedule

ARCH = "llava-next-34b"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
FLASH_TOL = dict(rtol=1e-4, atol=2e-4)


def _close(got, want, tol):
    want = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _bundles(seed=0, **cfg_kw):
    """The reference's and the port's bundles of the smoke config (with
    ``cfg_kw`` replaced) and the reference's fp32 parameters, bridged."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import build as j_build
    jb = j_build(j_smoke(ARCH).replace(**cfg_kw))
    jp = jb.init_params(jax.random.PRNGKey(seed), jnp.float32)
    tb = build(get_smoke_config(ARCH).replace(**cfg_kw))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jb, jp, tb, tp


def _batch(B, S_text, seed=5, labels=True):
    """numpy inputs: a bf16-exact (B, P, d) prefix as float32, S_text
    tokens (and labels)."""
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    prefix = torch.from_numpy(rng.standard_normal(
        (B, cfg.vlm.num_patches, cfg.d_model)).astype(np.float32))
    out = {"patch_embeds": prefix.bfloat16().float().numpy(),
           "tokens": rng.integers(0, cfg.vocab_size,
                                  (B, S_text)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size,
                                     (B, S_text)).astype(np.int32)
    return out


def _j(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "patch_embeds"
            else jnp.asarray(v) for k, v in batch.items()}


def _t(batch, device="cpu"):
    return {k: (torch.from_numpy(v).bfloat16() if k == "patch_embeds"
                else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the config and its inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_and_seeded_inputs_are_the_references(kind):
    """The same names, shapes, kinds and dtypes as the reference's specs
    (a prefix of P rows and S - P text tokens), and the same draws from
    one numpy seed, the prefix's bf16 values bit for bit."""
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.models.registry import input_specs as j_specs
    from repro.models.registry import sample_inputs as j_sample
    cfg = get_smoke_config(ARCH)
    shape = ShapeSpec("t", 48, 2, kind)
    mine, theirs = input_specs(cfg, shape), j_specs(j_smoke(ARCH), shape)
    assert list(mine) == list(theirs)
    for name, spec in mine.items():
        assert spec.spec.shape == theirs[name].spec.shape
        assert spec.kind == theirs[name].kind
        assert str(spec.dtype).replace("torch.", "") == jnp.dtype(
            theirs[name].dtype).name
    if kind != "decode":
        assert mine["patch_embeds"].spec.shape == (2, 16, 64)
        assert mine["tokens"].spec.shape == (2, 32)
    got = sample_inputs(cfg, shape, np.random.default_rng(3), "cpu")
    want = j_sample(j_smoke(ARCH), shape, np.random.default_rng(3))
    for name, t in got.items():
        w = np.asarray(want[name].astype(jnp.float32)
                       if name == "patch_embeds" else want[name])
        assert t.dtype == (torch.bfloat16 if name == "patch_embeds"
                           else torch.int32)
        assert np.array_equal(t.float().numpy() if name == "patch_embeds"
                              else t.numpy(), w)


def test_llava_builds_at_its_published_widths():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size,
            cfg.vlm.num_patches) == ("vlm", 60, 7168, 56, 8, 20480, 64000,
                                     2880)
    assert cfg.n_heads // cfg.n_kv_heads == 7
    bundle = build(cfg)
    assert callable(bundle.loss_fn) and callable(bundle.prefill_fn)
    assert bundle.cache_spec(1, 4096)["k"].shape == (60, 1, 4096, 8, 128)


def test_prefix_of_the_wrong_shape_raises():
    tb = build(get_smoke_config(ARCH))
    p = tb.init_params(0, torch.float32, "cpu")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    for bad in (torch.zeros(2, 3, 32), torch.zeros(1, 3, 64),
                torch.zeros(3, 64)):
        with pytest.raises(ValueError, match="embeds_prefix"):
            lm.forward(p, tb.cfg, toks, embeds_prefix=bad)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_with_prefix_matches_reference(mode):
    """The hidden states of every position, prefix and text, in fp32."""
    from repro.models import lm as jlm
    jb, jp, tb, tp = _bundles()
    batch = _batch(2, 24, labels=False)
    jx, _, _ = jlm.forward(jp, jb.cfg, _j(batch)["tokens"],
                           embeds_prefix=_j(batch)["patch_embeds"],
                           mode=mode)
    tx, _, aux = lm.forward(tp, tb.cfg, _t(batch)["tokens"],
                            embeds_prefix=_t(batch)["patch_embeds"],
                            mode=mode)
    assert tuple(tx.shape) == (2, 16 + 24, 64)
    assert float(aux) == 0.0
    _close(tx, np.asarray(jx), MODEL_TOL)


def _port_grads(tb, tp, batch):
    leaves = [t.clone().requires_grad_() for t in flatten(tp)]
    loss, met = tb.loss_fn(unflatten(tp, leaves), batch)
    return loss, met, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_fn_and_every_gradient_leaf_match_reference(remat):
    """The prefix's positions are unsupervised on both sides: the loss is
    the text tokens' cross-entropy."""
    import jax
    jb, jp, tb, tp = _bundles(remat=remat)
    batch = _batch(2, 24)
    (j_loss, j_met), j_grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
        jp, _j(batch))
    loss, met, grads = _port_grads(tb, tp, _t(batch))
    assert set(met) == set(j_met) == {"loss", "ce", "aux"}
    for key in met:
        _close(met[key], np.asarray(j_met[key]), MODEL_TOL)
    _close(loss, np.asarray(j_loss), MODEL_TOL)
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(grads)
    for got, want in zip(grads, j_leaves):
        assert tuple(got.shape) == want.shape
        _close(got, np.asarray(want), MODEL_TOL)


def test_bf16_loss_and_every_gradient_leaf_match_reference():
    import jax
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles()
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = unflatten(tp, [t.bfloat16() for t in flatten(tp)])
    batch = _batch(2, 24)
    (j_loss, _), j_grads = jax.value_and_grad(jb.loss_fn, has_aux=True)(
        jp, _j(batch))
    loss, _, grads = _port_grads(tb, tp, _t(batch))
    assert loss.dtype == torch.float32
    _close(loss, np.asarray(j_loss), BF16_LOSS_TOL)
    for got, want in zip(grads, jax.tree.leaves(j_grads)):
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want.astype(jnp.float32)), BF16_TOL)


def test_train_steps_with_accumulation_match_reference():
    """Two steps at grad_accum 2 on a batch of 4: the prefix is split into
    micro-batches with the tokens, as the reference splits it."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_train_step as j_make
    from repro.optim.adam import AdamW as JAdamW
    from repro.optim.schedules import get_schedule as j_schedule
    jb, jp, tb, tp = _bundles(seed=1, grad_accum=2)
    j_opt = JAdamW(j_schedule("cosine", 1e-3, 2, 10))
    j_state, j_step = j_opt.init(jp), jax.jit(j_make(jb, j_opt))
    opt = AdamW(get_schedule("cosine", 1e-3, 2, 10))
    state, step = opt.init(flatten(tp)), make_train_step(tb, opt)
    for i in range(2):
        batch = _batch(4, 16, seed=10 + i)
        jp, j_state, j_met = j_step(jp, j_state, _j(batch))
        tp, state, met = step(tp, state, _t(batch))
        assert set(met) == set(j_met) == {"loss", "lr", "grad_norm"}
        for key in met:
            _close(met[key], np.asarray(j_met[key]), MODEL_TOL)
    for got, want in zip(flatten(tp), jax.tree.leaves(jp)):
        _close(got, np.asarray(want), MODEL_TOL)
    for name in ("m", "v"):
        for got, want in zip(state[name], jax.tree.leaves(j_state[name])):
            _close(got, np.asarray(want.astype(jnp.float32)), MODEL_TOL)


# ---------------------------------------------------------------------------
# serving: a prefixed prefill, then decode
# ---------------------------------------------------------------------------

def _grow(cache, extra):
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra))
            for k, v in cache.items()}


@pytest.mark.parametrize("B,S_text", [(2, 16), (1, 13)])
def test_prefixed_prefill_and_three_decode_steps_match_reference(B, S_text):
    """The prefill's last logits and its cache of P + S positions, then
    three greedy decode steps at positions P + S, P + S + 1, P + S + 2."""
    import jax
    import jax.numpy as jnp
    jb, jp, tb, tp = _bundles(seed=2)
    P = tb.cfg.vlm.num_patches
    batch = _batch(B, S_text, seed=7, labels=False)
    jl, jc = jb.prefill_fn(jp, _j(batch))
    tl, tc = make_prefill_step(tb)(tp, _t(batch))
    assert tl.shape == (B, 1, 256) and tl.dtype == torch.float32
    _close(tl, jl, MODEL_TOL)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == (2, B, P + S_text, 2, 16)
        _close(tc[name], jc[name], MODEL_TOL)
    extra = 3
    jc = jax.tree.map(lambda c: jnp.pad(
        c, [(0, 0)] * 2 + [(0, extra)] + [(0, 0)] * 2), jc)
    tc = _grow(tc, extra)
    decode = make_decode_step(tb)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
        np.int32)
    for i in range(extra):
        pos = P + S_text + i
        jl, jc = jb.decode_fn(jp, jc, {"tokens": jnp.asarray(tok),
                                       "pos": jnp.asarray(pos, jnp.int32)})
        tl, tc = decode(tp, tc, {"tokens": torch.from_numpy(tok),
                                 "pos": pos})
        _close(tl, jl, MODEL_TOL)
        for name in ("k", "v"):
            _close(tc[name], jc[name], MODEL_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(
            np.int32)


def test_request_upload_keeps_every_tensors_bits_dtype_and_shape():
    """A request's token ids and bf16 prefix through one slot of the
    staging ring (on the CPU the copy is a clone): the same bits, dtype
    and shape, all views of one buffer, none aliasing the slot."""
    cfg = get_smoke_config(ARCH)
    host = sample_inputs(cfg, ShapeSpec("t", 40, 3, "prefill"),
                         np.random.default_rng(9), "cpu")
    host["pos"] = torch.tensor(7, dtype=torch.int32)
    ring = StagingRing(2, torch.device("cpu"))
    got = upload_tensors(ring, host)
    assert list(got) == list(host)
    for k, t in host.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape
        assert torch.equal(got[k], t)
    base = got["patch_embeds"].untyped_storage().data_ptr()
    assert got["tokens"].untyped_storage().data_ptr() == base
    again = upload_tensors(ring, {"tokens": host["tokens"] + 1})
    upload_tensors(ring, {"tokens": host["tokens"] + 2})  # refills slot 0
    assert torch.equal(got["tokens"], host["tokens"])
    assert torch.equal(again["tokens"], host["tokens"] + 1)


# ---------------------------------------------------------------------------
# on the card (skipped here)
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH", [(1, 300, 56, 8), (2, 130, 14, 2)])
def test_flash_fwd_at_gqa_group_7_matches_plain_on_card(B, S, H, KH, dtype):
    """LLaVA's 56 query heads over 8 kv heads (and 14 over 2): each query
    head reads kv head h // 7, on the wgmma route (bf16) and the FMA route
    (fp32); the same bits from two launches."""
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, S, h, 128), device="cuda", generator=gen
                           ).to(dt) for h in (H, KH, KH))
    before = kbuild.launch_counts["flash_attention_fwd"]
    out = flash_attention_fwd(q, k, v, True)
    again = flash_attention_fwd(q, k, v, True)
    torch.cuda.synchronize()
    assert kbuild.launch_counts["flash_attention_fwd"] == before + 2
    assert torch.equal(out, again)
    want = flash_attention_plain(q, k, v, True)
    if dt == torch.float32:
        torch.testing.assert_close(out, want, **FLASH_TOL)
    else:
        p_abs_v = flash_attention_plain(q.float(), k.float(),
                                        v.float().abs(), True)
        err = (out.float() - want.float()).abs()
        assert bool((err <= 1e-2 * want.float().abs()
                     + 4e-3 * p_abs_v).all())


@pytest.mark.gpu
def test_prefixed_prefill_and_decode_on_card_match_the_cpu():
    """The smoke config in fp32, a prefix uploaded through the staging
    ring: one flash launch a layer in the prefill, none in a decode step,
    the logits and caches within MODEL_TOL of the CPU's."""
    _card()
    cfg = get_smoke_config(ARCH)
    tb = build(cfg)
    p0 = params_to_numpy(tb.init_params(0, torch.float32, "cpu"))
    host = sample_inputs(cfg, ShapeSpec("t", 64, 2, "prefill"),
                         np.random.default_rng(0), "cpu")
    ring = StagingRing(2, torch.device("cuda"))
    out = {}
    for dev in ("cpu", "cuda"):
        tp = params_from_numpy(p0, dev)
        batch = upload_tensors(ring, host) if dev == "cuda" else host
        kbuild.reset_launch_counts()
        logits, cache = make_prefill_step(tb)(tp, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert kbuild.launch_counts["flash_attention_fwd"] == 2
        cache = _grow(cache, 1)
        tok = logits[:, -1].argmax(-1, keepdim=True).int()
        kbuild.reset_launch_counts()
        step, cache = make_decode_step(tb)(tp, cache,
                                           {"tokens": tok, "pos": 64})
        if dev == "cuda":
            torch.cuda.synchronize()
            assert kbuild.launch_counts["flash_attention_fwd"] == 0
        out[dev] = (logits.cpu(), step.cpu(), cache["k"].cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        _close(got, want.numpy(), MODEL_TOL)

"""The LM zoo's kernels: the port's ``flash_attention_fwd`` and
``wkv6_chunk`` (their plain versions, which the CPU runs) against the
reference's Pallas kernels in interpret mode, its oracles
(``repro.kernels.ref``) and the model's ``wkv6_chunked``, on the same
numpy-seeded fp32 inputs; and the port's oracles (``kernels/ref.py``)
against the reference's.

Tolerances (those of the reference's own kernel tests,
``tests/test_kernels.py``): flash attention atol 2e-4 / rtol 1e-4 (fp32
scores over up to 256 keys, with the softmax taken in one pass against the
kernel's online one); wkv6 atol 1e-4 / rtol 1e-4 (fp32 recurrences over up
to 80 tokens, in chunks against one token at a time), for y and the final
state. The oracles agree to 1e-5.

The tests marked ``gpu`` hold each CUDA kernel against its plain version
on the card (skipped here): fp32 at the fp32 tolerances above (flash's
fp32 FMA route); bf16 flash (its wgmma route, on TMA-fed tiles of 128 rows)
at atol 2e-2 / rtol 2e-2 (p is rounded to bf16 before the PV product, as
the TPU kernel rounds it, and the output to bf16, against the plain fp32
softmax); bf16 wkv6 at atol 2e-2 / rtol 2e-2 (y rounded to bf16; the
state is fp32 and held at 1e-4). JAX is imported only inside the tests
that use it: the card has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (check_tma_operands,
                                                 flash_attention_fwd,
                                                 flash_attention_plain)
from repro_torch.kernels.wkv6 import (check_aligned, heads_per_block,
                                      wkv6_chunk, wkv6_chunk_plain)

FLASH_TOL = dict(atol=2e-4, rtol=1e-4)
WKV_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _qkv(seed, bh, sq, sk, d):
    return (_normal(seed, bh, sq, d), _normal(seed + 1, bh, sk, d),
            _normal(seed + 2, bh, sk, d))


def _wkv_inputs(seed, bh, s, k):
    return (_normal(seed, bh, s, k, scale=0.5),
            _normal(seed + 1, bh, s, k, scale=0.5),
            _normal(seed + 2, bh, s, k, scale=0.5),
            -np.exp(_normal(seed + 3, bh, s, k)),
            _normal(seed + 4, bh, 1, k, scale=0.5))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,sq,sk", [(True, 128, 128),
                                          (False, 128, 256)])
def test_flash_plain_matches_pallas_and_oracle(causal, sq, sk, d):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_fwd as pallas
    q, k, v = _qkv(d + sq + sk, 2, sq, sk, d)
    want = np.asarray(pallas(*map(jnp.asarray, (q, k, v)), causal=causal,
                             interpret=True))
    oracle = np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                           causal))
    before = dict(build.launch_counts)
    got = flash_attention_fwd(*(t[:, :, None] for t in _t(q, k, v)),
                              causal=causal)[:, :, 0]
    assert build.launch_counts == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (2, sq, d)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **FLASH_TOL)


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 1), (3, 3)])
def test_flash_plain_reads_kv_head_h_over_g(heads, kv_heads):
    """(B, S, H, D) with KH kv heads against the reference's oracle over
    the flattened heads with k and v repeated by ``jnp.repeat(.., G,
    axis=2)``, causal, with a ragged S."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    B, S, D = 2, 37, 16
    q = _normal(1, B, S, heads, D)
    k, v = _normal(2, B, S, kv_heads, D), _normal(3, B, S, kv_heads, D)
    G = heads // kv_heads

    def flat(x):  # (B, S, H, D) -> (B*H, S, D)
        return jnp.asarray(np.repeat(x, heads // x.shape[2], axis=2)
                           .transpose(0, 2, 1, 3).reshape(-1, S, D))
    want = np.asarray(jref.attention_ref(flat(q), flat(k), flat(v), True))
    got = flash_attention_plain(*_t(q, k, v), causal=True)
    assert G * kv_heads == heads
    np.testing.assert_allclose(
        got.numpy().transpose(0, 2, 1, 3).reshape(-1, S, D), want,
        **FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_oracle_matches_reference(causal):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    q, k, v = _qkv(11, 3, 40, 40, 32)
    want = np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                         causal))
    got = tref.attention_ref(*_t(q, k, v), causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,s,chunk", [(16, 32, 16), (32, 80, 16),
                                       (64, 64, 8), (16, 80, 8)])
def test_wkv6_plain_matches_pallas_and_oracle(k, s, chunk):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.wkv6 import wkv6_chunk as pallas
    r, kk, v, lw, u = _wkv_inputs(k + s, 3, s, k)
    want = np.asarray(pallas(*map(jnp.asarray, (r, kk, v, lw, u)),
                             chunk=chunk, interpret=True))
    oracle = np.asarray(jref.wkv6_ref(*map(jnp.asarray,
                                           (r, kk, v, lw, u))))
    before = dict(build.launch_counts)
    y, _ = wkv6_chunk(*(t[:, :, None] for t in _t(r, kk, v, lw)),
                      torch.from_numpy(u))
    assert build.launch_counts == before
    plain, _ = wkv6_chunk_plain(*(t[:, :, None] for t in _t(r, kk, v, lw)),
                                torch.from_numpy(u), chunk=chunk)
    for got in (y[:, :, 0], plain[:, :, 0]):
        np.testing.assert_allclose(got.numpy(), want, **WKV_TOL)
        np.testing.assert_allclose(got.numpy(), oracle, **WKV_TOL)


@pytest.mark.parametrize("s", [37, 1, 17])
def test_wkv6_plain_ragged_s_matches_oracle(s):
    """A ragged last chunk is taken as it is; the TPU wrapper shrinks the
    chunk to a divisor of S instead (down to 1 at a prime S)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.wkv6 import wkv6_chunk as pallas
    r, kk, v, lw, u = _wkv_inputs(s, 2, s, 16)
    oracle = np.asarray(jref.wkv6_ref(*map(jnp.asarray,
                                           (r, kk, v, lw, u))))
    want = np.asarray(pallas(*map(jnp.asarray, (r, kk, v, lw, u)),
                             chunk=16, interpret=True))
    y, _ = wkv6_chunk(*(t[:, :, None] for t in _t(r, kk, v, lw)),
                      torch.from_numpy(u))
    np.testing.assert_allclose(y[:, :, 0].numpy(), oracle, **WKV_TOL)
    np.testing.assert_allclose(y[:, :, 0].numpy(), want, **WKV_TOL)


@pytest.mark.parametrize("s,with_state", [(64, False), (48, True),
                                          (37, True)])
def test_wkv6_plain_state_matches_model_chunked(s, with_state):
    """y and the final state against the model's ``wkv6_chunked`` in the
    model's (B, S, H, K) layout, from a zero or a given state."""
    import jax.numpy as jnp
    from repro.nn.rwkv6 import wkv6_chunked
    B, H, K = 2, 3, 16
    r, k, v = (_normal(i, B, s, H, K, scale=0.5) for i in range(3))
    lw = -np.exp(_normal(3, B, s, H, K))
    u = _normal(4, H, K, scale=0.5)
    s0 = (_normal(5, B, H, K, K) if with_state
          else np.zeros((B, H, K, K), np.float32))
    y_j, st_j = wkv6_chunked(*map(jnp.asarray, (r, k, v, lw, u, s0)),
                             chunk=16)
    y, st = wkv6_chunk(*_t(r, k, v, lw, u),
                       torch.from_numpy(s0) if with_state else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **WKV_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), **WKV_TOL)


@pytest.mark.parametrize("k", [16, 64])
def test_wkv6_plain_strong_decays_match_pallas_and_oracle(k):
    """lw = -exp(3) for every token and channel: a chunk of 16 sums to
    about -320, far past the -88 where exp of a chunk-wide reference point
    overflows fp32. The pairwise form keeps every exponent <= 0, so the
    plain version, the Pallas kernel and the token-by-token oracle stay
    finite and agree."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.wkv6 import wkv6_chunk as pallas
    r, kk, v, _, u = _wkv_inputs(7 * k, 2, 40, k)
    lw = np.full_like(r, -np.exp(3.0))
    want = np.asarray(pallas(*map(jnp.asarray, (r, kk, v, lw, u)),
                             chunk=16, interpret=True))
    oracle = np.asarray(jref.wkv6_ref(*map(jnp.asarray,
                                           (r, kk, v, lw, u))))
    y, st = wkv6_chunk(*(t[:, :, None] for t in _t(r, kk, v, lw)),
                       torch.from_numpy(u))
    assert np.isfinite(want).all() and np.isfinite(oracle).all()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(y[:, :, 0].numpy(), want, **WKV_TOL)
    np.testing.assert_allclose(y[:, :, 0].numpy(), oracle, **WKV_TOL)


@pytest.mark.parametrize("case", ["fresh", "flat_heads", "offset"])
def test_wkv6_alignment_check(case):
    """The kernel copies rows with 16-byte cp.async: fresh tensors and the
    reference's flattened (BH, S, 1, K) view pass; a base 4 bytes past a
    boundary is refused."""
    if case == "fresh":
        check_aligned(r=torch.zeros(2, 40, 3, 64, dtype=torch.bfloat16),
                      lw=torch.zeros(2, 40, 3, 64))
    elif case == "flat_heads":
        check_aligned(r=torch.zeros(6, 40, 16)[:, :, None])
    else:
        with pytest.raises(ValueError, match="16-byte"):
            check_aligned(lw=torch.zeros(40 * 16 + 1)[1:].view(1, 40, 1, 16))


@pytest.mark.parametrize("heads,sms,want", [
    (160, 132, 2),   # RWKV-6-3B's prefill: B 4 x H 40 on an H100
    (132, 132, 1), (40, 132, 1), (1, 132, 1), (150, 132, 2)])
def test_wkv6_heads_per_block(heads, sms, want):
    """Two heads per thread block only when the heads outnumber the SMs:
    then two heads share an SM in one block; else each has a block (and
    an SM) of its own."""
    assert heads_per_block(heads, sms) == want


def test_wkv6_oracle_matches_reference():
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    args = _wkv_inputs(21, 2, 24, 16)
    want = np.asarray(jref.wkv6_ref(*map(jnp.asarray, args)))
    got = tref.wkv6_ref(*_t(*args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention_fwd(q, torch.zeros(1, 4, 2, 8),
                            torch.zeros(1, 4, 2, 8))
    r = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="u has shape"):
        wkv6_chunk(r, r, r, r, torch.zeros(3, 16))
    with pytest.raises(ValueError, match="chunk"):
        ops.wkv6(r[:, :, 0], r[:, :, 0], r[:, :, 0], r[:, :, 0],
                 torch.zeros(1, 1, 16), chunk=0)


def _misaligned(bad, device):
    """A (1, 16, 2, D) bf16 operand that TMA cannot read: D 36 (72-byte
    rows), a base 2 bytes past a boundary, or heads 136 bytes apart."""
    bf16 = dict(dtype=torch.bfloat16, device=device)
    if bad == "head_dim":
        return torch.zeros(1, 16, 2, 36, **bf16)
    if bad == "offset":
        return torch.zeros(16 * 2 * 64 + 1, **bf16)[1:].view(1, 16, 2, 64)
    return torch.zeros(1, 16, 2, 68, **bf16)[..., :64]


@pytest.mark.parametrize("bad", ["head_dim", "offset", "head_stride"])
def test_tma_operand_check_refuses(bad):
    with pytest.raises(ValueError, match="TMA"):
        check_tma_operands(_misaligned(bad, "cpu"))


@pytest.mark.parametrize("case", ["model", "fused_qkv", "flat_heads",
                                  "d40", "one_row"])
def test_tma_operand_check_takes_what_the_models_pass(case):
    """The model's (B, S, H, D) projections, the fused-qkv slices, the
    reference's flattened (BH, S, 1, D) layout, D 40, and a single query
    row all pass the check the wgmma route makes."""
    bf16 = dict(dtype=torch.bfloat16)
    if case == "model":
        ts = [torch.zeros(2, 64, 32, 128, **bf16),
              torch.zeros(2, 64, 8, 128, **bf16)]
    elif case == "fused_qkv":
        qkv = torch.zeros(2, 130, 12, 64, **bf16)
        ts = [qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]]
    elif case == "flat_heads":
        ts = [torch.zeros(6, 96, 64, **bf16)[:, :, None]]
    elif case == "d40":
        ts = [torch.zeros(2, 401, 4, 40, **bf16)]
    else:
        ts = [torch.zeros(1, 1, 1, 40, **bf16)]
    check_tma_operands(*ts)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,B,sq,sk,H,KH,D", [
    (True, 2, 256, 256, 4, 2, 128),   # GQA, whole tiles
    (True, 1, 200, 200, 3, 1, 64),    # ragged S, D 64
    (False, 2, 100, 173, 2, 2, 128),  # Sq != Sk, ragged
    (False, 1, 1, 65, 1, 1, 40),      # one query row, D below a tile
    # bf16's wgmma route takes tiles of 128 query rows and 128 keys: ragged
    # edges and the causal diagonal inside those tiles
    (True, 1, 200, 200, 4, 1, 128),         # ragged S, G 4
    (False, 2, 200, 384 + 17, 8, 2, 64),    # Sq != Sk, both ragged, G 4
    (True, 2, 384 + 17, 384 + 17, 4, 4, 40),  # D 40: zero-filled columns
    (True, 1, 100, 384 + 17, 4, 1, 128),    # causal, Sq < Sk
    (True, 1, 384 + 17, 130, 2, 1, 64),     # causal, Sq > Sk
    (True, 2, 512, 512, 8, 2, 128),         # the 2-stage ring turns twice
    # Zamba2's head dim 80: the second 64-column panel zero-filled past 80
    (True, 2, 256, 256, 4, 4, 80),          # G 1, whole tiles
    (True, 1, 200, 200, 4, 2, 80),          # G 2, ragged S
    # Whisper-small: the encoder's 1,500 frames (ragged to the 128-row q
    # and 64-key tiles) and the decoder's cross-attention over them
    (False, 1, 1500, 1500, 12, 12, 64),
    (False, 1, 4096, 1500, 12, 12, 64),
])
def test_flash_kernel_matches_plain_on_card(causal, B, sq, sk, H, KH, D,
                                            dtype):
    _card()
    dt = getattr(torch, dtype)
    q = torch.from_numpy(_normal(0, B, sq, H, D)).cuda().to(dt)
    k = torch.from_numpy(_normal(1, B, sk, KH, D)).cuda().to(dt)
    v = torch.from_numpy(_normal(2, B, sk, KH, D)).cuda().to(dt)
    before = build.launch_counts["flash_attention_fwd"]
    out = flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert build.launch_counts["flash_attention_fwd"] == before + 1
    want = flash_attention_plain(q, k, v, causal)
    assert out.dtype == dt and out.shape == want.shape
    tol = FLASH_TOL if dt == torch.float32 else BF16_TOL
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_reads_strided_operands_on_card(dtype):
    """q, k, v as column slices of one fused projection (strides, no
    copy) give the result of their contiguous copies, on both routes."""
    _card()
    B, S, H, D = 2, 130, 4, 64
    qkv = torch.from_numpy(_normal(3, B, S, 3 * H, D)).cuda().to(
        getattr(torch, dtype))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
    out = flash_attention_fwd(q, k, v, True)
    want = flash_attention_fwd(q.contiguous(), k.contiguous(),
                               v.contiguous(), True)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", ["head_dim", "offset", "head_stride"])
def test_flash_wgmma_refuses_misaligned_operands_on_card(bad):
    """TMA needs 16-byte aligned bases and strides: the bf16 route raises
    rather than copy, before anything is launched."""
    _card()
    ok = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16, device="cuda")
    q = _misaligned(bad, "cuda")
    before = build.launch_counts["flash_attention_fwd"]
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_fwd(q, ok[..., :q.shape[-1]].contiguous(),
                            ok[..., :q.shape[-1]].contiguous())
    assert build.launch_counts["flash_attention_fwd"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,with_state", [
    (2, 64, 3, 64, False), (1, 37, 2, 32, True), (3, 17, 2, 16, False),
    (1, 1, 1, 64, True)])
def test_wkv6_kernel_matches_plain_on_card(B, S, H, K, with_state, dtype):
    _card()
    dt = getattr(torch, dtype)
    r, k, v = (torch.from_numpy(_normal(i, B, S, H, K, scale=0.5)).cuda()
               .to(dt) for i in range(3))
    lw = -torch.from_numpy(_normal(3, B, S, H, K)).cuda().exp()
    u = torch.from_numpy(_normal(4, H, K, scale=0.5)).cuda().to(dt)
    s0 = (torch.from_numpy(_normal(5, B, H, K, K)).cuda() if with_state
          else None)
    before = build.launch_counts["wkv6_chunk"]
    y, st = wkv6_chunk(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert build.launch_counts["wkv6_chunk"] == before + 1
    y_p, st_p = wkv6_chunk_plain(r, k, v, lw, u, s0)
    assert y.dtype == dt and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(),
                               **(WKV_TOL if dt == torch.float32
                                  else BF16_TOL))
    torch.testing.assert_close(st, st_p, **WKV_TOL)


def _wkv_card(B, S, H, K, dtype, with_state, strong=False, seed=0,
              batch_u=False):
    dt = getattr(torch, dtype)
    r, k, v = (torch.from_numpy(_normal(seed + i, B, S, H, K, scale=0.5))
               .cuda().to(dt) for i in range(3))
    lw = (torch.full((B, S, H, K), -float(np.exp(3.0)), device="cuda")
          if strong else
          -torch.from_numpy(_normal(seed + 3, B, S, H, K)).cuda().exp())
    u = torch.from_numpy(_normal(seed + 4, *((B,) if batch_u else ()), H, K,
                                 scale=0.5)).cuda().to(dt)
    s0 = (torch.from_numpy(_normal(seed + 5, B, H, K, K)).cuda()
          if with_state else None)
    before = build.launch_counts["wkv6_chunk"]
    y, st = wkv6_chunk(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert build.launch_counts["wkv6_chunk"] == before + 1
    y_p, st_p = wkv6_chunk_plain(r, k, v, lw, u, s0)
    assert y.dtype == dt and st.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y.float(), y_p.float(),
                               **(WKV_TOL if dt == torch.float32
                                  else BF16_TOL))
    torch.testing.assert_close(st, st_p, **WKV_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 1007])
@pytest.mark.parametrize("K", [16, 32, 64])
def test_wkv6_kernel_head_sizes_and_lengths_on_card(K, S, dtype,
                                                    with_state):
    """Every head size, one token, a chunk less one, one chunk, a chunk
    and one, and a ragged 1,007 (62 chunks and 15 tokens: the ring and the
    producer/consumer hand-over turn many times)."""
    _card()
    _wkv_card(2, S, 3, K, dtype, with_state)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [16, 64])
def test_wkv6_kernel_strong_decays_on_card(K, dtype):
    """lw = -exp(3) per token: a chunk's decays sum to about -320, where a
    factored exp(c_ref - c_j) would overflow; the kernel keeps the
    pairwise form and stays finite and right."""
    _card()
    _wkv_card(2, 75, 3, K, dtype, True, strong=True)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,K", [(3, 50, 64), (7, 19, 16)])
def test_wkv6_kernel_more_heads_than_sms_on_card(B, H, K):
    """More heads than the H100's 132 SMs, so two heads per thread block:
    150 heads, and an odd 133, whose last block's spare half must write
    nothing; from a per-batch u (the reference's flattened layout) and a
    given state."""
    _card()
    _wkv_card(B, 40, H, K, "bfloat16", True, seed=9, batch_u=True)


@pytest.mark.gpu
def test_ops_launch_the_lm_kernels_on_card():
    _card()
    q, k, v = (t.cuda() for t in _t(*_qkv(0, 4, 96, 96, 64)))
    r, kk, vv, lw, u = (t.cuda() for t in _t(*_wkv_inputs(0, 4, 40, 64)))
    build.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    y = ops.wkv6(r, kk, vv, lw, u)
    torch.cuda.synchronize()
    assert {n: c for n, c in build.launch_counts.items() if c} == {
        "flash_attention_fwd": 1, "wkv6_chunk": 1}
    torch.testing.assert_close(out, tref.attention_ref(q, k, v, True),
                               **FLASH_TOL)
    torch.testing.assert_close(y, tref.wkv6_ref(r, kk, vv, lw, u), **WKV_TOL)

"""Whisper-small [arXiv:2212.04356; unverified] — encoder-decoder, the
conv frontend a stub (copy of ``repro.configs.whisper_small``).

The encoder consumes precomputed frame embeddings (B, 1500, 768) from
``models.registry.input_specs``.
"""
from repro_torch.configs.base import ArchConfig, EncDecSpec

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,       # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    encdec=EncDecSpec(enc_layers=12, enc_len=1_500),
    act="gelu",
    rope_theta=10_000.0,  # unused: whisper uses sinusoidal positions
    technique_applicability=(
        "Enc-dec: encoder frames are host-produced features streamed to "
        "device (DC pattern); decode cells exercise self+cross KV caches."
    ),
    source="arXiv:2212.04356; unverified",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="whisper-small-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, max_seq_len=256,
        encdec=EncDecSpec(enc_layers=2, enc_len=32),
    )

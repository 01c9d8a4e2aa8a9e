"""Llama-3-8B [arXiv:2407.21783; unverified] — dense, GQA kv=8, 128k vocab
(copy of ``repro.configs.llama3_8b``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    act="silu",
    rope_theta=500_000.0,
    source="arXiv:2407.21783; unverified",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="llama3-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=256, max_seq_len=256,
    )

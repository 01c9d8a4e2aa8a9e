"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, WSD schedule
(copy of ``repro.configs.minicpm_2b``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,  # GQA kv=36 == MHA
    d_ff=5760,
    vocab_size=122_753,
    act="silu",
    tie_embeddings=True,  # MiniCPM ties embeddings
    lr_schedule="wsd",
    rope_theta=10_000.0,
    technique_applicability=(
        "HitGNN feature-cache/host-fetch maps to the 122k-row vocab embedding "
        "table (device-sharded Xi analogue); graph sampling/partitioning is "
        "inapplicable to dense token streams."
    ),
    source="arXiv:2404.06395; hf",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="minicpm-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=160, vocab_size=256, max_seq_len=256,
    )

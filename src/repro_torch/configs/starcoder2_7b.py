"""StarCoder2-7B [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE
(copy of ``repro.configs.starcoder2_7b``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49_152,
    act="gelu",  # starcoder2 uses a non-gated gelu MLP
    rope_theta=1_000_000.0,
    technique_applicability=(
        "Sync-SGD substrate + scheduler apply; graph feature cache maps to "
        "the vocab embedding; sampling inapplicable."
    ),
    source="arXiv:2402.19173; hf",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="starcoder2-7b-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=256, vocab_size=256, max_seq_len=256,
    )

"""Yi-9B [arXiv:2403.04652; hf] — llama-arch, GQA kv=4
(copy of ``repro.configs.yi_9b``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
    act="silu",
    rope_theta=10_000.0,
    technique_applicability=(
        "Sync-SGD substrate + scheduler apply; embedding table as feature "
        "cache analogue; sampling inapplicable."
    ),
    source="arXiv:2403.04652; hf",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab_size=256, max_seq_len=256,
    )

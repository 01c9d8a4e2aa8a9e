"""Zamba2-2.7B [arXiv:2411.15242; hf] — a Mamba2 backbone with a shared
attention block (copy of ``repro.configs.zamba2_2p7b``)."""
from repro_torch.configs.base import ArchConfig, HybridSpec

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,  # ffn of the shared attention block
    vocab_size=32_000,
    hybrid=HybridSpec(ssm_state=64, ssm_headdim=64, ssm_expand=2,
                      shared_attn_period=6),
    act="gelu",
    subquadratic=True,  # Mamba2 backbone => long_500k runs
    grad_accum=8,
    technique_applicability=(
        "Sync-SGD substrate + scheduler apply; SSM state streaming mirrors "
        "the paper's pipelined load/compute aggregation (Eq. 6)."
    ),
    source="arXiv:2411.15242; hf",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="zamba2-2.7b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, max_seq_len=256,
        hybrid=HybridSpec(ssm_state=16, ssm_headdim=16, ssm_expand=2,
                          ssm_chunk=32, shared_attn_period=2),
    )

"""OLMoE-1B-7B [arXiv:2409.02060; hf] — MoE, 64 experts top-8 (copy of
``repro.configs.olmoe_1b_7b``)."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert ffn width
    vocab_size=50_304,
    moe=MoESpec(num_experts=64, top_k=8),
    act="silu",
    grad_accum=4,
    rope_theta=10_000.0,
    technique_applicability=(
        "MoE token->expert dispatch IS a bipartite-graph aggregate: the "
        "two-stage scheduler's imbalance problem recurs as expert-capacity "
        "balancing; HitGNN's workload-balancing insight applies directly "
        "(see nn/moe.py)."
    ),
    source="arXiv:2409.02060; hf",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="olmoe-1b-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab_size=256, max_seq_len=256,
        moe=MoESpec(num_experts=8, top_k=2),
    )

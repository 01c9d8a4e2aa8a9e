"""Grok-1 314B [hf:xai-org/grok-1; unverified] — MoE, 8 experts top-2
(copy of ``repro.configs.grok_1_314b``)."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,  # per-expert ffn width
    vocab_size=131_072,
    moe=MoESpec(num_experts=8, top_k=2),
    act="silu",
    rope_theta=10_000.0,
    adam_dtype="bfloat16",
    grad_accum=8,  # 314B params: fp32 moments would not fit one pod
    technique_applicability=(
        "Expert dispatch as bipartite aggregate (see olmoe); with E=8 < "
        "model-axis=16 the experts are TP-sharded within the model axis "
        "(expert ffn dim sharded), mirroring P3's feature-dim partitioning."
    ),
    source="hf:xai-org/grok-1; unverified",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="grok-1-314b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, max_seq_len=256,
        moe=MoESpec(num_experts=4, top_k=2), adam_dtype="float32",
    )

"""LLaVA-NeXT-34B backbone [hf:llava-hf; unverified] — VLM, anyres tiling stub.

Only the transformer BACKBONE is modeled; the vision tower + projector are a
stub: ``input_specs()`` provides precomputed patch embeddings (B, P, d_model)
concatenated ahead of the text tokens.

Copy of ``repro.configs.llava_next_34b``.
"""
from repro_torch.configs.base import ArchConfig, VLMSpec

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    vlm=VLMSpec(num_patches=2_880),
    act="silu",
    grad_accum=8,
    rope_theta=5_000_000.0,
    technique_applicability=(
        "Patch-embedding prefix is a precomputed feature matrix fetched from "
        "host per request — literally the paper's host-fetch DC pattern for "
        "features that cannot live in device HBM."
    ),
    source="hf:llava-hf/llava-v1.6; unverified",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="llava-next-34b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab_size=256, max_seq_len=256,
        vlm=VLMSpec(num_patches=16),
    )

"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay (copy of ``repro.configs.rwkv6_3b``)."""
from repro_torch.configs.base import ArchConfig, RWKVSpec

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # d_model / head_size(64)
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    rwkv=RWKVSpec(head_size=64, decay_lora=64),
    act="relu_sq",       # rwkv channel-mix uses squared relu
    subquadratic=True,   # recurrent => long_500k runs (O(1) state)
    source="arXiv:2404.05892; hf",
)


def smoke() -> ArchConfig:
    return CONFIG.replace(
        name="rwkv6-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=256, max_seq_len=256,
        rwkv=RWKVSpec(head_size=16, decay_lora=8, chunk=32),
    )

"""Config dataclasses for the LM zoo's architectures and shapes (copy of
``repro.configs.base``, which is pure dataclasses; the port keeps its own
copy so that it imports nothing of the reference).

Every architecture gets one ``configs/<id>.py`` exporting ``CONFIG`` (the
published config) and ``smoke()`` (a reduced same-family config for CPU
tests). The port carries ``MoESpec``, ``HybridSpec``, ``RWKVSpec``,
``EncDecSpec`` and ``VLMSpec``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, ShapeSpec] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # d_ff of each expert (ArchConfig.d_ff is reused when 0)
    expert_d_ff: int = 0


@dataclass(frozen=True)
class HybridSpec:
    """Zamba2-style: a Mamba2 backbone with one weight-shared attention
    block called every ``shared_attn_period`` backbone layers."""

    ssm_state: int = 64
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    shared_attn_period: int = 6


@dataclass(frozen=True)
class RWKVSpec:
    head_size: int = 64
    decay_lora: int = 64  # rank of the data-dependent decay LoRA
    chunk: int = 256      # chunked-recurrence length; timemix takes 16


@dataclass(frozen=True)
class EncDecSpec:
    """Whisper-style encoder/decoder split. The conv/audio frontend is a STUB:
    the encoder consumes precomputed frame embeddings (B, enc_len, d_model)."""

    enc_layers: int = 12
    enc_len: int = 1_500  # Whisper 30s @ 50 Hz after conv stride 2


@dataclass(frozen=True)
class VLMSpec:
    """LLaVA-NeXT-style VLM. Vision tower + projector are a STUB: the model
    consumes precomputed patch embeddings (B, num_patches, d_model) that are
    concatenated before the text tokens (anyres tiling => num_patches)."""

    num_patches: int = 2_880  # 5 tiles x 576 patches (anyres 672x672)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // n_heads
    moe: Optional[MoESpec] = None
    hybrid: Optional[HybridSpec] = None
    rwkv: Optional[RWKVSpec] = None
    encdec: Optional[EncDecSpec] = None
    vlm: Optional[VLMSpec] = None
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "silu"           # silu (gated) | gelu | relu_sq
    tie_embeddings: bool = False
    max_seq_len: int = 524_288
    lr_schedule: str = "cosine"
    subquadratic: bool = False
    adam_dtype: str = "float32"
    remat: str = "full"
    grad_accum: int = 1
    technique_applicability: str = ""
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts top_k experts."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm" and self.rwkv is not None:
            tm = 5 * d * d + 2 * d * self.rwkv.decay_lora * 6
            cm = d * f + f * d
            return emb + L * (tm + cm)
        attn = (d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                + (self.n_heads * hd) * d)
        if self.family == "moe" and self.moe is not None:
            ef = self.moe.expert_d_ff or f
            e = self.moe.top_k if active_only else self.moe.num_experts
            mlp = e * 3 * d * ef + d * self.moe.num_experts  # router
        else:
            mlp = (3 if self.act == "silu" else 2) * d * f
        if self.family == "hybrid" and self.hybrid is not None:
            h = self.hybrid
            d_in = h.ssm_expand * d
            ssm = (d * (2 * d_in + 2 * h.ssm_state + d_in // h.ssm_headdim)
                   + d_in * d + 4 * d_in)
            return emb + L * ssm + (attn + 3 * d * f)
        if self.family == "audio" and self.encdec is not None:
            enc = self.encdec.enc_layers * (attn + mlp)
            return emb + enc + L * (2 * attn + mlp)
        return emb + L * (attn + mlp)

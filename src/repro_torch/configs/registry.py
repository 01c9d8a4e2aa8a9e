"""Architecture registry (counterpart of ``repro.configs.registry``).

The port serves every architecture of the reference: the dense family
(``minicpm-2b``, ``starcoder2-7b``, ``yi-9b``, ``llama3-8b``), the MoE
family (``olmoe-1b-7b``, ``grok-1-314b``), the hybrid family
(``zamba2-2.7b``), the VLM backbone (``llava-next-34b``), the
encoder-decoder (``whisper-small``) and ``rwkv6-3b``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

# arch-id -> module under repro_torch.configs
_ARCH_MODULES: dict[str, str] = {
    "llama3-8b": "llama3_8b",
    "rwkv6-3b": "rwkv6_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "grok-1-314b": "grok_1_314b",
    "llava-next-34b": "llava_next_34b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-7b": "starcoder2_7b",
    "yi-9b": "yi_9b",
    "zamba2-2.7b": "zamba2_2p7b",
    "whisper-small": "whisper_small",
}

ARCH_IDS: tuple[str, ...] = (
    "minicpm-2b", "starcoder2-7b", "yi-9b", "llama3-8b", "olmoe-1b-7b",
    "grok-1-314b", "zamba2-2.7b", "llava-next-34b", "whisper-small",
    "rwkv6-3b")


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke()


"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

A copy of ``repro.configs``: one module per assigned architecture, each
exporting ``CONFIG`` (full size, the published widths) and
``smoke_config()`` (reduced same-family config runnable on CPU).
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCHS = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a66b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba15_large_398b",
    "minicpm3-4b": "minicpm3_4b",
    "llama3.2-1b": "llama32_1b",
    "stablelm-3b": "stablelm_3b",
    "gemma-7b": "gemma_7b",
    "whisper-small": "whisper_small",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; options: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def all_archs():
    return list(ARCHS)

"""Architecture configs (port of ``repro/configs``): every family of the
reference — the dense family, the VLM stub (internvl2), the audio
encoder-decoder (whisper), the MoE family (granite-moe, mixtral), jamba
(the hybrid mamba/attention/MoE family) and rwkv6 (the SSM family).

Each module exposes ``config()`` (the published configuration) and
``reduced()`` (a tiny same-family config for CPU tests), copied field for
field from the reference.
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict

from repro_torch.models.common import ModelConfig

_ARCH_MODULES = {
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
}

ARCHS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown architecture {arch!r}; the port has "
                       f"{list(ARCHS)} (see ROADMAP.md)")
    return import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}

"""Architecture configs (port of ``repro/configs``): the dense family,
rwkv6 (the SSM family), jamba (the hybrid mamba/attention/MoE family) and
the MoE family (granite-moe, mixtral).

Each module exposes ``config()`` (the published configuration) and
``reduced()`` (a tiny same-family config for CPU tests), copied field for
field from the reference.  The other families of the reference (VLM,
audio) are not ported yet: asking for one raises a
``KeyError`` that says where they stand.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.common import ModelConfig

_ARCH_MODULES = {
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
}
# the reference's other architectures, by family
_NOT_PORTED = {
    "internvl2-2b": "vlm",
    "whisper-tiny": "audio",
}

ARCHS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise KeyError(f"{arch} ({_NOT_PORTED[arch]} family) is not ported "
                       f"yet: the port runs {list(ARCHS)}; see ROADMAP.md "
                       f"queue A for the order of the other families")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown architecture {arch!r}; the port has "
                       f"{list(ARCHS)} (ROADMAP.md queue A)")
    return import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()

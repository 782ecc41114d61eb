"""Architecture registry: --arch <id> -> ModelConfig."""
from __future__ import annotations

from repro_torch.configs import (
    deepseek_v2_236b,
    deepseek_v2_lite_16b,
    gemma_2b,
    granite_20b,
    jamba_1_5_large_398b,
    minitron_4b,
    qwen2_vl_2b,
    rwkv6_3b,
    starcoder2_15b,
    whisper_small,
)
from repro_torch.models.config import ModelConfig, reduced

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        rwkv6_3b.CONFIG,
        starcoder2_15b.CONFIG,
        qwen2_vl_2b.CONFIG,
        deepseek_v2_236b.CONFIG,
        whisper_small.CONFIG,
        minitron_4b.CONFIG,
        granite_20b.CONFIG,
        deepseek_v2_lite_16b.CONFIG,
        jamba_1_5_large_398b.CONFIG,
        gemma_2b.CONFIG,
    ]
}


def get(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]


def smoke(name: str, **overrides) -> ModelConfig:
    return reduced(ARCHS[name], **overrides)

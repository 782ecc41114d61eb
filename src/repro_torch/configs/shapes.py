"""The four assigned input shapes and their input specs: the counterpart
of `repro/configs/shapes.py`.

A spec is a tensor on the "meta" device (the port's
`jax.ShapeDtypeStruct`): it has a shape and a dtype and allocates
nothing. Tokens and positions are int32, as in the reference (the
embedding and the loss index with them as they are).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# sliding window applied to *pure full-attention* archs for long_500k only;
# SSM/hybrid/MLA archs run their native sub-quadratic path.
LONG_CONTEXT_WINDOW = 8192


def needs_swa_for_long(cfg: ModelConfig) -> bool:
    return cfg.mla is None and cfg.block_pattern == ("attn",)


def config_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    if shape.name == "long_500k" and needs_swa_for_long(cfg):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def spec(shape, dtype) -> torch.Tensor:
    """A meta tensor: the shape and dtype of an input, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def token_batch_specs(cfg: ModelConfig, B: int, T: int) -> dict:
    """Specs for a full-sequence batch (train / prefill)."""
    specs = {"tokens": spec((B, T), torch.int32)}
    if cfg.vision_prefix:
        specs["vision_embeds"] = spec((B, cfg.vision_prefix, cfg.d_model),
                                      cfg.tdtype)
        specs["positions"] = spec((3, B, T + cfg.vision_prefix), torch.int32)
    if cfg.encoder_layers:
        specs["enc_embeds"] = spec((B, cfg.encoder_len, cfg.d_model),
                                   cfg.tdtype)
    return specs


def cache_specs(cfg: ModelConfig, B: int, max_len: int) -> dict:
    """The tree of `transformer.init_cache` on the meta device."""
    return transformer.init_cache(cfg, B, max_len, device=META)


def decode_specs(cfg: ModelConfig, B: int, seq_len: int) -> dict:
    return {
        "token": spec((B, 1), torch.int32),
        "cache": cache_specs(cfg, B, seq_len),
        "pos": spec((), torch.int32),
    }

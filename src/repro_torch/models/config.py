"""Model configuration for the architecture zoo: the port's own copy of
`repro/models/config.py`, so that a config reads the same in both
packages.

One dataclass covers every architecture family of the registry: dense
(GQA/MQA), MoE (incl. DeepSeek-V2 MLA), SSM (RWKV6), hybrid (Jamba
Mamba+attention interleave), enc-dec audio backbone (Whisper), and VLM
language backbone (Qwen2-VL with M-RoPE). The port's transformer runs
the dense family so far (`models/transformer.py` raises for the others).

Differences from the JAX package's copy: `tdtype` (a torch dtype)
replaces `jdtype`, and `param_count` counts the port's own params.
`attention_impl` keeps the reference's values: "xla" names the plain
einsum path, "flash" the hand-written flash-attention kernel
(`kernels/flash_attn.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int  # routed experts
    top_k: int
    num_shared: int = 0  # shared (always-on) experts
    d_ff_expert: int = 0  # per-expert hidden size
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # combine-scatter accumulation dtype: f32 (default) or bfloat16 — a
    # token sums at most top_k + shared expert outputs, so bf16 combine is
    # benign and halves the dominant dispatch-stream HBM traffic (§Perf).
    combine_dtype: str = "float32"
    # apply MoE every `every` layers within a block pattern (hybrid use)
    # — for pure-MoE models all layers are MoE.


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 => dense q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM (used by the Jamba hybrid)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model/16)
    # steps executed inside one scan iteration (unrolled): the (B, d_inner,
    # d_state) carry round-trips HBM once per scan ITERATION, so unrolling
    # divides state traffic by this factor (§Perf memory-term optimization).
    scan_unroll: int = 1
    # dtype for the (T, B, d_inner) x_c/dt streams fed to the selective
    # scan; recurrence math stays f32 in-body. bfloat16 halves the dominant
    # residual HBM traffic after unrolling (§Perf memory-term optimization).
    stream_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 (Finch) data-dependent-decay linear attention."""

    head_dim: int = 64
    decay_lora: int = 64  # LoRA rank for the data-dependent decay
    chunk_len: int = 16  # chunked-scan block length (see rwkv6.py numerics)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    # block pattern: one entry per layer-position inside a repeating group.
    # ("attn",) => plain transformer; Jamba uses 1 attn : 7 mamba.
    block_pattern: Tuple[str, ...] = ("attn",)
    # which positions inside the pattern use MoE for their FFN ("all", "odd",
    # "none") — Jamba puts MoE on every other layer.
    moe_pattern: str = "none"
    mlp: str = "swiglu"  # swiglu | geglu | gelu | relu_sq
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    rope_style: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # of head_dim/2
    sliding_window: int = 0  # 0 => full attention
    q_chunk: int = 0  # >0: query-blocked attention (memory-term opt, §Perf)
    # >0: compute the unembed+cross-entropy over T in chunks of this many
    # tokens, so the (B, T, V) logits tensor is never materialized
    # (memory-term opt for 150k-256k vocabularies, §Perf).
    loss_chunk: int = 0
    # apply in-model activation sharding constraints (batch stays on the
    # data axes through attention) — collective-term opt, §Perf.
    act_constrain: bool = False
    # attention backend: "xla" (the plain einsum path) or "flash" (the
    # hand-written CUDA flash-attention kernel on the card, its plain
    # version on the CPU). Train/prefill full-sequence path only.
    attention_impl: str = "xla"
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # enc-dec (whisper): number of encoder layers; frontend is a stub that
    # consumes precomputed frame embeddings.
    encoder_layers: int = 0
    encoder_len: int = 1500
    # vlm: number of stub patch-embedding positions prepended to the text.
    vision_prefix: int = 0
    dtype: str = "bfloat16"
    # citation for the assigned config
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def num_pattern_groups(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}"
        )
        return self.num_layers // len(self.block_pattern)

    def layer_kinds(self) -> Tuple[Tuple[str, bool], ...]:
        """(kind, is_moe) per position within one repeating group."""
        out = []
        for i, kind in enumerate(self.block_pattern):
            if self.moe is None or self.moe_pattern == "none":
                is_moe = False
            elif self.moe_pattern == "all":
                is_moe = True
            elif self.moe_pattern == "odd":
                is_moe = i % 2 == 1
            else:
                raise ValueError(self.moe_pattern)
            out.append((kind, is_moe))
        return tuple(out)

    def param_count(self) -> int:
        """Total parameter count (analytic; matches init_params)."""
        from repro_torch.models import transformer  # lazy, avoids cycle

        return transformer.count_params(self)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 groups,
    d_model<=512, <=4 experts)."""
    pattern = cfg.block_pattern
    small = dict(
        num_layers=2 * len(pattern),
        d_model=256,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads > 1 else 1,
        d_ff=512,
        head_dim=64 if cfg.head_dim else 0,
        vocab_size=512,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_len=32 if cfg.encoder_layers else cfg.encoder_len,
        vision_prefix=8 if cfg.vision_prefix else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1),
            d_ff_expert=128,
        )
    if cfg.mla is not None:
        small["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=64, q_lora_rank=0, rope_head_dim=32,
            nope_head_dim=32, v_head_dim=32,
        )
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=8)
    if cfg.rwkv is not None:
        small["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=32, decay_lora=16, chunk_len=8)
        small["num_heads"] = small["d_model"] // 32
        small["num_kv_heads"] = small["num_heads"]
    if cfg.rope_style == "mrope":
        small["mrope_sections"] = (8, 12, 12)  # of reduced head_dim/2 = 32
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)

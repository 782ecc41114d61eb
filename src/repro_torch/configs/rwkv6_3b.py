"""rwkv6-3b — Finch, attention-free data-dependent-decay linear attention
[arXiv:2404.05892]."""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # d_model / rwkv head_dim (64)
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rope_style="none",
    tie_embeddings=False,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, chunk_len=16),
    source="arXiv:2404.05892 (RWKV-6 'Finch', 3B: 32L d2560)",
)

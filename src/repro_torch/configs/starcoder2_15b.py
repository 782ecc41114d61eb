"""starcoder2-15b — GQA (kv=4), RoPE, GPT-style LayerNorm+GeLU FFN
[arXiv:2402.19173]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp="gelu",
    norm="layernorm",
    rope_theta=100000.0,
    tie_embeddings=False,
    source="arXiv:2402.19173 (StarCoder2-15B: 40L d6144 48H kv4)",
)

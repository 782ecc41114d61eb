"""minitron-4b — pruned Nemotron: GQA kv=8, squared-ReLU FFN, LayerNorm
[arXiv:2407.14679]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    mlp="relu_sq",
    norm="layernorm",
    tie_embeddings=False,
    source="arXiv:2407.14679 (Minitron-4B: 32L d3072 24H kv8, pruned Nemotron)",
)

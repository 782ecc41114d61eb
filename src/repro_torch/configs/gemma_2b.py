"""gemma-2b — GeGLU, head_dim=256, MQA, tied 256k vocab [arXiv:2403.08295]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2403.08295 (Gemma-2B: 18L d2048 8H MQA hd256)",
)

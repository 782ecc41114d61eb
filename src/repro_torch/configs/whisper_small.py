"""whisper-small — enc-dec audio backbone; mel+conv frontend is a stub that
supplies precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,  # decoder layers; encoder_layers below
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    mlp="gelu",
    norm="layernorm",
    rope_style="none",  # sinusoidal additive positions
    tie_embeddings=True,
    encoder_layers=12,
    encoder_len=1500,
    source="arXiv:2212.04356 (Whisper small: 12+12L d768 12H)",
)

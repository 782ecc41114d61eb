"""qwen2-vl-2b — VLM language backbone with M-RoPE; the ViT vision encoder
is a stub that supplies precomputed patch embeddings [arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    rope_style="mrope",
    mrope_sections=(16, 24, 24),  # of head_dim/2 = 64
    rope_theta=1000000.0,
    tie_embeddings=True,
    vision_prefix=256,  # stub: 256 precomputed patch embeddings per sample
    source="arXiv:2409.12191 (Qwen2-VL-2B: 28L d1536 12H kv2, M-RoPE)",
)

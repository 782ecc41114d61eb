"""deepseek-v2-lite-16b — MLA (kv_lora=512, no q LoRA) + MoE 64 routed
top-6 with 2 shared experts [arXiv:2405.04434]."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe_pattern="all",
    tie_embeddings=False,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, d_ff_expert=1408),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    source="arXiv:2405.04434 (DeepSeek-V2-Lite: 27L d2048 16H, MLA 512, 64e top6)",
)
